"""The dense one-hot kernels' partitions ('pallas'; `ops/deform_attn_dense_cuda.py`,
`csrc/ms_deform_attn_dense.cu`), on the CPU.

* a numpy model of the forward's partition at the kernel's own block sizes
  (64-query tiles, 128 threads, two per query, 64-token chunks, warps of 16
  rows): each point's corner terms once, the counting sort by chunk (counts
  per (chunk, thread), an exclusive scan in (chunk, thread) order), the walk
  of the occupied chunks only, each row's one-hot cells summed in list order
  and zeroed after the product: every in-map corner in exactly one chunk's
  list, in (q, p, corner) order; the walked chunks the occupied ones; the
  cells zeroed the cells written; the output against JAX's
  `ms_deform_attn_pallas` (the TPU kernels, interpret mode) and
  `ms_deform_attn_xla`;
* a numpy model of the adjoint's d_value blocks (units of a level or a band
  of it, tiles of 1024 / P queries whose points the warps own in runs, the
  corners counted per (token, warp), ranked by an exclusive scan and, within
  a round of 32, by lane, each token's run summed in order): every run in
  (q, p, corner) order and the sums the same bits whatever order the warps
  and lane groups run in, the f32 sum of each token's corners in that order;
  held against `jax.grad` of `ms_deform_attn_xla` and JAX's Pallas adjoint
  in interpret mode;
* NaN points under C1; the shared-memory plans at the encoder, the decoder
  and the YOLO pyramid, never over the 232 448 B a block may opt into; the
  d_value units; what the wrappers refuse.

The kernels themselves run only on the card (chip_smoke.py phases 19, 20;
`poet_tpu_torch/tools/bench_dense.py`).
"""

import numpy as np
import pytest
import torch

from poet_tpu_torch.ops import deform_attn_dense_cuda as dense
from tests.test_torch_deform_attn_slab import _close, _corners, _footprint, _xla
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

FLAGSHIP = ((30, 40), (15, 20), (8, 10), (4, 5))
YOLO = ((60, 80), (30, 40), (15, 20), (8, 10))
BUDGET = 232448
F32 = np.float32
# JAX's own tolerances for its Pallas v1 kernel (tests/test_deform_attn_pallas.py)
FWD_ATOL, GRAD_ATOL = 2e-5, 1e-4

# (levels, B, Q, H, D, location spread, trailing pad tokens): Q = 130 spans
# three forward tiles, the last one partly; 600 three adjoint tiles (256
# queries at P = 4); a (60, 50) level at D = 8 two d_value bands of 1500
MODEL_CASES = {
    "three tiles D16": (((6, 9), (4, 5), (2, 3)), 1, 130, 2, 16, 1.0, 0),
    "adjoint tiles D8": (((6, 9), (4, 5), (2, 3)), 1, 600, 1, 8, 1.0, 0),
    "banded level D8": (((60, 50), (4, 5)), 1, 20, 1, 8, 1.0, 0),
    "D6 edge levels": (((1, 7), (3, 1), (1, 1)), 2, 5, 2, 6, 1.0, 0),
    "D12 pad tokens": (((5, 7), (3, 4)), 1, 7, 3, 12, 1.0, 5),
    "far out of map": (((6, 9), (4, 5)), 1, 9, 2, 8, 8.0, 0),
    "many chunks": (((20, 24), (10, 12)), 1, 40, 1, 8, 1.0, 0),
}


def _inputs(rng, name, nan=False):
    shapes, B, Q, H, D, spread, pad = MODEL_CASES[name]
    value = rng.normal(size=(B, sum(h * w for h, w in shapes) + pad, H, D)).astype(F32)
    L, P = len(shapes), 4
    locs = (0.5 + (rng.uniform(-0.2, 1.2, size=(B, Q, H, L, P, 2)) - 0.5) * spread).astype(F32)
    if Q >= 4:                                       # the dummy-query conventions
        locs[:, -1] = -10.0
        locs[:, -2] = -1.0
    w = rng.uniform(size=(B, Q, H, L * P)).astype(F32)
    w = (w / w.sum(-1, keepdims=True)).reshape(B, Q, H, L, P)
    if nan:
        locs[:, 0, :, 0, 1, 0] = np.nan
        locs[0, 1, 0, -1, 2, :] = np.nan
    dout = rng.normal(size=(B, Q, H * D)).astype(F32)
    return value, shapes, locs, w, dout


def _terms(lx, ly, h, w):
    """The kernel's corner_terms in float32: ('hit', (x0, y0, tx, ty)) when x0
    and y0 lie in [-1, size], 'miss', or 'nonfinite' (C1)."""
    x = F32(lx) * F32(w) - F32(0.5)
    y = F32(ly) * F32(h) - F32(0.5)
    if not (np.isfinite(x) and np.isfinite(y)):
        return "nonfinite", None
    x0, y0 = int(np.floor(x)), int(np.floor(y))
    if not (-1 <= x0 <= w and -1 <= y0 <= h):
        return "miss", None
    return "hit", (x0, y0, F32(x - np.floor(x)), F32(y - np.floor(y)))


def _corners_of(terms, a, h, w):
    """corner_of: (corner j, token within the level, weight a * bx * by in
    f32) of a HIT point's corners on real tokens, in j order."""
    x0, y0, tx, ty = terms
    out = []
    for j in range(4):
        x, y = x0 + (j & 1), y0 + (j >> 1)
        if 0 <= x < w and 0 <= y < h:
            bx = tx if j & 1 else F32(1) - tx
            by = ty if j >> 1 else F32(1) - ty
            out.append((j, y * w + x, F32(F32(a) * bx) * by))
    return out


def _starts(shapes):
    return np.cumsum([0] + [h * w for h, w in shapes])


# ------------------------------------------------------------ forward model

def dense_fwd_model(value, shapes, locs, attn):
    """The forward kernel's partition, block by block (b, h, query tile).
    Returns the output (B, Q, H * D), float64 products of the f32 one-hot
    rows, NaN rows by C1, and per block a record: the sorted list (row, col,
    weight, key=(q, k, corner), chunk), chunk starts, occupied and walked
    chunks, cells written and zeroed."""
    B, S, H, D = value.shape
    Q, L, P = locs.shape[1], locs.shape[3], locs.shape[4]
    LP, KC, QT, T = L * P, dense.KC, dense.QT, dense.FWD_THREADS
    PH = (LP + 1) // 2
    starts = _starts(shapes)
    S_lv = int(starts[-1])
    n_chunks = -(-S_lv // KC)
    vpad = np.zeros((n_chunks * KC, B, H, D), np.float64)
    vpad[:S_lv] = value[:, :S_lv].transpose(1, 0, 2, 3)
    out = np.zeros((B, Q, H, D))
    blocks = []
    for b, h, q0 in ((b, h, q0) for b in range(B) for h in range(H) for q0 in range(0, Q, QT)):
        cnt = np.zeros((n_chunks, T), np.int64)
        nan_row = np.zeros(QT, bool)
        mine = [[] for _ in range(T)]      # per thread, in (k, corner) order
        for t in range(T):
            r, q = t >> 1, q0 + (t >> 1)
            if q >= Q:
                continue
            for k in range((t & 1) * PH, min(LP, (t & 1) * PH + PH)):
                l, p = divmod(k, P)
                hl, wl = shapes[l]
                kind, terms = _terms(*locs[b, q, h, l, p], hl, wl)
                nan_row[r] |= kind == "nonfinite"
                if kind != "hit":
                    continue
                for j, tok, w in _corners_of(terms, attn[b, q, h, l, p], hl, wl):
                    g = int(starts[l]) + tok
                    cnt[g // KC, t] += 1
                    mine[t].append((g // KC, r, g % KC, w, (q, k, j)))
        flat = cnt.reshape(-1)                       # (chunk, thread) order
        ends = np.cumsum(flat).reshape(n_chunks, T)
        cursor = (ends - cnt).copy()                 # the exclusive scan
        cstart = np.append(cursor[:, 0], flat.sum())
        ent = [None] * int(flat.sum())
        for t in range(T):
            for c, r, col, w, key in mine[t]:
                ent[cursor[c, t]] = (r, col, w, key, c)
                cursor[c, t] += 1
        assert (cursor == ends).all()
        occ = [c for c in range(n_chunks) if cstart[c + 1] > cstart[c]]
        W = np.zeros((QT, KC), F32)
        acc = np.zeros((QT, D))
        walked, written = [], 0
        for c in occ:
            walked.append(c)
            cells = []
            for row in range(QT):                    # warp row // 16, lane row % 16
                beg = cstart[c] if row == 0 else cursor[c, 2 * row - 1]
                for e in range(beg, cursor[c, 2 * row + 1]):
                    r, col, w, _, _ = ent[e]
                    assert r == row
                    W[r, col] = F32(W[r, col] + w)
                    cells.append((r, col))
            written += len(set(cells))
            acc += W.astype(np.float64) @ vpad[c * KC:(c + 1) * KC, b, h]
            for r, col in cells:
                W[r, col] = 0
            assert not W.any()                       # the zeroed cells were all the written ones
        n = min(QT, Q - q0)
        acc[nan_row] = np.nan
        out[b, q0:q0 + n, h] = acc[:n]
        blocks.append(dict(b=b, h=h, q0=q0, ent=ent, cstart=cstart, occ=occ, walked=walked,
                           written=written, n_chunks=n_chunks))
    return out.reshape(B, Q, H * D), blocks


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_forward_lists_hold_each_in_map_corner_once_in_order(rng, case):
    value, shapes, locs, w, _ = _inputs(rng, case)
    _, blocks = dense_fwd_model(value, shapes, locs, w)
    Q, L, P = locs.shape[1], locs.shape[3], locs.shape[4]
    starts = _starts(shapes)
    for blk in blocks:
        b, h, q0 = blk["b"], blk["h"], blk["q0"]
        want = set()                                 # the header's footprint, independently
        for q in range(q0, min(Q, q0 + dense.QT)):
            for l, p in np.ndindex(L, P):
                f = _footprint(*locs[b, q, h, l, p], *shapes[l])
                for j, tok, _ in ([] if f is None else _corners(f, shapes[l][1], 1.0)):
                    want.add(((q, l * P + p, j), int(starts[l]) + tok))
        got = {(e[3], e[4] * dense.KC + e[1]) for e in blk["ent"]}
        assert got == want and len(blk["ent"]) == len(want)
        cs = blk["cstart"]
        for c in range(blk["n_chunks"]):
            seg = blk["ent"][cs[c]:cs[c + 1]]
            assert all(e[4] == c for e in seg)
            keys = [e[3] for e in seg]
            assert keys == sorted(keys)              # (q, p, corner) order


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_forward_walks_only_the_occupied_chunks_and_zeroes_what_it_wrote(rng, case):
    value, shapes, locs, w, _ = _inputs(rng, case)
    _, blocks = dense_fwd_model(value, shapes, locs, w)
    for blk in blocks:
        occupied = sorted({e[4] for e in blk["ent"]})
        assert blk["walked"] == blk["occ"] == occupied
        assert blk["written"] <= len(blk["ent"])


def test_forward_skips_the_chunks_no_corner_meets(rng):
    """Locations clustered as a model's: one query tile meets a few of the
    chunks, and only those are walked."""
    value, shapes, locs, w, _ = _inputs(rng, "many chunks")
    locs = (0.15 + 0.1 * (locs - locs.min()) / (locs.max() - locs.min())).astype(F32)
    out, blocks = dense_fwd_model(value, shapes, locs, w)
    n = blocks[0]["n_chunks"]
    assert n == 10 and all(0 < len(blk["walked"]) < n // 2 for blk in blocks)
    ref, _ = _xla(value, shapes, locs, w, np.zeros((1, locs.shape[1], value.shape[2]
                                                    * value.shape[3]), F32))
    _close(out, ref, "forward")


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_forward_sums_match_jax_xla(rng, case):
    value, shapes, locs, w, dout = _inputs(rng, case)
    out, _ = dense_fwd_model(value, shapes, locs, w)
    ref, _ = _xla(value, shapes, locs, w, dout)
    _close(out, ref, "forward")


@pytest.mark.parametrize("case", ["three tiles D16", "D6 edge levels"])
def test_forward_model_matches_pallas_v1_interpret(rng, case):
    """Against the TPU kernels themselves (levels as given, no pad tokens)."""
    from jax.experimental.pallas import tpu as pltpu

    import jax.numpy as jnp
    from poet_tpu.ops.deform_attn_pallas import ms_deform_attn_pallas

    value, shapes, locs, w, _ = _inputs(rng, case)
    out, _ = dense_fwd_model(value, shapes, locs, w)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ms_deform_attn_pallas(jnp.asarray(value), shapes, jnp.asarray(locs),
                                                jnp.asarray(w)))
    np.testing.assert_allclose(out, want, atol=FWD_ATOL)


# ------------------------------------------------------------ adjoint model

def dense_dvalue_model(shapes, locs, attn, dout, D, S, schedule=None):
    """The ordered d_value blocks in numpy, f32 arithmetic: per (b, h, unit,
    channel group) tiles of 1024 / P queries whose point slots warp w owns in
    runs [w R, (w + 1) R); the warp's corners, in (point, corner) order, 32 a
    round, counted per (token, warp); ranks from an exclusive scan in (token,
    warp) order and, within a round, the lane order; each token's run summed
    in order. `schedule` (a numpy Generator) runs the warps and the tokens in
    a random order. Returns d_value (B, S, H, D) (rows past the levels 0) and,
    per tile, whether every run listed its corners in (q, p, corner) order."""
    B, Q, H, L, P, _ = locs.shape
    DGP, qt, W8 = dense.group_width(D), max(1, dense.TILE_PTS // P), dense.BWD_WARPS
    R = dense.tile_slots(P) // W8
    starts = _starts(shapes)
    d_value = np.zeros((B, S, H, D), F32)
    dfull = dout.reshape(B, Q, H, D)
    ordered = []
    for b, h, unit, c0 in ((b, h, u, c0) for b in range(B) for h in range(H)
                           for u in dense.adjoint_units(shapes, D) for c0 in range(0, D, DGP)):
        l, t0, nt = unit
        hl, wl = shapes[l]
        acc = np.zeros((nt, DGP), F32)
        for q0 in range(0, Q, qt):
            dt = np.zeros((qt, DGP), F32)
            n = min(qt, Q - q0)
            dt[:n, :min(DGP, D - c0)] = dfull[b, q0:q0 + n, h, c0:c0 + DGP]
            corners = {}                                  # slot j -> [(corner, token, w)]
            for j in range(n * P):
                r, p = divmod(j, P)
                kind, terms = _terms(*locs[b, q0 + r, h, l, p], hl, wl)
                if kind == "hit":
                    corners[j] = [(c, tok - t0, wt) for c, tok, wt in
                                  _corners_of(terms, attn[b, q0 + r, h, l, p], hl, wl)
                                  if t0 <= tok < t0 + nt]
            entries = {w: [(j, c, tok, wt) for j in range(w * R, (w + 1) * R)
                           for c, tok, wt in corners.get(j, [])] for w in range(W8)}
            warps = list(range(W8))
            if schedule is not None:
                schedule.shuffle(warps)
            cnt = np.zeros((nt, W8), np.int64)
            for w in warps:
                for _, _, tok, _ in entries[w]:
                    cnt[tok, w] += 1
            offs = (np.cumsum(cnt.reshape(-1)) - cnt.reshape(-1)).reshape(nt, W8)
            tstart = np.append(offs[:, 0], cnt.sum())
            runs = [None] * int(cnt.sum())
            for w in warps:
                for u in range(0, 4 * R, 32):            # rounds: lanes rank equal tokens
                    rnd = [e for e in entries[w] if u <= 4 * (e[0] - w * R) + e[1] < u + 32]
                    seen = {}
                    for j, c, tok, wt in rnd:
                        runs[offs[tok, w] + seen.get(tok, 0)] = ((q0 + j // P, l * P + j % P,
                                                                  c), wt, j // P)
                        seen[tok] = seen.get(tok, 0) + 1
                    for tok, m in seen.items():
                        offs[tok, w] += m
            ordered.append(all([e[0] for e in runs[tstart[t]:tstart[t + 1]]]
                               == sorted(e[0] for e in runs[tstart[t]:tstart[t + 1]])
                               for t in range(nt)))
            tokens = list(range(nt))
            if schedule is not None:
                schedule.shuffle(tokens)
            for t in tokens:
                for _, wt, r in runs[tstart[t]:tstart[t + 1]]:
                    acc[t] = (acc[t] + wt * dt[r]).astype(F32)
        tok0 = int(starts[l]) + t0
        d_value[b, tok0:tok0 + nt, h, c0:c0 + DGP] = acc[:, :min(DGP, D - c0)]
    return d_value, ordered


def ordered_dvalue(shapes, locs, attn, dout, D, S):
    """Each token's corners sorted by (q, p, corner) and summed in f32 in
    that order, from a flat list of every corner."""
    B, Q, H, L, P, _ = locs.shape
    dfull = dout.reshape(B, Q, H, D)
    starts = _starts(shapes)
    d_value = np.zeros((B, S, H, D), F32)
    for b, h in np.ndindex(B, H):
        corners = []
        for q, l, p in np.ndindex(Q, L, P):
            kind, terms = _terms(*locs[b, q, h, l, p], *shapes[l])
            for j, tok, wt in ([] if kind != "hit" else
                               _corners_of(terms, attn[b, q, h, l, p], *shapes[l])):
                corners.append((int(starts[l]) + tok, (q, l * P + p, j), wt))
        for tok, key, wt in sorted(corners, key=lambda c: (c[0], c[1])):
            d_value[b, tok, h] = (d_value[b, tok, h] + wt * dfull[b, key[0], h]).astype(F32)
    return d_value


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_dvalue_sums_are_fixed_by_the_data_alone(rng, case):
    """Whatever order the warps count and place their corners in and the
    lane groups take their tokens in, every run lists its corners in (q, p,
    corner) order and the sums are the same bits: each token's f32 sum in
    that order."""
    value, shapes, locs, w, dout = _inputs(rng, case)
    S, D = value.shape[1], value.shape[3]
    want = ordered_dvalue(shapes, locs, w, dout, D, S)
    for seed in range(3):
        got, ordered = dense_dvalue_model(shapes, locs, w, dout, D, S,
                                          schedule=np.random.default_rng(seed))
        assert all(ordered)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", list(MODEL_CASES))
@pytest.mark.parametrize("nan", [False, True])
def test_dvalue_model_matches_jax_grad(rng, case, nan):
    """Against jax.grad of ms_deform_attn_xla (C1: a NaN point adds nothing),
    and the forward model's NaN rows."""
    value, shapes, locs, w, dout = _inputs(rng, case, nan)
    S, D = value.shape[1], value.shape[3]
    out, grads = _xla(value, shapes, locs, w, dout)
    _close(dense_dvalue_model(shapes, locs, w, dout, D, S)[0], grads[0], "d_value")
    got, _ = dense_fwd_model(value, shapes, locs, w)
    _close(got, out, "forward")


def test_dvalue_model_matches_pallas_v1_adjoint_interpret(rng):
    """Against the TPU adjoint kernel itself (interpret mode)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from poet_tpu.ops.deform_attn_pallas import ms_deform_attn_pallas

    value, shapes, locs, w, dout = _inputs(rng, "adjoint tiles D8")
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda v: ms_deform_attn_pallas(v, shapes, jnp.asarray(locs),
                                                         jnp.asarray(w)), jnp.asarray(value))
        want = np.asarray(vjp(jnp.asarray(dout))[0])
    got, _ = dense_dvalue_model(shapes, locs, w, dout, value.shape[3], value.shape[1])
    np.testing.assert_allclose(got, want, atol=GRAD_ATOL)


def test_nan_points_give_nan_rows_and_add_nothing(rng):
    value, shapes, locs, w, dout = _inputs(rng, "three tiles D16", nan=True)
    out, _ = dense_fwd_model(value, shapes, locs, w)
    B, Q, H, D = locs.shape[0], locs.shape[1], locs.shape[2], value.shape[3]
    rows = np.isnan(out.reshape(B, Q, H, D)).all(-1)
    assert rows.sum() == H + 1 and rows[:, 0].all() and rows[0, 1, 0]
    clean = np.where(np.isnan(locs), F32(-10.0), locs)
    S = value.shape[1]
    np.testing.assert_array_equal(dense_dvalue_model(shapes, locs, w, dout, D, S)[0],
                                  dense_dvalue_model(shapes, clean, w, dout, D, S)[0])


# ------------------------------------------------------------ plans

@pytest.mark.parametrize("shapes, dtype, fwd_bytes, chunks", [
    (FLAGSHIP, torch.bfloat16, 54992, 25), (FLAGSHIP, torch.float32, 61136, 25),
    (YOLO, torch.bfloat16, 74800, 100), (YOLO, torch.float32, 80944, 100)])
def test_forward_plan_at_the_path_shapes(shapes, dtype, fwd_bytes, chunks):
    """D=16, P=4 (the encoder and the decoder share the plan: it does not
    depend on Q)."""
    plan = dense.plan_dense_forward(shapes, 16, dtype, 4)
    assert plan == (chunks, 1, fwd_bytes) and plan.smem_bytes <= BUDGET


@pytest.mark.parametrize("shapes", [FLAGSHIP, YOLO])
def test_adjoint_plan_at_the_path_shapes(shapes):
    """The flagship's levels are whole units (the lane groups hold 1280
    tokens at D = 16: every point's corners computed once); the YOLO
    pyramid's (60, 80) level is cut into four bands of 1200 tokens, so its
    largest unit is the flagship's and so is its shared memory."""
    plan = dense.plan_dense_adjoint(shapes, 16, 4)
    if shapes == FLAGSHIP:
        assert plan.units == ((0, 0, 1200), (1, 0, 300), (2, 0, 80), (3, 0, 20))
    else:
        assert plan.units[:4] == tuple((0, t, 1200) for t in range(0, 4800, 1200))
    assert (plan.band_max, plan.tile_queries, plan.smem_bytes) == (1200, 256, 99440)
    assert plan.smem_bytes <= BUDGET
    assert dense.tile_slots(4) == 1024 and dense.tile_slots(3) == 1024


@pytest.mark.parametrize("D", [6, 8, 16, 24, 32, 64, 96])
@pytest.mark.parametrize("shapes", [FLAGSHIP, YOLO, ((1, 7), (3, 1), (1, 1))])
def test_units_cover_each_level_once_within_the_budget(D, shapes):
    per = dense.BWD_THREADS // (dense.group_width(D) // 4) * dense.TPG
    units = dense.adjoint_units(shapes, D)
    for l, (h, w) in enumerate(shapes):
        mine = [(t0, n) for ll, t0, n in units if ll == l]
        assert [t0 for t0, _ in mine] == list(np.cumsum([0] + [n for _, n in mine])[:-1])
        assert sum(n for _, n in mine) == h * w
        assert len(mine) == -(-h * w // per)                  # the fewest bands
    assert max(n for _, _, n in units) <= per and len(units) <= dense.MAX_UNITS
    for dtype in (torch.bfloat16, torch.float32):
        assert dense.plan_dense_forward(shapes, D, dtype, 4).smem_bytes <= BUDGET
    assert dense.plan_dense_adjoint(shapes, D, 4).smem_bytes <= BUDGET


@pytest.mark.parametrize("D, width", [(6, 8), (8, 8), (12, 16), (16, 16), (24, 32),
                                      (64, 64), (96, 64)])
def test_group_width(D, width):
    assert dense.group_width(D) == width


# ------------------------------------------------------------ wrappers

@pytest.mark.parametrize("kernel", ["MS_DEFORM_ATTN_DENSE_FWD", "MS_DEFORM_ATTN_DENSE_BWD"])
def test_wrappers_raise_on_cpu_tensors(rng, kernel):
    value, shapes, locs, w, dout = _inputs(rng, "D6 edge levels")
    args = [torch.from_numpy(x) for x in (value, locs, w)]
    if kernel.endswith("BWD"):
        args.append(torch.from_numpy(dout))
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(dense, kernel)(args[0], shapes, *args[1:])
    assert dense.DENSE_LIB._lib is None


@pytest.mark.parametrize("part", ["d_attn", "bogus", ""])
def test_adjoint_refuses_unknown_parts(rng, part):
    """Checked before the device."""
    value, shapes, locs, w, dout = _inputs(rng, "D6 edge levels")
    args = [torch.from_numpy(x) for x in (value, locs, w, dout)]
    with pytest.raises(ValueError, match="part"):
        dense.MS_DEFORM_ATTN_DENSE_BWD(args[0], shapes, *args[1:], part=part)
    assert dense.DENSE_LIB._lib is None
