"""The port's separable (v2) deformable-attention forward against the JAX
package's `ms_deform_attn_pallas_v2` (the TPU kernel in interpret mode), on
the CPU.

* `ms_deform_attn_v2` on CPU tensors (the plain version) against the Pallas
  kernel at JAX's own tolerance (2e-5, `tests/test_deform_attn_pallas_v2.py`):
  JAX's two cases, edge levels, points on and beyond the -1 / W borders,
  dummy queries at -10, and a bf16 value (one bf16 rounding apart);
* a numpy model of the CUDA kernel (`plan_v2`'s cluster plan: each band's
  padded rows landed by TMA boxes, their zero border by the out-of-bounds
  fill, at 128-byte row pitches, or copied by the CTA's threads where TMA
  cannot describe the value, as for a head of D=6; each corner row added in
  its band, every query by one CTA's threads) against the same Pallas
  kernel, at budgets that force many bands;
* the cluster plan over hypothesis pyramids, dtypes and budgets: every
  padded row of every band staged exactly once per cluster, the CTAs' box
  shares covering the band, every query in exactly one CTA, every box within
  TMA's limits; the band planner; the plan at the path shapes;
* what the plan, the entry and the kernel's wrapper refuse.

The kernel itself runs only on the card (chip_smoke.py phase 21).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from tests.test_deform_attn import _make_inputs
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

V2_ATOL = 2e-5                     # JAX's own, tests/test_deform_attn_pallas_v2.py:29
# bf16: both sides round an f32 sum of the same bf16 values to bf16 once; the
# sums differ in the last f32 bits, so a result can land one bf16 ulp apart
BF16_ULP_RTOL = 2.0 ** -7
FLAGSHIP = ((30, 40), (15, 20), (8, 10), (4, 5))
YOLO = ((60, 80), (30, 40), (15, 20), (8, 10))


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _jax_v2(value, shapes, locs, w, dtype=jnp.float32):
    from poet_tpu.ops.deform_attn_pallas_v2 import ms_deform_attn_pallas_v2

    return np.asarray(ms_deform_attn_pallas_v2(jnp.asarray(value, dtype), shapes,
                                               jnp.asarray(locs), jnp.asarray(w))
                      .astype(jnp.float32))


def _border_locs(rng, B, Q, H, shapes, P=4):
    """Locations whose pixel coordinate sits on the -1 / W borders and
    beyond: bases -2, -1, W - 1, W, W + 1 and fractions of a cell around
    them, in x and y independently."""
    L = len(shapes)
    px = np.array([-2.0, -1.5, -1.0, -0.75, -0.5, 0.0, 0.25])
    locs = np.empty((B, Q, H, L, P, 2), np.float32)
    for l, (h, w) in enumerate(shapes):
        for c, n in ((0, w), (1, h)):
            pix = np.concatenate([px, n - 1 + np.array([0.0, 0.5, 0.75]),
                                  n + np.array([-0.25, 0.0, 0.5, 1.0])])
            pick = rng.choice(pix, size=(B, Q, H, P))
            locs[:, :, :, l, :, c] = (pick + 0.5) / n
    return locs


def _case(rng, name):
    if name == "jax_q6":
        return _make_inputs(rng, B=2, Q=6, H=4, D=8)
    if name == "jax_q300_three_tiles":
        return _make_inputs(rng, B=1, Q=300, H=2, D=8)
    if name == "edge_levels":
        return _make_inputs(rng, B=2, Q=5, H=2, D=8, shapes=((1, 7), (3, 1), (1, 1)))
    if name == "borders":
        value, shapes, _, w = _make_inputs(rng, B=2, Q=40, H=2, D=8,
                                           shapes=((5, 7), (3, 4), (1, 1)))
        return value, shapes, _border_locs(rng, 2, 40, 2, shapes), w
    if name == "narrow_head":         # D=6: rows TMA cannot land, staged by threads
        return _make_inputs(rng, B=2, Q=9, H=3, D=6, shapes=((5, 7), (3, 4)))
    if name == "dummy_queries":
        value, shapes, locs, w = _make_inputs(rng, B=2, Q=8, H=3, D=8)
        locs[:, -3:] = -10.0          # the pad-query fill
        locs[:, -4] = -1.0            # the boxes-at--1 convention
        return value, shapes, locs, w
    raise KeyError(name)


CASES = ("jax_q6", "jax_q300_three_tiles", "edge_levels", "borders", "dummy_queries")


@pytest.mark.parametrize("case", CASES)
def test_v2_entry_matches_pallas_v2_interpret(rng, case):
    from poet_tpu_torch.ops import deform_attn_v2_cuda as v2

    value, shapes, locs, w = _case(rng, case)
    want = _jax_v2(value, shapes, locs, w)
    before = v2.MS_DEFORM_ATTN_V2.launches
    got = v2.ms_deform_attn_v2(*(torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                                 for x in (value, shapes, locs, w)))
    np.testing.assert_allclose(got.numpy(), want, atol=V2_ATOL)
    # the CPU path runs the plain version: no kernel built or launched
    assert v2.MS_DEFORM_ATTN_V2.launches == before
    assert v2.V2_LIB._lib is None


def test_v2_entry_bf16_value(rng):
    from poet_tpu_torch.ops.deform_attn_v2_cuda import ms_deform_attn_v2

    value, shapes, locs, w = _make_inputs(rng, B=2, Q=12, H=4, D=8)
    v16 = torch.from_numpy(value).bfloat16()
    want = _jax_v2(v16.float().numpy(), shapes, locs, w, dtype=jnp.bfloat16)
    got = ms_deform_attn_v2(v16, shapes, torch.from_numpy(locs), torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=V2_ATOL, rtol=BF16_ULP_RTOL)


def _staged_row(value, shapes, b, h, l, y):
    """Padded row y + 1 of the level as it lands. By TMA: a box of (D, 1,
    W_l + 2, 1, 1) at (0, h, -1, y, b) over the level's view (D, H, W_l,
    H_l, B), zeros where TMA fills out of bounds (the two border cells; the
    rows y = -1 and y = H_l). By the threads (a cell of D values rounded up to
    16 bytes): the same values, zeros in the border and past D."""
    from poet_tpu_torch.ops.deform_attn_v2_cuda import cell_bytes

    h_l, w_l = shapes[l]
    D = value.shape[-1]
    start = sum(hh * ww for hh, ww in shapes[:l])
    row = np.zeros((w_l + 2, cell_bytes(D, 4) // 4), value.dtype)
    if 0 <= y < h_l:
        row[1:-1, :D] = value[b, start + y * w_l:start + (y + 1) * w_l, h]
    return row


def _cluster_kernel_model(value, shapes, locs, attn, plan):
    """The CUDA kernel's arithmetic and staging in numpy, f32 (itemsize 4):
    per (b, h) and cluster, each band's boxes (`band_boxes`, from every
    issuing CTA) land in a buffer that starts as NaN, so a corner read off
    the staged rows shows; every row must land once. Then the cluster's
    queries walk the band as the kernel does: pixel = loc * size - 0.5 in two
    f32 roundings, a point counts when its base lies in [-1, W-1] x [-1, H-1],
    its top corners at byte offset level_byte + (y0 + 1) * pitch + (x0 + 1) *
    cell of the pitched slab, each corner row added in the band that holds
    it; a non-finite coordinate makes the row NaN."""
    from poet_tpu_torch.ops.deform_attn_v2_cuda import band_boxes, cell_bytes, row_geometry

    B, S, H, D = value.shape
    Q, L, P = locs.shape[1], locs.shape[3], locs.shape[4]
    cell = cell_bytes(D, 4)
    geometry = row_geometry(shapes, D, 4)
    level_byte, level_pitch, at = [], [], 0
    for l, (h_l, _) in enumerate(shapes):
        rows = [g for g in geometry if g[0] == l]
        level_byte.append(at)
        level_pitch.append(rows[0][3])
        at += sum(g[3] for g in rows)
    f32 = np.float32
    out = np.zeros((B, Q, H, D), np.float32)
    per_cluster = plan.cluster * plan.q_per_cta
    for b in range(B):
        for h in range(H):
            for cl in range(plan.clusters):
                qs = np.arange(cl * per_cluster, min(Q, (cl + 1) * per_cluster))
                acc = np.zeros((len(qs), D), np.float32)
                nonfinite = np.zeros(len(qs), bool)
                for k in range(plan.n_bands):
                    buf = np.full(plan.buffer_bytes // 4, np.nan, np.float32)
                    landed = np.zeros(plan.band_bytes[k + 1] - plan.band_bytes[k], int)
                    for rank, l, y, dst, nbytes in band_boxes(plan, shapes, D, 4, k):
                        buf[dst // 4:(dst + nbytes) // 4] = _staged_row(value, shapes, b, h, l,
                                                                       y).ravel()
                        landed[dst:dst + nbytes] += 1
                    lo, hi = plan.band_bytes[k], plan.band_bytes[k + 1]
                    for l, (h_l, w_l) in enumerate(shapes):
                        for p in range(P):
                            lx, ly = locs[b, qs, h, l, p, 0], locs[b, qs, h, l, p, 1]
                            x = (lx * f32(w_l)).astype(f32) - f32(0.5)
                            y = (ly * f32(h_l)).astype(f32) - f32(0.5)
                            ok = (x >= -1) & (x < w_l) & (y >= -1) & (y < h_l)
                            nonfinite |= ~ok & ~(np.isfinite(x) & np.isfinite(y))
                            x0, y0 = np.floor(np.where(ok, x, 0)), np.floor(np.where(ok, y, 0))
                            tx, ty = (x - x0).astype(f32), (y - y0).astype(f32)
                            a = attn[b, qs, h, l, p]
                            top = (level_byte[l] + (y0.astype(int) + 1) * level_pitch[l]
                                   + (x0.astype(int) + 1) * cell)
                            for g, wy in ((top, (1 - ty) * a), (top + level_pitch[l], ty * a)):
                                inb = ok & (g >= lo) & (g < hi)
                                for dc, wx in ((0, 1 - tx), (cell, tx)):
                                    at_ = np.where(inb, g + dc - lo, 0) // 4
                                    assert (landed[at_[inb] * 4] == 1).all()
                                    corner = buf[at_[:, None] + np.arange(D)]
                                    acc += np.where(inb[:, None],
                                                    (wx * wy)[:, None] * corner, 0)
                acc[nonfinite] = np.nan
                out[b, qs, h] = acc
    return out.reshape(B, Q, H * D)


@pytest.mark.parametrize("case,budget_rows", [("jax_q6", 1), ("jax_q6", 3),
                                              ("borders", 2), ("edge_levels", 1),
                                              ("dummy_queries", 1000), ("narrow_head", 2),
                                              ("narrow_head", 1000)])
def test_slab_bands_model_matches_pallas_v2_interpret(rng, case, budget_rows):
    """The kernel's staging, layout and band arithmetic, at a budget of
    about `budget_rows` of the widest pitched row (one row per band at 1;
    the default plan, one band, at 1000)."""
    from poet_tpu_torch.ops.deform_attn_v2_cuda import plan_v2, row_geometry

    value, shapes, locs, w = _case(rng, case)
    B, _, H, D = value.shape
    Q, L, P = locs.shape[1], locs.shape[3], locs.shape[4]
    widest = max(g[3] for g in row_geometry(shapes, D, 4))
    plan = plan_v2(B, H, Q, D, L, P, shapes, 4,
                   budget=budget_rows * widest if budget_rows < 1000 else None)
    assert (plan.n_bands > 1) == (budget_rows < 1000)
    assert plan.tma == (D * 4 % 16 == 0) and (plan.tma or plan.cluster == 1)
    np.testing.assert_allclose(_cluster_kernel_model(value, shapes, locs, w, plan),
                               _jax_v2(value, shapes, locs, w), atol=V2_ATOL)


@pytest.mark.parametrize("sms,budget,want", [
    (1, 3 * 384, (3, 1, 16, 4, 1)),       # several bands: 16 CTAs, each staging alone
    (2, None, (1, 2, 1, 4, 5)),           # one band: a multicast cluster of two CTAs
])
def test_cluster_model_takes_several_clusters_and_nan_rows(rng, sms, budget, want):
    """Several bands and more queries than one CTA holds in one pass (16
    clusters of one per (b, h)), or one band over a multicast cluster of two
    CTAs taking their queries in passes, and the C1 rule: a NaN coordinate's
    row is NaN."""
    from poet_tpu_torch.ops.deform_attn_v2_cuda import plan_v2
    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch

    value, shapes, locs, w = _make_inputs(rng, B=1, Q=2100, H=1, D=16,
                                          shapes=((3, 4), (2, 2)))
    locs[0, 5, 0, 1, 2, 0] = np.nan
    plan = plan_v2(1, 1, 2100, 16, 2, locs.shape[4], shapes, 4, sms=sms, budget=budget)
    assert (plan.n_bands, plan.cluster, plan.clusters, plan.slices, plan.passes) == want
    got = _cluster_kernel_model(value, shapes, locs, w, plan)
    want = ms_deform_attn_torch(*(torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                                  for x in (value, shapes, locs, w))).numpy()
    assert np.isnan(got[0, 5]).all() and np.isnan(want[0, 5]).all()
    np.testing.assert_allclose(np.delete(got, 5, axis=1), np.delete(want, 5, axis=1),
                               atol=V2_ATOL)


def _pyramids():
    level = st.tuples(st.integers(1, 12), st.integers(1, 40))
    return st.lists(level, min_size=1, max_size=4).map(tuple)


@settings(max_examples=60, deadline=None)
@given(shapes=_pyramids(), itemsize=st.sampled_from([2, 4]),
       D=st.sampled_from([4, 6, 8, 16, 32]), budget_rows=st.sampled_from([None, 1, 2, 5]),
       B=st.integers(1, 3), H=st.integers(1, 4), Q=st.integers(1, 5000),
       sms=st.sampled_from([1, 132]), aligned=st.booleans())
def test_cluster_plan_stages_every_row_once(shapes, itemsize, D, budget_rows, B, H, Q, sms,
                                            aligned):
    """`plan_v2` over pyramids, dtypes, heads, bases and budgets: the bands
    tile the padded rows in order within the budget and the shared memory;
    in each band every padded row is one box, issued by exactly one CTA of
    the cluster (rank = row index in the band mod n, so the CTAs' shares
    cover the band), landing at a 128-byte aligned offset inside the buffer
    without overlap; every box within TMA's limits where TMA stages, else a
    cluster of one; every query in exactly one CTA, taken in passes of whole
    queries (one pass where there are several bands); no CTA over its thread
    bound."""
    from poet_tpu_torch.ops.deform_attn_v2_cuda import (
        ALIGN,
        KEEP_THREADS,
        MAX_CLUSTER,
        MAX_THREADS,
        OVERHEAD,
        SMEM_OPTIN_MAX,
        TMA_BOX_MAX,
        band_boxes,
        cell_bytes,
        plan_v2,
        row_geometry,
    )

    geometry = row_geometry(shapes, D, itemsize)
    widest = max(g[3] for g in geometry)
    budget = budget_rows and budget_rows * widest
    try:
        plan = plan_v2(B, H, Q, D, len(shapes), 4, shapes, itemsize, sms, budget, aligned)
    except ValueError as e:          # more than MAX_BANDS bands of one row
        assert "bands needed" in str(e)
        return
    assert plan.bands[0] == 0 and plan.bands[-1] == len(geometry)
    assert all(a < b for a, b in zip(plan.bands[:-1], plan.bands[1:]))
    assert plan.smem <= SMEM_OPTIN_MAX and OVERHEAD + plan.buffers * plan.buffer_bytes == plan.smem
    if budget:
        assert plan.buffer_bytes <= budget
    assert plan.tma == (aligned and D * itemsize % 16 == 0)      # every W + 2 <= 42 here
    assert plan.tma or plan.cluster == 1
    for k in range(plan.n_bands):
        boxes = band_boxes(plan, shapes, D, itemsize, k)
        assert len(boxes) == plan.bands[k + 1] - plan.bands[k]        # each row one box
        ranks = [rank for rank, *_ in boxes]
        assert ranks == [i % plan.cluster for i in range(len(boxes))]
        assert set(ranks) <= set(range(plan.cluster))
        end = 0
        for rank, l, y, dst, nbytes in boxes:
            h_l, w_l = shapes[l]
            assert -1 <= y <= h_l and dst % ALIGN == 0 and dst >= end
            if plan.tma:
                assert w_l + 2 <= TMA_BOX_MAX and D <= TMA_BOX_MAX and (D * itemsize) % 16 == 0
            assert nbytes == (w_l + 2) * cell_bytes(D, itemsize)
            end = dst + nbytes
        assert end <= plan.buffer_bytes
    assert plan.cluster <= MAX_CLUSTER
    per_pass = plan.threads // plan.slices
    assert plan.threads % 32 == 0 and plan.passes * per_pass >= plan.q_per_cta
    assert plan.n_bands == 1 or plan.passes == 1
    assert plan.threads <= (KEEP_THREADS if plan.keep else MAX_THREADS)
    owner = np.zeros(Q, int)
    for i in range(plan.cluster * plan.clusters):
        owner[i * plan.q_per_cta:(i + 1) * plan.q_per_cta] += 1
    assert (owner == 1).all()


@pytest.mark.parametrize("shapes,itemsize,budget", [
    (FLAGSHIP, 2, None), (FLAGSHIP, 4, None), (YOLO, 2, None), (YOLO, 4, None),
    (YOLO, 2, 232448), (YOLO, 4, 30000), (FLAGSHIP, 4, 5000), (((1, 7), (3, 1), (1, 1)), 4, 600),
])
def test_plan_bands_covers_every_padded_row_once(shapes, itemsize, budget):
    from poet_tpu_torch.ops.deform_attn_v2_cuda import (
        OVERHEAD,
        SMEM_OPTIN_MAX,
        _greedy,
        plan_bands,
        row_geometry,
    )

    budget = budget or (SMEM_OPTIN_MAX - OVERHEAD) // 2
    D = 8                                       # a 600-byte budget holds one pitched edge row
    bands = plan_bands(shapes, D, itemsize, budget)
    rows = [g[3] for g in row_geometry(shapes, D, itemsize)]
    assert bands[0] == 0 and bands[-1] == len(rows)
    assert all(a < b for a, b in zip(bands[:-1], bands[1:]))     # each row in one band
    sizes = [sum(rows[a:b]) for a, b in zip(bands[:-1], bands[1:])]
    assert max(sizes) <= budget and sum(sizes) == sum(rows)
    assert len(bands) == len(_greedy(rows, budget))               # fewest


def test_plan_bands_pyramid_sizes():
    """The sizes the kernel's design was reckoned on, at D = 16: the
    flagship and YOLO slabs at their 128-byte row pitch; each one band in
    bf16, the YOLO pyramid four double-buffered bands in f32."""
    from poet_tpu_torch.ops.deform_attn_v2_cuda import plan_v2, row_geometry

    cells = [sum(g[2] for g in row_geometry(shapes, 16, 1)) // 16 for shapes in (FLAGSHIP, YOLO)]
    assert cells == [1880, 6922]                       # padded cells of one (b, h)
    assert sum(g[3] for g in row_geometry(FLAGSHIP, 16, 2)) == 63488     # 60 160 unpitched
    assert sum(g[3] for g in row_geometry(YOLO, 16, 2)) == 228608        # 221 504 unpitched
    assert sum(g[3] for g in row_geometry(YOLO, 16, 4)) == 443008        # 82 x 64 B = 5248
    enc = plan_v2(16, 16, 1600, 16, 4, 4, FLAGSHIP, 2)
    assert (enc.n_bands, enc.buffers, enc.cluster, enc.clusters) == (1, 1, 1, 1)
    assert (enc.q_per_cta, enc.threads, enc.passes) == (1600, 800, 4)
    assert enc.staged_bytes_per_bh() * 16 * 16 == 15400960              # ~15 MB through the L2
    yolo = plan_v2(16, 16, 6380, 16, 4, 4, YOLO, 2)
    assert (yolo.n_bands, yolo.buffers, yolo.smem) == (1, 1, 228864)
    assert plan_v2(16, 16, 6380, 16, 4, 4, YOLO, 4).n_bands == 4
    assert plan_v2(16, 16, 10, 16, 4, 4, FLAGSHIP, 2).cluster == 1      # the decoder


def test_plan_bands_refuses():
    from poet_tpu_torch.ops.deform_attn_v2_cuda import plan_bands, plan_v2

    with pytest.raises(ValueError, match="exceeds the band budget"):
        plan_bands(YOLO, 16, 4, 82 * 16 * 4 - 1)       # one YOLO level-0 row does not fit
    with pytest.raises(ValueError, match="bands needed"):
        plan_bands(YOLO, 16, 4, 82 * 16 * 4)           # over 100 bands
    with pytest.raises(ValueError, match="exceeds the band budget"):
        plan_v2(1, 1, 9, 512, 1, 4, ((2, 3),), 4, budget=2048)
    with pytest.raises(ValueError, match="slices a query"):
        plan_v2(1, 1, 9, 4100, 1, 4, ((1, 1),), 4)     # 1025 16-byte slices a query


@pytest.mark.parametrize("D,itemsize,shapes,aligned", [
    (6, 4, ((5, 7), (3, 4)), True),       # a 24-byte head
    (6, 2, ((5, 7), (3, 4)), True),       # 12 bytes
    (4, 2, ((5, 7), (3, 4)), True),       # 8 bytes
    (8, 4, ((2, 255),), True),            # W + 2 = 257 cells, over TMA's box
    (512, 4, ((2, 3),), True),            # D over TMA's box
    (16, 2, FLAGSHIP, False),             # a base off 16 bytes
])
def test_plan_v2_stages_by_threads_where_tma_cannot(D, itemsize, shapes, aligned):
    """What TMA cannot describe is staged by each CTA's threads: the same
    CTAs in clusters of one, a cell of D values rounded up to 16 bytes."""
    from poet_tpu_torch.ops.deform_attn_v2_cuda import cell_bytes, plan_v2

    args = (16, 16, 1600, D, len(shapes), 4, shapes, itemsize)
    plan = plan_v2(*args, aligned=aligned)
    assert not plan.tma and plan.cluster == 1
    assert plan.slices == -(-D * itemsize // 16) == cell_bytes(D, itemsize) // 16
    if D * itemsize % 16 == 0 and D <= 256 and all(w + 2 <= 256 for _, w in shapes):
        tma = plan_v2(*args)                            # the same value, aligned
        assert tma.tma and tma.cluster * tma.clusters == plan.clusters


@pytest.mark.parametrize("B,H,Q,itemsize", [(16, 16, 1600, 2), (16, 16, 1600, 4),
                                            (16, 16, 10, 2), (2, 16, 6380, 2), (1, 2, 300, 2),
                                            (4, 16, 1600, 2), (3, 16, 1600, 4)])
def test_query_chunk_fills_the_card(B, H, Q, itemsize):
    """The one-band plan gives a (b, h) as many CTAs as one wave of the
    card's SMs holds, at least one, where the queries and MAX_CLUSTER allow
    (a CTA keeps at least a warp of slices), each within its thread bound;
    a multicast cluster only where that is at most MULTICAST_MAX CTAs."""
    from poet_tpu_torch.ops.deform_attn_v2_cuda import (
        MAX_CLUSTER,
        MAX_THREADS,
        MULTICAST_MAX,
        plan_v2,
    )

    sms = 132                                          # an H100 SXM
    plan = plan_v2(B, H, Q, 16, 4, 4, FLAGSHIP, itemsize, sms)
    assert 1 <= plan.q_per_cta <= Q and plan.threads <= MAX_THREADS
    per_bh = plan.cluster * plan.clusters
    assert per_bh == max(1, min(sms // (B * H), MAX_CLUSTER, -(-Q * plan.slices // 32)))
    assert B * H * per_bh <= max(sms, B * H)                      # one wave
    assert plan.cluster == (per_bh if per_bh <= MULTICAST_MAX else 1)


def test_v2_entry_refuses_inputs_that_require_grad(rng):
    from poet_tpu_torch.ops.deform_attn_v2_cuda import ms_deform_attn_v2

    value, shapes, locs, w = (torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                              for x in _make_inputs(rng))
    for i in range(3):
        args = [value, locs, w]
        args[i] = args[i].clone().requires_grad_()
        with pytest.raises(ValueError, match="forward only"):
            ms_deform_attn_v2(args[0], shapes, args[1], args[2])


def test_v2_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """The wrapper takes CUDA tensors only (the entry sends CPU tensors to
    the plain version); a band budget below one padded row raises."""
    from poet_tpu_torch.ops.deform_attn_v2_cuda import MS_DEFORM_ATTN_V2 as K

    shapes = ((3, 4), (2, 2))
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            K(torch.zeros((2, 16, 2, 8), device=device), shapes,
              torch.zeros((2, 5, 2, 2, 4, 2), device=device),
              torch.zeros((2, 5, 2, 2, 4), device=device))
    assert K.launches == 0
