"""The d_loc / d_attn gather, a lane per sampling point (`csrc/
ms_deform_attn_point.cuh:dloc_walk`), at its two call sites, on the CPU.

* the pair's routes (`ops/deform_attn_cuda.py:MSDeformAttnDLoc`, two
  instances): the slab route (`csrc/ms_deform_attn_point.cuh:
  ms_deform_attn_dloc_slab_kernel`: a block per (b, h) on its staged value
  slab) and the direct route (`ms_deform_attn_dloc_kernel`: a block per
  (b, h, 256 points) reading device memory), and their rule `plan_dloc` at
  the flagship encoder and decoder and the YOLO pyramid, never over the
  232 448 B a block may opt into;
* the dense adjoint's d_loc / d_attn blocks (`csrc/ms_deform_attn_dense.cu`,
  the same walk under the one-hot corner rule), which take the pair's rule:
  staged in a launch of their own (the pair's slab kernel under the one-hot
  rule, a third instance of the wrapper) or
  from device memory inside the d_value blocks' launch;
* a numpy model of the partition at the kernels' own block sizes (the lane
  -> (q, k) map, each lane's staggered channel chunks, the 16-byte staging):
  every (b, q, h, k) of d_loc / d_attn written exactly once, pad and dummy
  queries included, every in-map corner's chunk read once, every slab cell
  staged once; held against `jax.grad` of `ms_deform_attn_xla`, JAX's
  two-kernel adjoint (`ms_deform_attn_fused_t2`, whose backward runs
  `_bwd_dloc_kernel`) and, for the dense rule, JAX's Pallas v1 adjoint, both
  in interpret mode, within 1e-5 of scale at f32, the C1 NaN case included;
* the stagger's bank spread, what the wrapper refuses, the dispatch by the
  rule, the profiler's names and chip_smoke's launch plan.

The kernels themselves run only on the card (chip_smoke.py phases 6, 18,
19, 20; `poet_tpu_torch/tools/bench_dloc.py`, `bench_dense.py`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poet_tpu_torch.ops import deform_attn_cuda as dac
from poet_tpu_torch.ops import deform_attn_dense_cuda as dense
from tests.test_torch_deform_attn_dense_tiles import _terms
from tests.test_torch_deform_attn_slab import (
    CASES,
    FLAGSHIP,
    YOLO,
    _case,
    _close,
    _footprint,
    _nonfinite,
    _xla,
)
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

BUDGET = 232448
SLAB_THREADS, DIRECT_THREADS = 512, 256       # kDlocSlabThreads, kDlocThreads
# the dense adjoint's: kDlocSlabThreads (staged, its own launch), BWD_THREADS
DENSE_THREADS = {True: 512, False: 256}
F32 = np.float32


# ------------------------------------------------------------------- rules

@pytest.mark.parametrize("dtype, slab_bytes", [(torch.bfloat16, 51200), (torch.float32, 102400)])
def test_pair_rule_takes_the_slab_at_the_flagship_encoder(dtype, slab_bytes):
    """B=16, Q=S=1600, H=16, D=16, L=P=4: 64 corner reads per token, the
    value slab staged (51 200 B bf16, 102 400 B f32)."""
    assert dac.plan_dloc(1600, 16, dtype, 1600, 4, 4) == ("slab", True, slab_bytes)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pair_rule_keeps_the_direct_route_at_the_decoder(dtype):
    """Q=10 over S=1600 tokens: 0.4 reads per token."""
    assert dac.corner_reads_per_token(1600, 10, 4, 4) == 0.4
    assert dac.plan_dloc(1600, 16, dtype, 10, 4, 4) == ("direct", False, 0)


def test_pair_rule_at_the_yolo_pyramid():
    """S=6380: the bf16 slab fits (204 160 B), the f32 one (408 320 B) does not."""
    assert dac.plan_dloc(6380, 16, torch.bfloat16, 6380, 4, 4) == ("slab", True, 204160)
    assert dac.plan_dloc(6380, 16, torch.float32, 6380, 4, 4) == ("direct", False, 0)
    assert dac.plan_dloc(6380, 16, torch.bfloat16, 10, 4, 4).route == "direct"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [6, 8, 16, 32])
def test_pair_rule_never_exceeds_the_budget(dtype, D):
    """Over S and Q: 'slab' exactly where the slab fits and each token is
    read at least 8 times, as the forward's rule."""
    size = torch.finfo(dtype).bits // 8
    for S in (11, 100, 1600, 3632, 3633, 6380, 7264, 7265, 14530):
        for Q in (1, 10, 100, S):
            plan = dac.plan_dloc(S, D, dtype, Q, 4, 4)
            assert plan == dac.plan_forward(S, D, dtype, Q, 4, 4)
            assert plan.smem_bytes <= BUDGET
            fits = S * D * size <= BUDGET and 4 * 4 * 4 * Q / S >= 8
            assert plan == (("slab", True, S * D * size) if fits else ("direct", False, 0))


def test_dense_adjoint_takes_the_pairs_rule():
    """The dense d_loc / d_attn blocks' route is `plan_dloc`'s; the d_value
    blocks keep their own shared memory (99 440 B at the flagship), since
    the staged d_loc blocks run in a launch of their own."""
    assert dense.plan_dloc is dac.plan_dloc
    assert dense.plan_dense_adjoint(FLAGSHIP, 16, 4).smem_bytes == 99440


@pytest.mark.parametrize("Q, levels, dtype, stage", [
    (1600, FLAGSHIP, torch.bfloat16, True),
    (1600, FLAGSHIP, torch.float32, True),
    (10, FLAGSHIP, torch.bfloat16, False),
    (10, FLAGSHIP, torch.float32, False),
    (6380, YOLO, torch.bfloat16, True),
    (6380, YOLO, torch.float32, False),
])
def test_dense_d_loc_route_at_the_path_shapes(Q, levels, dtype, stage):
    """Staged at the encoder (one (b, h) block each, a second launch), from
    device memory at the decoder and at the YOLO pyramid in f32."""
    S = sum(h * w for h, w in levels)
    assert dac.plan_dloc(S, 16, dtype, Q, 4, 4).stage == stage


# ------------------------------------------------------------------ model

def _vec(D, itemsize):
    """Channels a load (the wrappers' vec with aligned pointers)."""
    return 16 // itemsize if D % (16 // itemsize) == 0 else 1


def _gather_rule(lx, ly, h, w):
    """GatherRule::footprint: ('hit', footprint), 'miss' or 'nonfinite'."""
    f = _footprint(lx, ly, h, w)
    if f is None:
        return ("nonfinite" if _nonfinite(lx, ly, h, w) else "miss"), None
    return "hit", f


def _onehot_rule(lx, ly, h, w):
    """OneHotRule::footprint: the dense kernel's corner terms as a footprint."""
    kind, terms = _terms(lx, ly, h, w)
    if kind != "hit":
        return kind, None
    x0, y0, tx, ty = terms
    return "hit", (y0 * w + x0, float(tx), float(ty), 0 <= x0 < w, x0 + 1 < w,
                   0 <= y0 < h, y0 + 1 < h)


def _gather_grads(f, a, h, w, e):
    """point_grads."""
    _, tx, ty = f[:3]
    d_attn = (1 - ty) * ((1 - tx) * e[0] + tx * e[1]) + ty * ((1 - tx) * e[2] + tx * e[3])
    return d_attn, (a * w * ((1 - ty) * (e[1] - e[0]) + ty * (e[3] - e[2])),
                    a * h * ((1 - tx) * (e[2] - e[0]) + tx * (e[3] - e[1])))


def _onehot_grads(f, a, h, w, e):
    """OneHotRule::grads."""
    _, tx, ty = f[:3]
    d_attn = ((1 - tx) * (1 - ty) * e[0] + tx * (1 - ty) * e[1] + (1 - tx) * ty * e[2]
              + tx * ty * e[3])
    return d_attn, (a * ((1 - ty) * (e[1] - e[0]) + ty * (e[3] - e[2])) * w,
                    a * ((1 - tx) * (e[2] - e[0]) + tx * (e[3] - e[1])) * h)


RULES = {"gather": (_gather_rule, _gather_grads), "onehot": (_onehot_rule, _onehot_grads)}


def _in_map_corners(f, w):
    """for_each_corner: (corner, token in the level) of the in-map corners."""
    t00, _, _, ix0, ix1, iy0, iy1 = f
    return [(c, t) for c, t, on in ((0, t00, iy0 and ix0), (1, t00 + 1, iy0 and ix1),
                                    (2, t00 + w, iy1 and ix0), (3, t00 + w + 1, iy1 and ix1))
            if on]


def dloc_model(value, shapes, locs, attn, dout, rule="gather", stage=True, threads=SLAB_THREADS,
               itemsize=4):
    """The walk's partition in numpy (float64 dot products), block by block:
    a block per (b, h) with `stage` (span = all Q L P points; the slab staged
    by `threads` threads, 16 bytes a copy where D allows), else a block per
    (b, h, `threads` points) on device memory (dloc_block_of); thread tid
    walks items it = first + tid, + threads, ... < last (q = it // LP, k =
    it % LP), lane tid % 32 taking its channel chunks from lane % chunks on;
    per chunk every in-map corner of the point is read once; the rule gives
    the footprint and the gradients. Returns d_loc, d_attn, the writes per
    (b, q, h, k), the reads per (b, q, h, k, corner, chunk) and the staged
    copies per (b, h, token, channel)."""
    footprint, grads = RULES[rule]
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = locs.shape
    LP, n = L * P, Q * L * P
    VEC = _vec(D, itemsize)
    chunks = D // VEC
    span = n if stage else threads
    runs = -(-n // span)
    starts = np.cumsum([0] + [h * w for h, w in shapes])
    d_loc = np.full(locs.shape, np.nan)
    d_attn = np.full(attn.shape, np.nan)
    writes = np.zeros((B, Q, H, LP), np.int64)
    reads = np.zeros((B, Q, H, LP, 4, chunks), np.int64)
    staged = np.zeros((B, H, S, D), np.int64)
    for blk in range(B * H * runs):
        bh, run = divmod(blk, runs)
        b, h = divmod(bh, H)
        first, last = run * span, min(run * span + span, n)
        src = value[b, :, h].astype(np.float64)
        if stage:                        # stage_slab: 16-byte copies, else element by element
            per = D * itemsize // 16 if D * itemsize % 16 == 0 else 0
            cells = (S * per, per, 16 // itemsize) if per else (S * D, D, 1)
            slab = np.full((S, D), np.nan)
            for tid in range(threads):
                for i in range(tid, cells[0], threads):
                    t, j = divmod(i, cells[1])
                    ch = slice(j * cells[2], (j + 1) * cells[2])
                    slab[t, ch] = src[t, ch]
                    staged[b, h, t, ch] += 1
        else:
            slab = src
        for tid in range(threads):
            rot = (tid & 31) % chunks
            for it in range(first + tid, last, threads):
                q, k = divmod(it, LP)
                l, p = divmod(k, P)
                hl, wl = shapes[l]
                kind, f = footprint(*locs[b, q, h, l, p], hl, wl)
                writes[b, q, h, k] += 1
                if kind != "hit":        # 0 off the map, NaN for a non-finite coordinate
                    d_loc[b, q, h, l, p] = d_attn[b, q, h, l, p] = (
                        np.nan if kind == "nonfinite" else 0.0)
                    continue
                g = dout[b, q, h * D:(h + 1) * D].astype(np.float64)
                e = np.zeros(4)
                for i in range(chunks):
                    c = (i + rot) % chunks
                    ch = slice(c * VEC, (c + 1) * VEC)
                    for cc, t in _in_map_corners(f, wl):
                        e[cc] += g[ch] @ slab[starts[l] + t, ch]
                        reads[b, q, h, k, cc, c] += 1
                d_attn[b, q, h, l, p], d_loc[b, q, h, l, p] = grads(
                    f, float(attn[b, q, h, l, p]), hl, wl, e)
    return d_loc, d_attn, writes, reads, staged


def _want_reads(shapes, locs, rule, chunks):
    footprint, _ = RULES[rule]
    B, Q, H, L, P, _ = locs.shape
    want = np.zeros((B, Q, H, L * P, 4, chunks), np.int64)
    for b, q, h, l, p in np.ndindex(B, Q, H, L, P):
        kind, f = footprint(*locs[b, q, h, l, p], *shapes[l])
        for cc, _ in ([] if kind != "hit" else _in_map_corners(f, shapes[l][1])):
            want[b, q, h, l * P + p, cc, :] = 1
    return want


ROUTES = {"slab": (True, SLAB_THREADS), "direct": (False, DIRECT_THREADS)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("nan", [False, True])
def test_pair_partition_writes_each_point_once_and_matches_jax(rng, case, route, nan):
    """The pair's two routes at their block sizes (slab: a block per (b, h),
    512 threads; direct: a block per (b, h, 256 points)): every point's
    d_loc / d_attn written once (dummy queries 0, C1 points NaN in d_attn
    and both coordinates), every in-map corner's chunk read once, against
    the gradient of JAX's ms_deform_attn_xla."""
    value, shapes, locs, w, dout = _case(rng, case, nan)
    stage, threads = ROUTES[route]
    d_loc, d_attn, writes, reads, staged = dloc_model(value, shapes, locs, w, dout, "gather",
                                                      stage, threads)
    assert (writes == 1).all()
    np.testing.assert_array_equal(reads, _want_reads(shapes, locs, "gather", reads.shape[-1]))
    assert (d_loc[:, -2:] == 0).all() and (d_attn[:, -2:] == 0).all()
    if nan:
        assert np.isnan(d_loc[:, 0, :, 0, 1]).all() and np.isnan(d_attn[:, 0, :, 0, 1]).all()
    _, ref = _xla(value, shapes, locs, w, dout)
    _close(d_loc, ref[1], "d_loc")
    _close(d_attn, ref[2], "d_attn")


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("case", ["D16", "D12 pad tokens", "D6 edge levels"])
def test_slab_staging_copies_every_cell_once(rng, case, itemsize):
    """stage_slab at the slab kernel's 512 threads: 16-byte copies where D
    values fill them (D=16 both sizes, D=12 f32), element copies otherwise;
    every (token, channel) of the pair's slab, pad tokens included, once."""
    value, shapes, locs, w, dout = _case(rng, case)
    *_, staged = dloc_model(value, shapes, locs, w, dout, itemsize=itemsize)
    assert (staged == 1).all()


def _wavefronts(tokens, chunks, stagger, row_bytes):
    """Shared-memory wavefronts of one 16-byte load by a quarter warp (8
    lanes) reading chunk (step + lane) % chunks (stagger) or chunk 0 of their
    tokens from a packed slab: the most distinct addresses on one group of 4
    banks."""
    groups = {}
    for lane, t in enumerate(tokens):
        c = lane % chunks if stagger else 0
        addr = t * row_bytes + 16 * c
        groups.setdefault((addr // 16) % 8, set()).add(addr)
    return max(len(a) for a in groups.values())


@pytest.mark.parametrize("itemsize", [2, 4])
def test_stagger_spreads_a_quarter_warp_over_more_banks(itemsize):
    """D=16: a bf16 token spans 2 of the 8 four-bank groups, an f32 one 4.
    Unstaggered, the lanes' first chunks fall on every 4th (bf16) or 2nd
    (f32) group only; the stagger uses all eight, so random tokens cost
    fewer wavefronts on average (the slab route's conflicts, measured on the
    card against one shared token in bench_dloc.py)."""
    rng = np.random.default_rng(3)
    chunks, row = 16 * itemsize // 16, 16 * itemsize
    draws = [rng.integers(0, 1600, size=8) for _ in range(400)]
    flat = np.mean([_wavefronts(t, chunks, False, row) for t in draws])
    staggered = np.mean([_wavefronts(t, chunks, True, row) for t in draws])
    assert staggered < flat
    assert max(_wavefronts(t, chunks, True, row) for t in draws) <= 8
    assert _wavefronts([5] * 8, chunks, False, row) == 1       # one token: a broadcast


# ------------------------------------------- against JAX's own kernels

def _to_t2(loc, attn, Q_pad):
    """locT / attnT in the fused_t2 layout: (B, F, Q_pad), F = H L P (x 2)."""
    B, Q = loc.shape[:2]
    pad = ((0, 0), (0, Q_pad - Q), (0, 0))
    return (jnp.pad(loc.reshape(B, Q, -1), pad).transpose(0, 2, 1),
            jnp.pad(attn.reshape(B, Q, -1), pad).transpose(0, 2, 1))


@pytest.mark.parametrize("nan", [False, True])
def test_pair_model_matches_the_two_kernel_adjoint_interpret(rng, nan):
    """Against JAX's `_bwd_dloc_kernel` itself: jax.grad of
    ms_deform_attn_fused_t2 (two-kernel backward) in interpret mode. C1:
    JAX's d_attn is NaN at the point too; its d_loc NaN lies within the
    model's two NaN coordinates; every finite entry within 1e-5 of scale."""
    from jax.experimental.pallas import tpu as pltpu

    from poet_tpu.ops.deform_attn_pallas_v3 import _QT, ms_deform_attn_fused_t2

    value, shapes, locs, w, dout = _case(rng, "D16", nan)
    B, Q = locs.shape[:2]
    Q_pad = -(-Q // _QT) * _QT

    def f(loc, attn):
        lT, aT = _to_t2(loc, attn, Q_pad)
        out = ms_deform_attn_fused_t2(jnp.asarray(value), shapes, lT, aT)
        return jnp.vdot(out.transpose(0, 2, 1)[:, :Q], jnp.asarray(dout))

    with pltpu.force_tpu_interpret_mode():
        g_loc, g_attn = (np.asarray(g) for g in
                         jax.grad(f, argnums=(0, 1))(jnp.asarray(locs), jnp.asarray(w)))
    d_loc, d_attn, *_ = dloc_model(value, shapes, locs, w, dout, "gather", True, SLAB_THREADS)
    np.testing.assert_array_equal(np.isnan(g_attn), np.isnan(d_attn))
    assert not (np.isnan(g_loc) & ~np.isnan(d_loc)).any()
    for got, want, name in ((d_loc, g_loc, "d_loc"), (d_attn, g_attn, "d_attn")):
        both = np.isfinite(got) & np.isfinite(want)
        scale = float(np.abs(want[both]).max())
        np.testing.assert_allclose(got[both], want[both], rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["D16", "D6 edge levels", "far out of map"])
@pytest.mark.parametrize("stage", [True, False])
@pytest.mark.parametrize("nan", [False, True])
def test_dense_partition_writes_each_point_once_and_matches_jax(rng, case, stage, nan):
    """The dense adjoint's d_loc blocks under the one-hot rule, staged (a
    block per (b, h), 512 threads, a kernel of its own) or not (a block per
    (b, h, 256 points) of the d_value blocks' launch):
    every point written once, every in-map corner's chunk read once, against
    the gradient of ms_deform_attn_xla (which agrees with the one-hot rule
    off the exact -1 / size edges random locations do not hit)."""
    value, shapes, locs, w, dout = _case(rng, case, nan)
    d_loc, d_attn, writes, reads, _ = dloc_model(value, shapes, locs, w, dout, "onehot", stage,
                                                 DENSE_THREADS[stage])
    assert (writes == 1).all()
    np.testing.assert_array_equal(reads, _want_reads(shapes, locs, "onehot", reads.shape[-1]))
    assert (d_loc[:, -2:] == 0).all() and (d_attn[:, -2:] == 0).all()
    _, ref = _xla(value, shapes, locs, w, dout)
    _close(d_loc, ref[1], "d_loc")
    _close(d_attn, ref[2], "d_attn")


@pytest.mark.parametrize("stage", [True, False])
def test_dense_model_matches_pallas_v1_adjoint_interpret(rng, stage):
    """Against the TPU dense adjoint kernel itself (deform_attn_pallas.py
    `_bwd_kernel`, interpret mode): d_loc and d_attn within 1e-5 of scale."""
    from jax.experimental.pallas import tpu as pltpu

    from poet_tpu.ops.deform_attn_pallas import ms_deform_attn_pallas

    value, shapes, locs, w, dout = _case(rng, "D16")
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda l, a: ms_deform_attn_pallas(jnp.asarray(value), shapes, l, a),
                         jnp.asarray(locs), jnp.asarray(w))
        g_loc, g_attn = (np.asarray(g) for g in vjp(jnp.asarray(dout)))
    d_loc, d_attn, *_ = dloc_model(value, shapes, locs, w, dout, "onehot", stage,
                                   DENSE_THREADS[stage])
    _close(d_loc, g_loc, "d_loc")
    _close(d_attn, g_attn, "d_attn")


def test_the_two_rules_differ_only_on_the_maps_edges():
    """A point at pixel x = -1 exactly: the gather rule's footprint refuses
    it (0 gradients); the one-hot rule keeps it (x0 = -1, its x0 + 1 corner
    on the map), as JAX's dense kernel does."""
    lx = F32(-0.5) / F32(4)                         # x = lx * 4 - 0.5 = -1
    assert _gather_rule(lx, F32(0.5), 4, 4) == ("miss", None)
    kind, f = _onehot_rule(lx, F32(0.5), 4, 4)
    assert kind == "hit" and f[3:5] == (False, True)


# ---------------------------------------------------------------- wrappers

@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_slab_wrapper_refuses_cpu_tensors(device):
    k = dac.MS_DEFORM_ATTN_DLOC_SLAB
    before = k.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        k(torch.zeros((2, 16, 2, 8), device=device), ((3, 4), (2, 2)),
          torch.zeros((2, 5, 2, 2, 4, 2), device=device),
          torch.zeros((2, 5, 2, 2, 4), device=device), torch.zeros((2, 5, 16), device=device))
    assert k.launches == before
    assert dac.BWD_LIB._lib is None


def test_slab_wrapper_is_a_kernel_of_the_module():
    assert dac.MS_DEFORM_ATTN_DLOC_SLAB in dac.KERNELS
    assert len(set(map(id, dac.KERNELS))) == len(dac.KERNELS) == 9


@pytest.mark.parametrize("Q, levels, dtype, want", [
    (1600, FLAGSHIP, torch.bfloat16, "slab"),
    (1600, FLAGSHIP, torch.float32, "slab"),
    (10, FLAGSHIP, torch.bfloat16, "direct"),
    (6380, YOLO, torch.bfloat16, "slab"),
    (6380, YOLO, torch.float32, "direct"),
])
def test_pair_dispatches_d_loc_by_the_rule(monkeypatch, Q, levels, dtype, want):
    """`dloc_adjoint` picks the rule's wrapper (meta tensors at the path
    shapes, B=16, H=16, D=16, L=P=4; the wrappers replaced by recorders)."""
    S = sum(h * w for h, w in levels)
    value = torch.empty((16, S, 16, 16), dtype=dtype, device="meta")
    locs = torch.empty((16, Q, 16, 4, 4, 2), device="meta")
    calls = []
    monkeypatch.setattr(dac, "MS_DEFORM_ATTN_DLOC_SLAB", lambda *a: calls.append("slab"))
    monkeypatch.setattr(dac, "MS_DEFORM_ATTN_DLOC", lambda *a: calls.append("direct"))
    dac.dloc_adjoint(value, levels, locs, None, None)
    assert calls == [want]


def test_train_profiler_names_the_d_loc_routes():
    from poet_tpu_torch.tools.profile_train import kernel_class

    pair, dense = "deform_point::GatherRule", "(anonymous namespace)::OneHotRule"
    assert kernel_class("void deform_point::ms_deform_attn_dloc_slab_kernel"
                        f"<{pair}, __nv_bfloat16, 8, 2>") == "d_loc/d_attn kernel (slab)"
    assert kernel_class("void deform_point::ms_deform_attn_dloc_kernel"
                        f"<{pair}, __nv_bfloat16, 8, 2>") == "d_loc/d_attn kernel"
    assert kernel_class("void deform_point::ms_deform_attn_dloc_slab_kernel"
                        f"<{dense}, __nv_bfloat16, 8, 2>") == "dense adjoint kernel (d_loc slab)"


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_chip_smoke_launch_plan_counts_the_slab_d_loc(dtype):
    """The pair's train step: the encoder's 5 d_loc launches on the slab
    route, the decoder's 5 on the direct one; none on the merged default;
    at the YOLO pyramid the slab where its slab fits (bf16)."""
    import chip_smoke as cs
    from poet_tpu_torch.flagship import flagship_config

    cfg = flagship_config(dtype)
    assert not {"d_loc", "d_loc_slab"} & set(cs.path_launches(cfg, 1600, 1, train=True))
    cfg.model.merged_adjoint = False
    got = cs.path_launches(cfg, 1600, 1, train=True)
    assert (got["d_loc_slab"], got["d_loc"]) == (5, 5)
    got = cs.path_launches(cfg, 6380, 1, train=True)
    assert (got.get("d_loc_slab", 0), got["d_loc"]) == ((5, 5) if dtype == "bfloat16"
                                                        else (0, 10))


def test_chip_smoke_reports_every_kernel():
    import chip_smoke as cs

    assert cs.KERNEL_KEYS[-3:-1] == ("d_loc_slab", "dense_dloc_slab")
    assert len(cs.all_kernels()) == len(cs.KERNEL_KEYS)
    assert cs.all_kernels()[-3:-1] == [dac.MS_DEFORM_ATTN_DLOC_SLAB,
                                       dense.MS_DEFORM_ATTN_DENSE_DLOC]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_chip_smoke_launch_plan_counts_the_dense_staged_d_loc(dtype):
    """'pallas' train step: 10 dense forward and 10 dense adjoint launches,
    and the encoder's 5 staged d_loc launches (the decoder's d_loc blocks
    ride in the adjoint's launch); YOLO f32: none staged."""
    import chip_smoke as cs
    from poet_tpu_torch.flagship import flagship_config

    cfg = flagship_config(dtype)
    cfg.model.enc_deform_impl = cfg.model.dec_deform_impl = "pallas"
    assert cs.path_launches(cfg, 1600, 2, train=True) == {
        "dense_fwd": 20, "dense_bwd": 20, "dense_dloc_slab": 10}
    assert cs.path_launches(cfg, 1600, 2) == {"dense_fwd": 20}
    assert cs.path_launches(cfg, 6380, 1, train=True).get("dense_dloc_slab", 0) == (
        5 if dtype == "bfloat16" else 0)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_dense_staged_wrapper_refuses_cpu_tensors(device):
    k = dense.MS_DEFORM_ATTN_DENSE_DLOC
    before = k.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        k(torch.zeros((2, 16, 2, 8), device=device), ((3, 4), (2, 2)),
          torch.zeros((2, 5, 2, 2, 4, 2), device=device),
          torch.zeros((2, 5, 2, 2, 4), device=device), torch.zeros((2, 5, 16), device=device))
    assert k.launches == before
    assert dense.DENSE_LIB._lib is None
    assert k in dense.KERNELS


def _rows_read_by_a_loop(locs, shapes, D, itemsize):
    """value_bytes_read restated point by point: the distinct (b, token, h)
    rows under the in-map corners of the points in the map."""
    B, Q, H, _, P, _ = locs.shape
    rows, start = set(), 0
    for l, (h, w) in enumerate(shapes):
        for b, q, hh, p in np.ndindex(B, Q, H, P):
            x = F32(locs[b, q, hh, l, p, 0]) * F32(w) - F32(0.5)
            y = F32(locs[b, q, hh, l, p, 1]) * F32(h) - F32(0.5)
            if not (-1 < x < w and -1 < y < h):
                continue
            x0, y0 = int(np.floor(x)), int(np.floor(y))
            rows |= {(b, start + cy * w + cx, hh)
                     for cy, cx in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1))
                     if 0 <= cx < w and 0 <= cy < h}
        start += h * w
    return len(rows) * D * itemsize


@pytest.mark.parametrize("Q, lo, hi", [(5, -0.2, 1.2), (2, 0.0, 1.0), (12, 0.4, 0.45)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_chip_smoke_bound_counts_the_value_rows_read(rng, Q, lo, hi, dtype):
    """The gathers' bound counts each value row under an in-map corner once
    (off-map, dummy and NaN points read nothing; rows past the levels and
    rows no corner reaches are not read), never more than the tensor."""
    import chip_smoke as cs

    shapes, B, H, D, P = ((6, 9), (4, 5)), 2, 3, 8, 4
    S = sum(h * w for h, w in shapes) + 3
    locs = (lo + (hi - lo) * rng.random((B, Q, H, 2, P, 2))).astype(F32)
    locs[:, -1] = -10.0
    locs[0, 0, 0, 0, 0, 0] = np.nan
    value = torch.zeros((B, S, H, D), dtype=dtype)
    got = cs.value_bytes_read(value, torch.from_numpy(locs), shapes)
    assert got == _rows_read_by_a_loop(locs, shapes, D, value.element_size())
    assert 0 < got < value.numel() * value.element_size()
