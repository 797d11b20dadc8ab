"""The pair's d_value on its slab route (`ops/deform_attn_cuda.py:
MSDeformAttnDValueSlab`, `csrc/ms_deform_attn_bwd.cu:
ms_deform_attn_dvalue_slab_kernel`), on the CPU.

* the route rule (`plan_dvalue`) at the path shapes: the flagship decoder
  (the slab route) and encoder, the YOLO pyramid (the scatter); never over
  the 232 448 B a block may opt into;
* a numpy model of the kernel's partition (a block per (b, h, channel
  group), its G-lane groups walking the pair's sampling points, the
  rotated channel order of the shared adds, the 16-byte or scalar stores),
  run with the kernel's own block size and groups: every in-map corner
  added exactly once per channel, every d_value row written once (pad rows
  included), held against the gradient of JAX's `ms_deform_attn_xla`;
* the channel stagger at the rule's group: at most two lanes of a warp on a
  bank;
* what the wrapper refuses, the pair's dispatch by the rule, the
  profiler's name for the kernel and chip_smoke's launch plan.

The kernel itself runs only on the card (chip_smoke.py phases 6, 18, 20).
"""

import numpy as np
import pytest
import torch

from poet_tpu_torch.ops import deform_attn_cuda as dac
from tests.test_torch_deform_attn_slab import (
    CASES,
    FLAGSHIP,
    YOLO,
    _case,
    _close,
    _corners,
    _footprint,
    _group_lanes,
    _xla,
)
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

BUDGET = 232448
BF16_RTOL = 2.0 ** -8               # one bf16 rounding of the written d_value


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rule_at_the_flagship_decoder_and_encoder(dtype):
    """S=1600, D=16: the decoder (Q=10, 0.4 corner adds per token) takes one
    16-channel slab per (b, h), 102 400 B, with 320 threads for its 160
    points x 2 lanes; the encoder (Q=1600, 64 per token) the scatter, whose
    L2 atomics outran the shared adds there; the slab's block is the same
    either way."""
    assert dac.plan_dvalue(1600, 16, dtype, 10, 4, 4) == ("slab", 16, 320, 102400)
    assert dac.plan_dvalue(1600, 16, dtype, 1600, 4, 4) == ("atomic", 0, 0, 0)
    assert dac.dvalue_slab_shape(1600, 16, 1600, 4, 4) == ("slab", 16, 512, 102400)
    assert dac.plan_dvalue(1600, 16, dtype, 400, 4, 4).route == "slab"     # 16 per token
    assert dac.plan_dvalue(1600, 16, dtype, 800, 4, 4).route == "atomic"   # 32 per token


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rule_keeps_the_scatter_at_the_yolo_pyramid(dtype):
    """S=6380: the 16-channel slab (408 320 B) does not fit, at the decoder
    either; an 8-channel one would (204 160 B) but measured slower than the
    scatter, so the rule splits no further."""
    assert 6380 * 8 * 4 == 204160 <= BUDGET < 6380 * 16 * 4
    for Q in (10, 6380):
        assert dac.plan_dvalue(6380, 16, dtype, Q, 4, 4) == ("atomic", 0, 0, 0)


@pytest.mark.parametrize("D", [6, 8, 12, 16, 24, 32])
def test_plan_never_exceeds_the_budget(D):
    """Over S and Q: the group is the largest divisor of D up to 16, the
    threads a warp multiple from 128 to 512, and the rule takes the slab
    route exactly where that slab fits and each token takes at most 16
    corner adds."""
    for S in (11, 100, 1600, 3632, 3633, 6380, 14530, 58112, 58113):
        for Q in (1, 10, 100, 400, S):
            plan = dac.plan_dvalue(S, D, torch.bfloat16, Q, 4, 4)
            shape = dac.dvalue_slab_shape(S, D, Q, 4, 4)
            group = max(g for g in range(1, min(D, 16) + 1) if D % g == 0)
            assert shape.group == group and shape.smem_bytes == S * group * 4
            assert shape.threads % 32 == 0 and 128 <= shape.threads <= 512
            fits = S * group * 4 <= BUDGET and 4 * 4 * 4 * Q / S <= 16
            assert plan == (shape if fits else ("atomic", 0, 0, 0))
            assert plan.smem_bytes <= BUDGET


# ------------------------------------------------------------------ model

def _vec_of(group):
    """The wrapper's channels per lane (aligned pointers)."""
    return next(n for n in (8, 4, 1) if group % n == 0)


def dvalue_slab_model(S, shapes, locs, attn, dout, group, threads, itemsize=4):
    """The d_value slab kernel's partition in numpy (float64 sums), block by
    block (b, h, channel group gi): G lanes per group (lane r owns channel
    slice r, VEC channels; lanes r >= group / VEC idle), group i walking the
    point-major items it = k Q + q of its run [i run, (i + 1) run), run =
    ceil(Q L P / (threads / G)). A lane keeps at most four pending tokens:
    before a point's corners it flushes (adds into the (S, group) slab) each
    pending token the point does not touch; each in-map corner of non-zero
    weight then adds w * dout into its token's pending sum or a free entry;
    the rest is flushed at the end. Then the 16-byte (or scalar) stores of
    `itemsize`-byte values write the slab out. Returns d_value, the count of
    contributions per (b, q, h, k, corner, channel), of writes per (b, s, h,
    channel), and the slab adds and contributions in all."""
    B, Q, H, L, P, _ = locs.shape
    D = dout.shape[-1] // H
    LP = L * P
    VEC = _vec_of(group)
    chunks = group // VEC
    G = _group_lanes(chunks)
    run = -(-Q * LP // (threads // G))
    starts = np.cumsum([0] + [h * w for h, w in shapes])
    d_value = np.full((B, S, H, D), np.nan)
    adds = np.zeros((B, Q, H, LP, 4, D), np.int64)
    writes = np.zeros((B, S, H, D), np.int64)
    flushes = contributions = 0
    for b, h, gi in np.ndindex(B, H, D // group):
        acc = np.zeros((S, group))
        for tid in range(threads):
            r = tid % G
            if r >= chunks:
                continue
            ch = slice(r * VEC, (r + 1) * VEC)
            pending = {}                             # token -> its pending sum
            for it in range(tid // G * run, min((tid // G + 1) * run, Q * LP)):
                k, q = divmod(it, Q)
                l = k // P
                hl, wl = shapes[l]
                f = _footprint(*locs[b, q, h, l, k % P], hl, wl)
                if f is None:
                    continue
                g = dout[b, q, h * D + gi * group:h * D + (gi + 1) * group].astype(np.float64)
                corners = [(cc, starts[l] + t, w) for cc, t, w in
                           _corners(f, wl, float(attn[b, q, h, l, k % P])) if w != 0]
                for tok in [t for t in pending if t not in {c[1] for c in corners}]:
                    acc[tok, ch] += pending.pop(tok)
                    flushes += 1
                for cc, tok, w in corners:
                    pending[tok] = pending.get(tok, 0.0) + w * g[ch]
                    adds[b, q, h, k, cc, gi * group + r * VEC:gi * group + (r + 1) * VEC] += 1
                    contributions += 1
                assert len(pending) <= 4                 # the kernel's four entries
            for tok, v in pending.items():
                acc[tok, ch] += v
                flushes += 1
        E = 16 // itemsize
        if group % E == 0 and (D * itemsize) % 16 == 0:     # store16
            per = group // E
            for i in range(S * per):
                t, p = divmod(i, per)
                c0 = gi * group + p * E
                d_value[b, t, h, c0:c0 + E] = acc[t, p * E:(p + 1) * E]
                writes[b, t, h, c0:c0 + E] += 1
        else:
            for i in range(S * group):
                t, c = divmod(i, group)
                d_value[b, t, h, gi * group + c] = acc[t, c]
                writes[b, t, h, gi * group + c] += 1
    return d_value, adds, writes, (flushes, contributions)


def _want_adds(locs, attn, shapes, D):
    """1 for every in-map corner of non-zero weight, every channel."""
    want = np.zeros(locs.shape[:3] + (locs.shape[3] * locs.shape[4], 4, D), np.int64)
    P = locs.shape[4]
    for b, q, h, l, p in np.ndindex(*locs.shape[:-1]):
        f = _footprint(*locs[b, q, h, l, p], *shapes[l])
        for cc, _, w in ([] if f is None else _corners(f, shapes[l][1],
                                                        float(attn[b, q, h, l, p]))):
            want[b, q, h, l * P + p, cc, :] = w != 0
    return want


def _plan_group(S, D, Q, L, P, split):
    """The slab block's (group, threads), or with `split` half its group."""
    shape = dac.dvalue_slab_shape(S, D, Q, L, P)
    return (shape.group // 2 if split else shape.group), shape.threads


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("split", [False, True])
def test_slab_partition_adds_each_corner_once_and_matches_jax(rng, case, nan, itemsize, split):
    """f32 and bf16 stores (itemsize 4, 2), the rule's channel group and half
    of it (two blocks per head): the partition and the arithmetic in
    float64, against the f32 gradient of the same (f32) values; a bf16
    d_value within one bf16 rounding."""
    value, shapes, locs, w, dout = _case(rng, case, nan)
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = locs.shape
    group, threads = _plan_group(S, D, Q, L, P, split)
    d_value, adds, writes, _ = dvalue_slab_model(S, shapes, locs, w, dout, group, threads,
                                                 itemsize)
    np.testing.assert_array_equal(adds, _want_adds(locs, w, shapes, D))
    assert (writes == 1).all()                       # every row, the pad rows too
    S_lv = sum(h * wd for h, wd in shapes)
    assert (d_value[:, S_lv:] == 0).all()
    _, ref = _xla(value, shapes, locs, w, dout)
    if itemsize == 2:
        got = torch.from_numpy(d_value).bfloat16().double().numpy()
        scale = max(float(np.abs(ref[0]).max()), 1e-30)
        assert (np.abs(got - ref[0]) <= 1e-5 * scale + BF16_RTOL * np.abs(ref[0])).all()
    else:
        _close(d_value, ref[0], "d_value")


def test_points_on_cell_edges_skip_their_zero_weight_corners(rng):
    """Every point on a pixel centre of its level (tx = ty = 0, as the grid
    initialisation puts the encoder's points): one corner of weight a, three
    of weight 0, which add nothing; d_value as JAX's gradient."""
    value, shapes, locs, w, dout = _case(rng, "D16")
    for l, (h, wd) in enumerate(shapes):
        px = rng.integers(0, wd, size=locs.shape[:3] + (locs.shape[4],))
        py = rng.integers(0, h, size=locs.shape[:3] + (locs.shape[4],))
        locs[..., l, :, 0] = (px + 0.5) / wd
        locs[..., l, :, 1] = (py + 0.5) / h
    S, D = value.shape[1], value.shape[3]
    _, Q, _, L, P, _ = locs.shape
    group, threads = _plan_group(S, D, Q, L, P, False)
    d_value, adds, writes, _ = dvalue_slab_model(S, shapes, locs, w, dout, group, threads)
    want = _want_adds(locs, w, shapes, D)
    assert (want.sum(4) == 1).all()                 # one corner of four per point
    np.testing.assert_array_equal(adds, want)
    assert (writes == 1).all()
    _, ref = _xla(value, shapes, locs, w, dout)
    _close(d_value, ref[0], "d_value")


def _grid_locations(rng, B, H, shapes, P, noise_px=0.25):
    """chip_smoke.grid_locations in numpy: each query at its own token's
    pixel centre, head h's points 1..P pixels along 2 pi h / H on every
    level, plus noise."""
    ref = np.concatenate([np.stack(np.meshgrid((np.arange(w) + 0.5) / w,
                                               (np.arange(h) + 0.5) / h), -1).reshape(-1, 2)
                          for h, w in shapes])
    theta = np.arange(H) * 2 * np.pi / H
    d = np.stack([np.cos(theta), np.sin(theta)], -1)
    d /= np.abs(d).max(-1, keepdims=True)
    off = d[:, None, :] * np.arange(1, P + 1)[None, :, None]
    wh = np.array([[w, h] for h, w in shapes], np.float64)
    noise = noise_px * rng.normal(size=(B, len(ref), H, len(shapes), P, 2))
    return (ref[None, :, None, None, None] + (off[None, None, :, None] + noise)
            / wh[:, None]).astype(np.float32)


@pytest.mark.parametrize("kind", ["grid", "uniform"])
def test_pending_sums_merge_where_neighbouring_queries_share_tokens(rng, kind):
    """At a model's sampling locations (each query at its pixel centre, the
    grid initialisation's offsets) a lane's successive points share corners
    and a third or more of the contributions merge in registers before a
    slab add; at uniform random locations few do (on these small levels
    about a tenth). d_value matches
    JAX's gradient either way (64 threads: runs of 7 points)."""
    value, shapes, locs, w, dout = _case(rng, "D16")
    B, S, H, D = value.shape
    if kind == "grid":
        locs = _grid_locations(rng, B, H, shapes, locs.shape[4])
        w = w[:, :1].repeat(S, 1)
        dout = rng.normal(size=(B, S, H * D)).astype(np.float32)
    d_value, _, writes, (flushes, contributions) = dvalue_slab_model(S, shapes, locs, w, dout,
                                                                     16, 64)
    assert (writes == 1).all()
    if kind == "grid":
        assert flushes <= 0.67 * contributions
    else:
        assert flushes >= 0.85 * contributions
    _, ref = _xla(value, shapes, locs, w, dout)
    _close(d_value, ref[0], "d_value")


def test_nan_point_adds_nothing(rng):
    """A NaN sampling point gives the d_value of the same point off the map
    (the -10 fill): it adds nothing."""
    value, shapes, locs, w, dout = _case(rng, "D16", nan=True)
    S, D = value.shape[1], value.shape[3]
    _, Q, _, L, P, _ = locs.shape
    group, threads = _plan_group(S, D, Q, L, P, False)
    got = dvalue_slab_model(S, shapes, locs, w, dout, group, threads)[0]
    off = np.where(np.isnan(locs), np.float32(-10.0), locs)
    want = dvalue_slab_model(S, shapes, off, w, dout, group, threads)[0]
    np.testing.assert_array_equal(got, want)


def _bank_loads(D_group, VEC, G, tokens):
    """Per step j of slab_add, the most lanes of a warp on one bank: lane
    (s, c) of group s adds channel c VEC + (j + rot) % VEC, rot = s % VEC,
    of token tokens[s] in an (S, D_group) f32 slab."""
    worst = 0
    for j in range(VEC):
        banks = []
        for lane in range(32):
            s, c = divmod(lane, G)
            ch = c * VEC + (j + (s & (VEC - 1))) % VEC
            banks.append((tokens[s] * D_group + ch) % 32)
        worst = max(worst, int(np.bincount(banks).max()))
    return worst


def test_stagger_puts_at_most_two_lanes_on_a_bank_at_the_rule_group(rng):
    """The rule's flagship group (16 channels, 8 a lane, G=2: 16 points a
    warp) puts at most two lanes on a bank whatever tokens the points add
    into; the 8-channel split the rule refuses (G=1, 32 points a warp) can
    put four, and does."""
    group, _ = _plan_group(1600, 16, 1600, 4, 4, False)
    assert (group, _vec_of(group)) == (16, 8)
    assert max(_bank_loads(16, 8, 2, rng.integers(0, 1600, size=16))
               for _ in range(300)) <= 2
    split = [_bank_loads(8, 8, 1, rng.integers(0, 6380, size=32)) for _ in range(300)]
    assert max(split) <= 4 and max(split) >= 3


# ---------------------------------------------------------------- wrappers

@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_slab_wrapper_refuses_cpu_tensors(device):
    k = dac.MS_DEFORM_ATTN_DVALUE_SLAB
    before = k.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        k(torch.zeros((2, 16, 2, 8), device=device), ((3, 4), (2, 2)),
          torch.zeros((2, 5, 2, 2, 4, 2), device=device), torch.zeros((2, 5, 2, 2, 4),
                                                                       device=device),
          torch.zeros((2, 5, 16), device=device))
    assert k.launches == before
    assert dac.BWD_LIB._lib is None


@pytest.mark.parametrize("Q, levels, want", [
    (10, FLAGSHIP, ("slab", 16, 320)),
    (1600, FLAGSHIP, ("atomic",)),
    (6380, YOLO, ("atomic",)),
])
def test_pair_dispatches_d_value_by_the_rule(monkeypatch, Q, levels, want):
    """`dvalue_adjoint` picks the rule's wrapper and passes its group and
    threads (meta tensors at the path shapes, B=16, H=16, D=16, L=P=4; the
    wrappers replaced by recorders)."""
    S = sum(h * w for h, w in levels)
    value = torch.empty((16, S, 16, 16), dtype=torch.bfloat16, device="meta")
    locs = torch.empty((16, Q, 16, 4, 4, 2), device="meta")
    calls = []
    monkeypatch.setattr(dac, "MS_DEFORM_ATTN_DVALUE_SLAB",
                        lambda *a: calls.append(("slab",) + a[5:]))
    monkeypatch.setattr(dac, "MS_DEFORM_ATTN_DVALUE", lambda *a: calls.append(("atomic",)))
    dac.dvalue_adjoint(value, levels, locs, None, None)
    assert calls == [want]


def test_train_profiler_names_the_d_value_slab_kernel():
    from poet_tpu_torch.tools.profile_train import kernel_class

    assert kernel_class("void (anonymous namespace)::ms_deform_attn_dvalue_slab_kernel"
                        "<__nv_bfloat16, 8>") == "d_value kernel (slab)"
    assert kernel_class("void (anonymous namespace)::ms_deform_attn_dvalue_kernel"
                        "<__nv_bfloat16, 4>") == "d_value kernel"


def test_chip_smoke_pair_launch_plan_follows_the_rule():
    """The pair's train step: d_value on the scatter in the encoder and on
    the slab route in the decoder at the flagship pyramid (S=1600), on the
    scatter in both at the YOLO pyramid's S=6380 (d_loc by plan_dloc: the
    slab route in each encoder, the direct route in each decoder)."""
    import chip_smoke as cs
    from poet_tpu_torch.flagship import flagship_config

    cfg = flagship_config("bfloat16")
    cfg.model.merged_adjoint = False
    assert cs.path_launches(cfg, 1600, 2, train=True) == {
        "fwd_slab": 10, "fwd": 10, "d_value": 10, "d_value_slab": 10, "d_loc_slab": 10,
        "d_loc": 10}
    assert cs.path_launches(cfg, 6380, 1, train=True) == {
        "fwd_slab": 5, "fwd": 5, "d_value": 10, "d_loc_slab": 5, "d_loc": 5}
