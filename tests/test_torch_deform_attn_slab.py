"""The slab routes of the gather kernels: kernel 1's slab forward and the
merged adjoint's slab route (`ops/deform_attn_cuda.py`), on the CPU.

* the route rule (`plan_forward`, `plan_merged`) and its shared-memory plan
  at the path shapes: the flagship encoder and decoder, the YOLO pyramid;
  never over the 232 448 B a block may opt into;
* numpy models of the two slab kernels' partitions (a block per (b, h), its
  G-lane groups walking the sampling points, the forward's threads walking
  (query, channel slice) items, the staging and the 16-byte d_value
  stores), run with the kernels' own block size: every in-map corner added
  exactly once per channel, every d_value row written once (pad rows
  included), and the results held against JAX's `ms_deform_attn_xla` and
  its gradient;
* the merged slab route's channel stagger: at most two lanes of a warp on a
  bank;
* what the wrappers refuse, the entry's dispatch by the rule, the train
  profiler's names for the new kernels and chip_smoke's launch plan.

The kernels themselves run only on the card (chip_smoke.py phases 3, 18).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poet_tpu.ops.deform_attn import ms_deform_attn_xla
from poet_tpu_torch.ops import deform_attn_cuda as dac
from tests.test_deform_attn import _make_inputs
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-5                        # as tests/test_torch_deform_attn_grad.py
FLAGSHIP = ((30, 40), (15, 20), (8, 10), (4, 5))
YOLO = ((60, 80), (30, 40), (15, 20), (8, 10))
BUDGET = 232448
MERGED_THREADS, FWD_THREADS = 1024, 512      # kMergedSlabThreads, kSlabThreads


@pytest.mark.parametrize("dtype, fwd_bytes, merged_bytes", [
    (torch.bfloat16, 51200, 153600), (torch.float32, 102400, 204800)])
def test_rule_takes_the_slabs_at_the_flagship_encoder(dtype, fwd_bytes, merged_bytes):
    """B=16, Q=S=1600, H=16, D=16, L=P=4: both slab routes, the value slab
    staged; the shared memory of the issue's table."""
    assert dac.corner_reads_per_token(1600, 1600, 4, 4) == 64.0
    assert dac.plan_forward(1600, 16, dtype, 1600, 4, 4) == ("slab", True, fwd_bytes)
    assert dac.plan_merged(1600, 16, dtype, 1600, 4, 4) == ("slab", True, merged_bytes)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rule_keeps_the_direct_gathers_at_the_decoder(dtype):
    """Q=10 over S=1600 tokens (0.4 reads per token): the forward's direct
    gathers; the merged adjoint's slab route with value read from device
    memory (the f32 d_value slab alone)."""
    assert dac.plan_forward(1600, 16, dtype, 10, 4, 4) == ("direct", False, 0)
    assert dac.plan_merged(1600, 16, dtype, 10, 4, 4) == ("slab", False, 102400)


def test_rule_at_the_yolo_pyramid():
    """S=6380: the bf16 value slab fits (204 160 B), the f32 one does not;
    the f32 d_value slab (408 320 B) never does: the merged adjoint takes the
    atomic route."""
    assert dac.plan_forward(6380, 16, torch.bfloat16, 6380, 4, 4) == ("slab", True, 204160)
    assert dac.plan_forward(6380, 16, torch.float32, 6380, 4, 4) == ("direct", False, 0)
    assert dac.plan_forward(6380, 16, torch.bfloat16, 10, 4, 4).route == "direct"
    for dtype in (torch.bfloat16, torch.float32):
        assert dac.merged_slab_bytes(6380, 16, dtype, False) == 408320
        assert dac.plan_merged(6380, 16, dtype, 6380, 4, 4) == ("atomic", False, 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [6, 8, 16, 32])
def test_plan_never_exceeds_the_budget(dtype, D):
    """Over S and Q: a slab route's shared memory fits the budget, and the
    rule leaves a slab route only where its slab does not fit (or, for the
    value slab, where too few reads per token would pay for staging)."""
    size = torch.finfo(dtype).bits // 8
    for S in (11, 100, 1600, 3000, 3632, 3633, 6380, 7264, 7265, 14530):
        for Q in (1, 10, 100, S):
            fwd = dac.plan_forward(S, D, dtype, Q, 4, 4)
            merged = dac.plan_merged(S, D, dtype, Q, 4, 4)
            reads = dac.corner_reads_per_token(S, Q, 4, 4)
            assert fwd.smem_bytes <= BUDGET and merged.smem_bytes <= BUDGET
            assert (fwd.route == "slab") == (S * D * size <= BUDGET and reads >= 8)
            assert (merged.route == "slab") == (S * D * 4 <= BUDGET)
            staged = -(-S * D * 4 // 16) * 16 + S * D * size
            assert merged.stage == (merged.route == "slab" and staged <= BUDGET and reads >= 8)


# ------------------------------------------------------------------ models

def _nonfinite(lx, ly, h, w):
    """The header's Point::NONFINITE: a NaN or infinite pixel coordinate."""
    x = np.float32(lx) * np.float32(w) - np.float32(0.5)
    y = np.float32(ly) * np.float32(h) - np.float32(0.5)
    return not (np.isfinite(x) and np.isfinite(y))


def _footprint(lx, ly, h, w):
    """The header's footprint in float32 (deform_point::footprint): None off
    the map or for a non-finite coordinate, else (t00, tx, ty, in_x0, in_x1,
    in_y0, in_y1)."""
    x = np.float32(lx) * np.float32(w) - np.float32(0.5)
    y = np.float32(ly) * np.float32(h) - np.float32(0.5)
    if not (x > -1 and x < w and y > -1 and y < h):
        return None
    x0, y0 = int(np.floor(x)), int(np.floor(y))
    return (y0 * w + x0, float(x - np.floor(x)), float(y - np.floor(y)),
            x0 >= 0, x0 + 1 < w, y0 >= 0, y0 + 1 < h)


def _corners(f, w, a):
    """for_each_corner: (corner, token in the level, weight) of the in-map
    corners, in the header's order."""
    t00, tx, ty, ix0, ix1, iy0, iy1 = f
    wy0, wy1 = (1 - ty) * a, ty * a
    out = []
    if iy0:
        out += [(0, t00, (1 - tx) * wy0)] * ix0 + [(1, t00 + 1, tx * wy0)] * ix1
    if iy1:
        out += [(2, t00 + w, (1 - tx) * wy1)] * ix0 + [(3, t00 + w + 1, tx * wy1)] * ix1
    return out


def _group_lanes(chunks):
    G = 1
    while G < chunks and G < 32:
        G <<= 1
    return G


def _vec_of(D):
    """The merged slab wrapper's channels per lane (aligned pointers)."""
    return next(n for n in (8, 4, 1) if D % n == 0)


def merged_slab_model(value, shapes, locs, attn, dout, itemsize=4, threads=MERGED_THREADS):
    """The merged slab kernel's partition in numpy (float64 sums), block by
    block: lane r of group it // ... walks items it = tid // G, + threads // G,
    ... < Q L P (query q = it // LP, point k = it % LP) and channel slices c
    = r, r + G, ... < D / VEC; each in-map corner adds w * dout to the
    (S, D) slab channel by channel in the staggered order; then the 16-byte
    (or scalar) stores of `itemsize`-byte values write the slab out.
    Returns the three gradients, the
    count of adds per (b, q, h, k, corner, channel) and of writes per
    (b, s, h, channel)."""
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = locs.shape
    LP = L * P
    VEC = _vec_of(D)
    chunks = D // VEC
    G = _group_lanes(chunks)
    starts = np.cumsum([0] + [h * w for h, w in shapes])
    d_value = np.zeros((B, S, H, D))
    d_loc = np.full(locs.shape, np.nan)
    d_attn = np.full(attn.shape, np.nan)
    adds = np.zeros((B, Q, H, LP, 4, D), np.int64)
    writes = np.zeros((B, S, H, D), np.int64)
    for b in range(B):
        for h in range(H):
            acc = np.zeros((S, D))
            for tid in range(threads):
                r = tid % G
                rot = ((tid & 31) // G) & (VEC - 1)
                for it in range(tid // G, Q * LP, threads // G):
                    q, k = divmod(it, LP)
                    l = k // P
                    hl, wl = shapes[l]
                    f = _footprint(*locs[b, q, h, l, k % P], hl, wl)
                    if f is None:
                        if r == 0:       # miss_grads: 0 off the map, NaN (C1)
                            g0 = np.nan if _nonfinite(*locs[b, q, h, l, k % P], hl, wl) else 0.0
                            d_loc[b, q, h, l, k % P] = g0
                            d_attn[b, q, h, l, k % P] = g0
                        continue
                    a = float(attn[b, q, h, l, k % P])
                    g = dout[b, q, h * D:(h + 1) * D].astype(np.float64)
                    for c in range(r, chunks, G):
                        for cc, t, w in _corners(f, wl, a):
                            tok = starts[l] + t
                            for j in range(VEC):        # slab_add: channel (j + rot) % VEC
                                cj = c * VEC + (j + rot) % VEC
                                acc[tok, cj] += w * g[cj]
                                adds[b, q, h, k, cc, cj] += 1
                    if r == 0:   # e over the group's slices (its shuffles); point_grads
                        e = np.zeros(4)
                        for cc, t, _ in _corners(f, wl, a):
                            e[cc] = g @ value[b, starts[l] + t, h]
                        _, tx, ty = f[:3]
                        d_attn[b, q, h, l, k % P] = ((1 - ty) * ((1 - tx) * e[0] + tx * e[1])
                                                     + ty * ((1 - tx) * e[2] + tx * e[3]))
                        d_loc[b, q, h, l, k % P] = (
                            a * wl * ((1 - ty) * (e[1] - e[0]) + ty * (e[3] - e[2])),
                            a * hl * ((1 - tx) * (e[2] - e[0]) + tx * (e[3] - e[1])))
            # the write-out: 16-byte stores of E values where D allows
            E = 16 // itemsize
            if D % E == 0:
                per = D // E
                for i in range(S * per):
                    t, k = divmod(i, per)
                    assert i * E == t * D + k * E        # acc + i * E is token t's slice
                    d_value[b, t, h, k * E:(k + 1) * E] = acc[t, k * E:(k + 1) * E]
                    writes[b, t, h, k * E:(k + 1) * E] += 1
            else:
                for i in range(S * D):
                    t, ch = divmod(i, D)
                    d_value[b, t, h, ch] = acc[t, ch]
                    writes[b, t, h, ch] += 1
    return d_value, d_loc, d_attn, adds, writes


def fwd_slab_model(value, shapes, locs, attn, itemsize=4, threads=FWD_THREADS):
    """The forward slab kernel's partition in numpy: per (b, h) block, thread
    tid walks items i = tid, + threads, ... < Q * chunks (q = i // chunks, c =
    i % chunks; a slice of 16 bytes of `itemsize`-byte values where D allows)
    and sums its slice over the points from the slab. Returns the output and
    the count of writes per (b, q, h, channel)."""
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = locs.shape
    VEC = 16 // itemsize if D % (16 // itemsize) == 0 else 1
    chunks = D // VEC
    starts = np.cumsum([0] + [h * w for h, w in shapes])
    out = np.zeros((B, Q, H, D))
    writes = np.zeros((B, Q, H, D), np.int64)
    for b in range(B):
        for h in range(H):
            slab = value[b, :, h].astype(np.float64)          # staged densely: (S, D)
            for tid in range(threads):
                for i in range(tid, Q * chunks, threads):
                    q, c = divmod(i, chunks)
                    ch = c * VEC + np.arange(VEC)
                    acc = np.zeros(VEC)
                    nonfinite = False
                    for l, (hl, wl) in enumerate(shapes):
                        for p in range(P):
                            f = _footprint(*locs[b, q, h, l, p], hl, wl)
                            if f is None:
                                nonfinite |= _nonfinite(*locs[b, q, h, l, p], hl, wl)
                                continue
                            for _, t, w in _corners(f, wl, float(attn[b, q, h, l, p])):
                                acc += w * slab[starts[l] + t, ch]
                    out[b, q, h, ch] = np.nan if nonfinite else acc      # C1: a NaN row
                    writes[b, q, h, ch] += 1
    return out.reshape(B, Q, H * D), writes


# (levels, B, Q, H, D, loc spread, trailing pad tokens); D=16: 8 channels a
# lane (G=2), D=12: 4 (G=4, one lane idle), D=6: scalar (G=8, two idle)
CASES = {
    "D16": (((6, 9), (4, 5), (2, 3)), 2, 9, 2, 16, 1.0, 0),
    "D12 pad tokens": (((5, 7), (3, 4)), 1, 7, 3, 12, 1.0, 5),
    "D6 edge levels": (((1, 7), (3, 1), (1, 1)), 2, 5, 2, 6, 1.0, 0),
    "far out of map": (((6, 9), (4, 5)), 1, 9, 2, 8, 8.0, 0),
}


def _case(rng, name, nan=False):
    shapes, B, Q, H, D, spread, pad = CASES[name]
    value, shapes, locs, w = _make_inputs(rng, B=B, Q=Q, H=H, D=D, shapes=shapes)
    locs = ((locs - 0.5) * spread + 0.5).astype(np.float32)
    locs[:, -1] = -10.0                              # the dummy-query conventions
    locs[:, -2] = -1.0
    if pad:
        value = np.concatenate([value, rng.normal(size=(B, pad, H, D)).astype(np.float32)], 1)
    if nan:
        locs[:, 0, :, 0, 1, 0] = np.nan
        locs[0, 1, 0, -1, 2, :] = np.nan
    dout = rng.normal(size=(B, Q, H * D)).astype(np.float32)
    return value, shapes, locs, w, dout


def _xla(value, shapes, locs, w, dout):
    """ms_deform_attn_xla and its gradient under the C1 rule: NaN points
    replaced by the -10 fill (the point adds nothing; JAX's own d_value and
    d_loc there hang on its float-to-int cast of NaN), then the rule's NaNs
    put back: the point's output row, d_attn and both d_loc coordinates."""
    bad = np.isnan(locs).any(-1)                     # (B, Q, H, L, P)
    locs = np.where(np.isnan(locs), np.float32(-10.0), locs)

    def f(v, l, a):
        return jnp.sum(ms_deform_attn_xla(v, shapes, l, a) * dout)

    out = np.asarray(ms_deform_attn_xla(jnp.asarray(value), shapes, jnp.asarray(locs),
                                        jnp.asarray(w)))
    grads = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(value), jnp.asarray(locs),
                                           jnp.asarray(w))
    d_value, d_loc, d_attn = (np.array(g) for g in grads)
    B, Q, H = bad.shape[:3]
    out = np.where(bad.reshape(B, Q, H, -1).any(-1)[..., None], np.nan,
                   out.reshape(B, Q, H, -1)).reshape(B, Q, -1)
    return out, [d_value, np.where(bad[..., None], np.nan, d_loc), np.where(bad, np.nan, d_attn)]


def _close(got, ref, name):
    """Within RTOL of ref's scale, NaN exactly where ref has NaN."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=name)
    scale = max(float(np.nanmax(np.abs(ref))), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * scale, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_merged_slab_partition_adds_each_corner_once_and_matches_jax(rng, case, nan, itemsize):
    """f32 and bf16 stores (itemsize 4, 2): the partition and the arithmetic
    in float64, against the f32 gradient of the same (f32) values."""
    value, shapes, locs, w, dout = _case(rng, case, nan)
    d_value, d_loc, d_attn, adds, writes = merged_slab_model(value, shapes, locs, w, dout,
                                                             itemsize)
    B, S, H, D = value.shape
    S_lv = sum(h * wd for h, wd in shapes)
    # every in-map corner of every point, channel by channel, exactly once
    want = np.zeros_like(adds)
    for b, q, h, l, p in np.ndindex(*locs.shape[:-1]):
        f = _footprint(*locs[b, q, h, l, p], *shapes[l])
        for cc, _, _ in ([] if f is None else _corners(f, shapes[l][1], 1.0)):
            want[b, q, h, l * locs.shape[4] + p, cc, :] = 1
    np.testing.assert_array_equal(adds, want)
    assert (writes == 1).all()                      # every row, the pad rows too
    assert (d_value[:, S_lv:] == 0).all()
    assert (d_loc[:, -2:] == 0).all() and (d_attn[:, -2:] == 0).all()
    if nan:      # C1: NaN in d_attn and both d_loc coordinates
        assert np.isnan(d_loc[:, 0, :, 0, 1]).all() and np.isnan(d_attn[:, 0, :, 0, 1]).all()
    _, ref = _xla(value, shapes, locs, w, dout)
    for got, r, name in zip((d_value, d_loc, d_attn), ref, ("d_value", "d_loc", "d_attn")):
        _close(got, r, name)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("itemsize", [4, 2])
def test_fwd_slab_partition_writes_each_output_once_and_matches_jax(rng, case, itemsize):
    """f32 and bf16 slabs (itemsize 4: 4 channels a thread, 2: 8) on the
    same values, bf16-rounded for the bf16 case."""
    value, shapes, locs, w, _ = _case(rng, case, nan=True)
    if itemsize == 2:
        value = torch.from_numpy(value).bfloat16().float().numpy()
    out, writes = fwd_slab_model(value, shapes, locs, w, itemsize)
    assert (writes == 1).all()
    ref, _ = _xla(value, shapes, locs, w, np.zeros((1,), np.float32))
    _close(out, ref, "out")


@pytest.mark.parametrize("S, D, itemsize", [(1600, 16, 2), (1600, 16, 4), (47, 8, 4),
                                            (6380, 16, 2), (47, 8, 2)])
def test_staging_covers_the_slab_once(S, D, itemsize):
    """stage_slab's 16-byte chunks (i -> token i // per, chunk i % per; where
    D * itemsize is a multiple of 16, else element by element) land densely,
    each byte of the slab once."""
    per = D * itemsize // 16
    dst = np.zeros(S * D * itemsize, np.int64)
    for i in range(S * per):
        t, k = divmod(i, per)
        src_byte = t * D * itemsize + k * 16            # the dense slab's token t
        assert i * 16 == src_byte
        dst[i * 16:(i + 1) * 16] += 1
    assert (dst == 1).all()


def test_merged_slab_stagger_puts_at_most_two_lanes_on_a_bank(rng):
    """D=16 f32 tokens (16 of the 32 banks each), 8 channels per lane, G=2:
    at every step j of slab_add a warp's 32 lanes put at most two lanes on a
    bank, whatever tokens its 16 groups add into; without the rotation they
    meet on 2 G = 4 banks, 8 lanes or more to the busiest."""
    D, VEC, G = 16, 8, 2
    for stagger in (True, False):
        for _ in range(200):
            tokens = rng.integers(0, 1600, size=32 // G)
            for j in range(VEC):
                banks = []
                for lane in range(32):
                    s, c = divmod(lane, G)
                    rot = s & (VEC - 1) if stagger else 0
                    ch = c * VEC + (j + rot) % VEC
                    banks.append((tokens[s] * D + ch) % 32)
                if stagger:
                    assert np.bincount(banks).max() <= 2
                else:
                    assert len(set(banks)) <= 2 * G and np.bincount(banks).max() >= 8


# ---------------------------------------------------------------- wrappers

@pytest.mark.parametrize("kernel", ["MS_DEFORM_ATTN_FWD_SLAB", "MS_DEFORM_ATTN_MERGED_SLAB"])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_slab_wrappers_refuse_cpu_tensors(kernel, device):
    k = getattr(dac, kernel)
    before = k.launches
    args = [torch.zeros((2, 16, 2, 8), device=device), ((3, 4), (2, 2)),
            torch.zeros((2, 5, 2, 2, 4, 2), device=device),
            torch.zeros((2, 5, 2, 2, 4), device=device)]
    if kernel == "MS_DEFORM_ATTN_MERGED_SLAB":
        args.append(torch.zeros((2, 5, 16), device=device))
    with pytest.raises(ValueError, match="CUDA tensors"):
        k(*args)
    assert k.launches == before
    assert dac.FWD_LIB._lib is None and dac.BWD_LIB._lib is None


@pytest.mark.parametrize("Q, levels, dtype, fwd, merged", [
    (1600, FLAGSHIP, torch.bfloat16, "MS_DEFORM_ATTN_FWD_SLAB", ("slab", True)),
    (1600, FLAGSHIP, torch.float32, "MS_DEFORM_ATTN_FWD_SLAB", ("slab", True)),
    (10, FLAGSHIP, torch.bfloat16, "MS_DEFORM_ATTN_FWD", ("slab", False)),
    (6380, YOLO, torch.bfloat16, "MS_DEFORM_ATTN_FWD_SLAB", ("atomic", None)),
    (6380, YOLO, torch.float32, "MS_DEFORM_ATTN_FWD", ("atomic", None)),
])
def test_entry_dispatches_by_the_rule(monkeypatch, Q, levels, dtype, fwd, merged):
    """The entry's helpers pick the rule's wrapper (meta tensors at the path
    shapes, B=16, H=16, D=16, L=P=4; the wrappers replaced by recorders)."""
    S = sum(h * w for h, w in levels)
    value = torch.empty((16, S, 16, 16), dtype=dtype, device="meta")
    locs = torch.empty((16, Q, 16, 4, 4, 2), device="meta")
    assert dac.forward_kernel(value, locs) is getattr(dac, fwd)
    calls = []
    monkeypatch.setattr(dac, "MS_DEFORM_ATTN_MERGED_SLAB",
                        lambda *a: calls.append(("slab", a[5])))
    monkeypatch.setattr(dac, "MS_DEFORM_ATTN_MERGED", lambda *a: calls.append(("atomic", None)))
    dac.merged_adjoint(value, levels, locs, None, None)
    assert calls == [merged]


def test_train_profiler_names_the_slab_kernels():
    from poet_tpu_torch.tools.profile_train import kernel_class

    assert kernel_class("void (anonymous namespace)::ms_deform_attn_fwd_slab_kernel"
                        "<__nv_bfloat16, 8>") == "forward kernel (slab)"
    assert kernel_class("void (anonymous namespace)::ms_deform_attn_fwd_kernel"
                        "<__nv_bfloat16, 8>") == "forward kernel (direct)"
    assert kernel_class("void (anonymous namespace)::ms_deform_attn_merged_slab_kernel"
                        "<__nv_bfloat16, 8, true>") == "merged adjoint kernel (slab)"
    assert kernel_class("void (anonymous namespace)::ms_deform_attn_merged_kernel"
                        "<__nv_bfloat16, 4>") == "merged adjoint kernel (atomic)"


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_chip_smoke_launch_plan_follows_the_rule(dtype):
    """chip_smoke's expected launches per path: the encoder on the slab
    forward, the decoder on the direct one; the merged adjoint on its slab
    route (the default), the pair with merged_adjoint=False (its d_value by
    plan_dvalue: the scatter in the encoder, the slab in the decoder), the dense
    kernels with 'pallas'; the YOLO pyramid's forward by the budget."""
    import chip_smoke as cs
    from poet_tpu_torch.flagship import flagship_config

    cfg = flagship_config(dtype)
    assert cs.path_launches(cfg, 1600, 3) == {"fwd_slab": 15, "fwd": 15}
    assert cs.path_launches(cfg, 1600, 2, train=True) == {"fwd_slab": 10, "fwd": 10,
                                                          "merged_slab": 20}
    assert cs.path_launches(cfg, 6380, 1) == (
        {"fwd_slab": 5, "fwd": 5} if dtype == "bfloat16" else {"fwd": 10})
    cfg.model.merged_adjoint = False
    assert cs.path_launches(cfg, 1600, 1, train=True) == {
        "fwd_slab": 5, "fwd": 5, "d_value": 5, "d_value_slab": 5, "d_loc": 10}
    cfg.model.enc_deform_impl = cfg.model.dec_deform_impl = "pallas"
    assert cs.path_launches(cfg, 1600, 1, train=True) == {"dense_fwd": 10, "dense_bwd": 10}
