"""RoIAlign's tiles route (`ops/roi_align_cuda.py:RoIAlignTiles`,
`csrc/roi_align_fwd.cu:roi_align_tiles_kernel`), on the CPU.

* the route rule (`plan_roi`) and its shared-memory plan at the path
  shapes: the Mask R-CNN detect+pose request and the backbone-mode eval
  batch (C=256, 7x7 bins, 2x2 samples, bf16 and f32); never over the
  232 448 B a block may opt into; the gather route past the tiles route's
  limits;
* a numpy model of the kernel's partition, run with the kernel's own block
  size and chunking: per box the distinct lines (a rank among the
  candidates), each bin's window of at most 2s lines with its merged
  weights, the staging of each chunk's footprint cells (2^per_shift 16-byte
  pieces a cell) and the blend of each (bin, slice) item; every footprint
  cell staged once per chunk, every bin written once, and the results held
  against JAX's `multiscale_roi_align_pallas` in interpret mode and the flat
  oracle (as `tests/test_torch_detect_ops.py`), within 1e-5 of the feature
  scale in f32 plus one bf16 rounding for bf16; boxes on level boundaries,
  elongated boxes and NaN boxes against the port's plain version;
* the wrappers' refusals, the entry's dispatch by the rule, the profiler's
  name for the kernel and chip_smoke's launch plan.

The kernel itself runs only on the card (chip_smoke.py phases 9, 10, 11, 17).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from poet_tpu_torch.ops import roi_align_cuda as rac
from poet_tpu_torch.ops.detection import multiscale_roi_align_torch, roi_geometry
from tests.test_torch_detect_ops import (
    PYRAMIDS,
    ROI_TOL,
    STRIDES,
    _level_of,
    _pyramid,
    _roi_boxes,
    _t,
)
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

BUDGET = 232448
BF16_RTOL = 2.0 ** -8               # one bf16 rounding of the pooled bins
INT_MAX = np.iinfo(np.int32).max
OUT, SR = 7, 2                      # the box head's 7x7 bins, 2x2 samples


@pytest.mark.parametrize("dtype, chunk", [(torch.bfloat16, 16), (torch.float32, 8)])
def test_rule_at_the_detect_and_eval_shapes(dtype, chunk):
    """C=256, 7x7 bins of 2x2 samples (N=14): the tiles route, chunks of 32
    bytes a cell; the cell offsets (784 ints) and two buffers of the worst
    28 x 28 footprint take 53 312 B, four blocks per SM."""
    plan = rac.plan_roi(256, dtype, OUT, SR)
    assert plan == ("tiles", chunk, 3136 + 2 * 784 * chunk * (torch.finfo(dtype).bits // 8))
    assert plan.smem_bytes == 53312 <= rac.ROI_SMEM_TARGET


def test_rule_takes_the_gather_route_past_the_tiles_limits():
    """More than 16 bins, 4 samples or 32 samples per axis: the gather route."""
    for out, s in ((17, 2), (7, 5), (16, 4)):
        assert rac.plan_roi(256, torch.bfloat16, out, s) == ("gather", 0, 0)
    assert rac.plan_roi(256, torch.bfloat16, 16, 2).route == "tiles"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_never_exceeds_the_budget(dtype):
    """Over C, bins and samples: the chunk divides C, is a multiple of the
    16-byte slice where C allows, fits the budget, and is the largest such
    chunk within the target where one is."""
    size = torch.finfo(dtype).bits // 8
    for C in (1, 6, 8, 24, 64, 96, 256, 1024):
        for out, s in ((7, 2), (7, 1), (14, 2), (16, 2), (8, 4)):
            plan = rac.plan_roi(C, dtype, out, s)
            if plan.route == "gather":
                continue
            vec = 16 // size if C % (16 // size) == 0 else 1
            assert C % plan.chunk == 0 and plan.chunk % vec == 0
            assert plan.smem_bytes == rac.tiles_smem_bytes(out * s, plan.chunk, size) <= BUDGET
            bigger = [c for c in range(plan.chunk + vec, C + 1, vec) if C % c == 0]
            assert all(rac.tiles_smem_bytes(out * s, c, size) > rac.ROI_SMEM_TARGET
                       for c in bigger)


# ------------------------------------------------------------------ model

def _axis_plan(lo, w, N, size, s):
    """One axis of a box as the kernel plans it: candidates, firsts and
    ranks (axis_candidates, axis_firsts, axis_ranks), then each bin's first
    line and the f32 weights of its lines (axis_bin)."""
    inside = (w[:, 0] != 0) | (w[:, 1] != 0)
    cand = [int(min(max(lo[i >> 1], 0), size - 2)) + (i & 1) if inside[i >> 1] else INT_MAX
            for i in range(2 * N)]
    first = [v != INT_MAX and v not in cand[:i] for i, v in enumerate(cand)]
    rank = [sum(1 for k in range(2 * N) if first[k] and cand[k] < v) for v in cand]
    lines = np.zeros(2 * N, np.int64)
    for i in range(2 * N):
        if first[i]:
            lines[rank[i]] = cand[i]
    idx = [rank[2 * n] if inside[n] else None for n in range(N)]
    n_lines = sum(first)
    start = np.zeros(N // s, np.int64)
    weights = np.zeros((N // s, 2 * s), np.float32)
    for o in range(N // s):
        ins = [idx[o * s + k] for k in range(s) if inside[o * s + k]]
        start[o] = min(ins) if ins else 0
        for k in range(s):
            n = o * s + k
            if inside[n]:
                j = idx[n] - start[o]
                assert 0 <= j and j + 1 < 2 * s          # at most 2s lines a bin
                weights[o, j] += w[n, 0]
                weights[o, j + 1] += w[n, 1]
    return lines[:n_lines], start, weights


def _geo_arrays(geo):
    """The geometry's five tensors as numpy arrays."""
    return tuple(np.asarray(getattr(geo, k)) for k in ("level", "ylo", "yw", "xlo", "xw"))


def tiles_model(feats, geo, B, R, chunk, threads=rac.ROI_THREADS, itemsize=4, out=OUT, s=SR):
    """The tiles kernel's partition in numpy (float64 blend): per box (a
    block) the two axis plans; per chunk the staging of its footprint cells
    (i -> cell i >> per_shift, piece i & mask, 16 bytes each, or element by
    element) and, thread tid walking items it = tid, + threads, ... < out^2
    slices (slice fastest, then ox, then oy), the unrolled 2s x 2s window
    with lines past the staged ones clamped onto the last. Returns the
    pooled bins and the counts of stagings per (box, chunk, cell, channel)
    and of writes per output element, with each box's staged cells."""
    C = feats[0].shape[-1]
    N = out * s
    E = 16 // itemsize
    vec = E if C % E == 0 else 1
    level, ylo, yw, xlo, xw = _geo_arrays(geo)
    pooled = np.full((B * R, out, out, C), np.nan)
    writes = np.zeros((B * R, out, out, C), np.int64)
    staged_once, footprints = True, []
    for box in range(B * R):
        f = feats[int(level[box])][box // R]
        H, W = f.shape[:2]
        rows, ys, wy = _axis_plan(ylo[box], yw[box], N, H, s)
        cols, xs, wx = _axis_plan(xlo[box], xw[box], N, W, s)
        footprints.append({(int(r), int(c)) for r in rows for c in cols})
        ny, nx = len(rows), len(cols)
        if ny * nx == 0:                         # every sample off the map: zeros
            pooled[box] = 0.0
            writes[box] += 1
            continue
        pieces = chunk * itemsize // 16
        async16 = vec > 1 and pieces & (pieces - 1) == 0
        for c0 in range(0, C, chunk):
            tile = np.full((ny * nx, chunk), np.nan)
            count = np.zeros((ny * nx, chunk), np.int64)
            if async16:
                shift = pieces.bit_length() - 1
                for i in range(ny * nx << shift):
                    cell, p = i >> shift, i & (pieces - 1)
                    r, c = divmod(cell, nx)
                    piece = slice(p * E, (p + 1) * E)
                    tile[cell, piece] = f[rows[r], cols[c], c0 + p * E:c0 + (p + 1) * E]
                    count[cell, piece] += 1
            else:
                for i in range(ny * nx * chunk):
                    cell, k = divmod(i, chunk)
                    r, c = divmod(cell, nx)
                    tile[cell, k] = f[rows[r], cols[c], c0 + k]
                    count[cell, k] += 1
            staged_once &= bool((count == 1).all())
            tile = tile.reshape(ny, nx, chunk)
            slices = chunk // vec
            for tid in range(threads):
                for it in range(tid, out * out * slices, threads):
                    sl, b = it % slices, it // slices
                    oy, ox = divmod(b, out)
                    ch = slice(sl * vec, (sl + 1) * vec)
                    acc = np.zeros(vec)
                    for j in range(2 * s):
                        row = tile[min(ys[oy] + j, ny - 1)]
                        xr = sum(float(wx[ox, i]) * row[min(xs[ox] + i, nx - 1), ch]
                                 for i in range(2 * s))
                        acc += float(wy[oy, j]) * xr
                    pooled[box, oy, ox, c0 + sl * vec:c0 + (sl + 1) * vec] = acc / (s * s)
                    writes[box, oy, ox, c0 + sl * vec:c0 + (sl + 1) * vec] += 1
    return pooled.reshape(B, R, out, out, C), writes, staged_once, footprints


def _sample_corners(geo, box):
    """The (row, col) corners of a box's in-map sample pairs: what the
    footprint must hold."""
    level, ylo, yw, xlo, xw = _geo_arrays(geo)
    ys = {int(v) + d for v, w in zip(ylo[box], yw[box]) if w.any() for d in (0, 1)}
    xs = {int(v) + d for v, w in zip(xlo[box], xw[box]) if w.any() for d in (0, 1)}
    return {(r, c) for r in ys for c in xs}


_JAX = {}


def _jax_pooled(pyramid, feats, boxes, bf16):
    """JAX's Pallas kernel (interpret mode) and the flat oracle on the same
    (bf16-rounded for `bf16`) f32 features, once per pyramid."""
    key = (pyramid, bf16, boxes.tobytes())
    if key not in _JAX:
        from jax.experimental.pallas import tpu as pltpu

        from poet_tpu.ops.detection import _multiscale_roi_align_flat
        from poet_tpu.ops.roi_align_pallas import multiscale_roi_align_pallas

        with pltpu.force_tpu_interpret_mode():
            pallas = np.asarray(multiscale_roi_align_pallas(
                [jnp.asarray(f) for f in feats], STRIDES, jnp.asarray(boxes), output_size=OUT,
                sampling_ratio=SR, interpret=True))
        flat = np.stack([np.asarray(_multiscale_roi_align_flat(
            [jnp.asarray(f[b]) for f in feats], STRIDES, jnp.asarray(boxes[b]), OUT, SR, 224, 4))
            for b in range(boxes.shape[0])])
        _JAX[key] = pallas, flat
    return _JAX[key]


@pytest.mark.parametrize("pyramid", list(PYRAMIDS))
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("chunk", ["rule", "one slice"])
def test_tiles_partition_stages_each_cell_once_and_matches_jax(rng, pyramid, itemsize, chunk):
    """C=16: the rule's chunk (f32 8 channels: two chunks; bf16 16: one) and
    a chunk of one 16-byte slice (f32 4, bf16 8); boxes on every level,
    partly outside the image, under 1 px and slivers (aspect > 15)."""
    H, W = PYRAMIDS[pyramid]
    B, C = 2, 16
    feats = _pyramid(rng, B, H, W, C)
    if itemsize == 2:
        feats = [torch.from_numpy(f).bfloat16().float().numpy() for f in feats]
    boxes = _roi_boxes(rng, B, H, W, n=14)
    dtype = torch.bfloat16 if itemsize == 2 else torch.float32
    size = rac.plan_roi(C, dtype).chunk if chunk == "rule" else 16 // itemsize
    geo = roi_geometry([f.shape[1:3] for f in feats], STRIDES, _t(boxes))
    got, writes, staged_once, footprints = tiles_model(feats, geo, B, boxes.shape[1], size,
                                                      itemsize=itemsize)
    assert staged_once and (writes == 1).all()
    for box, fp in enumerate(footprints):
        assert fp == _sample_corners(geo, box)
    pallas, flat = _jax_pooled(pyramid, feats, boxes, itemsize == 2)
    tol = ROI_TOL * max(float(np.abs(f).max()) for f in feats)
    if itemsize == 2:
        got = torch.from_numpy(got).bfloat16().double().numpy()
        for ref in (pallas, flat):
            assert (np.abs(got - ref) <= tol + BF16_RTOL * np.abs(ref)).all()
    else:
        np.testing.assert_allclose(got, pallas, rtol=0, atol=tol, err_msg="vs Pallas kernel")
        np.testing.assert_allclose(got, flat, rtol=0, atol=tol, err_msg="vs flat oracle")


def test_tiles_on_level_boundaries_elongated_and_nan_boxes(rng):
    """Square boxes exactly on and one f32 ulp either side of each level
    boundary, slivers of aspect 40, and NaN boxes: the model against the
    port's plain version on the same geometry (the level of a boundary box
    is torch's, shared by both), NaN boxes pooling zeros; every cell staged
    once, every bin written once, at most 2s lines a bin."""
    H, W = 96, 128
    feats = _pyramid(rng, 1, H, W, 8)
    sides = []
    for k in range(-2, 2):
        side = np.float32(224 * (2.0 ** k - 1e-6))
        sides += [np.nextafter(side, np.float32(0)), side, np.nextafter(side, np.float32(1e9))]
    rows = [[3.0, 5.0, 3.0 + s, 5.0 + s] for s in sides]
    rows += [[2.0, 7.5, 2.0 + 120.0, 7.5 + 3.0], [60.0, 1.0, 63.0, 1.0 + 90.0]]   # slivers
    rows += [[np.nan] * 4, [10.0, np.nan, 20.0, 30.0]]
    boxes = np.asarray([rows], np.float32)
    lv = np.floor(_level_of(boxes[0, :len(sides)]))
    assert len(set(lv.tolist())) >= 3                 # the boundaries of several levels
    geo = roi_geometry([f.shape[1:3] for f in feats], STRIDES, _t(boxes))
    got, writes, staged_once, _ = tiles_model(feats, geo, 1, boxes.shape[1], 8)
    assert staged_once and (writes == 1).all()
    assert (got[0, -2:] == 0).all()
    want = multiscale_roi_align_torch([_t(f) for f in feats], STRIDES, _t(boxes)).numpy()
    tol = ROI_TOL * max(float(np.abs(f).max()) for f in feats)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# ---------------------------------------------------------------- wrappers

@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_tiles_wrapper_refuses_cpu_tensors(device):
    feats = [torch.zeros((1, 8, 8, 16), device=device), torch.zeros((1, 4, 4, 16),
                                                                     device=device)]
    boxes = torch.zeros((1, 3, 4), device=device)
    before = rac.ROI_ALIGN_TILES.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        rac.ROI_ALIGN_TILES(feats, (4, 8), boxes)
    assert rac.ROI_ALIGN_TILES.launches == before and rac.ROI_LIB._lib is None


@pytest.mark.parametrize("C, out, s, want", [
    (256, 7, 2, "ROI_ALIGN_TILES"), (6, 7, 2, "ROI_ALIGN_TILES"), (256, 16, 4, "ROI_ALIGN_FWD")])
def test_entry_dispatches_by_the_rule(C, out, s, want):
    feats = [torch.empty((1, 8, 8, C), dtype=torch.bfloat16, device="meta")]
    assert rac.roi_align_kernel(feats, out, s) is getattr(rac, want)


def test_profiler_names_the_tiles_kernel():
    from poet_tpu_torch.tools.profile_train import kernel_class

    assert kernel_class("void (anonymous namespace)::roi_align_tiles_kernel"
                        "<__nv_bfloat16, 8, 2>") == "RoIAlign kernel (tiles)"
    assert kernel_class("void (anonymous namespace)::roi_align_fwd_kernel"
                        "<__nv_bfloat16, 8>") == "RoIAlign kernel"


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_chip_smoke_detect_launch_plan_takes_the_tiles_route(dtype):
    import chip_smoke as cs
    from poet_tpu_torch.flagship import flagship_config

    assert cs.roi_launches(flagship_config(dtype), 8) == {"roi_tiles": 8}
