"""The merged adjoint's banded route (`ops/deform_attn_cuda.py`:
`plan_merged`, `plan_merged_bands`, `MS_DEFORM_ATTN_MERGED_BANDED`), on the
CPU.

* the rule and the band plan at every path shape: the flagship encoder and
  decoder stay on the slab route; the YOLO encoder and decoder take the
  banded route in bf16 (the atomic route in f32, where it measured faster),
  with bands of whole rows within the budget in both dtypes; a row over the
  budget, or more bands than the kernel's table holds, raises with its
  numbers;
* a numpy model of the banded kernel's partition (a block per (b, h), its
  bands one after another, each walking the points of the levels that
  start in it and the points earlier bands handed on to it, its G-lane
  groups adding each in-band corner channel by channel), run with its own
  bands under a budget that cuts three: one boundary inside a level, one at
  a level's edge. Its inputs hold points that straddle two bands, points
  half off the map and a NaN point. Every in-map corner is added exactly
  once per channel, every d_value row written once, every point's d_loc /
  d_attn written once, every point walked only in its level's first band
  and the bands its rows lie in, and the staged reads stay in the band's
  rows and halo row; the results are held against JAX's gradient of
  `ms_deform_attn_xla` and against `ms_deform_attn_fused` with
  `POET_V3_MERGED_ADJOINT=1` in interpret mode, within 1e-5 of each
  tensor's max at f32;
* what the wrapper refuses, the entry's dispatch by the rule, the train
  profiler's names for the kernels and chip_smoke's launch plan.

The kernels themselves run only on the card (chip_smoke.py phase 18).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poet_tpu_torch.ops import deform_attn_cuda as dac
from tests.test_deform_attn import _make_inputs
from tests.test_torch_deform_attn_slab import (
    _close,
    _corners,
    _footprint,
    _group_lanes,
    _nonfinite,
    _vec_of,
    _xla,
)
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

FLAGSHIP = ((30, 40), (15, 20), (8, 10), (4, 5))
YOLO = ((60, 80), (30, 40), (15, 20), (8, 10))
BUDGET = 232448
THREADS = 1024                       # kMergedSlabThreads
# the model's pyramid: 54 + 20 + 6 tokens; level 0's rows hold 9 tokens
LEVELS = ((6, 9), (4, 5), (2, 3))


def _dtype(itemsize):
    return torch.float32 if itemsize == 4 else torch.bfloat16


def _cut_three(D, itemsize, stage):
    """A budget that cuts LEVELS into three bands: level 0's rows 0-2 (a
    boundary inside the level, with its halo row) and 3-5 (a boundary at
    the level's edge), then levels 1 and 2 together."""
    return dac.merged_band_bytes(27, 36 if stage else 27, D, _dtype(itemsize), stage)


# ------------------------------------------------------------------- rule

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Q", [1600, 10])
def test_flagship_shapes_stay_on_the_slab_route(dtype, Q):
    assert dac.plan_merged(1600, 16, dtype, Q, 4, 4).route == "slab"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Q", [6380, 10])
def test_yolo_shapes_get_bands_of_whole_rows_within_the_budget(dtype, Q):
    """The YOLO encoder (Q=S=6380, 64 reads per token: staged) and decoder
    (Q=10: unstaged): the rule's banded route in bf16, its atomic route in
    f32; in both dtypes a plan whose bands cover the levels in whole rows,
    each within the budget with its halo row, and a carry list for each
    band that starts inside a level."""
    stage = Q == 6380
    plan = dac.plan_merged(6380, 16, dtype, Q, 4, 4)
    assert plan == (("banded", stage, 0) if dtype == torch.bfloat16 else ("atomic", False, 0))
    bands = dac.plan_merged_bands(YOLO, 16, dtype, stage)
    assert bands.bounds[0] == 0 and bands.bounds[-1] == 6380
    assert 2 <= len(bands.bounds) - 1 <= dac.MAX_BANDS
    starts = np.cumsum([0] + [h * w for h, w in YOLO])
    sizes = []
    for t0, t1 in zip(bands.bounds, bands.bounds[1:]):
        l1 = int(np.searchsorted(starts, t1 - 1, side="right")) - 1
        l0 = int(np.searchsorted(starts, t0, side="right")) - 1
        assert (t0 - starts[l0]) % YOLO[l0][1] == 0 and (t1 - starts[l1]) % YOLO[l1][1] == 0
        halo = YOLO[l1][1] if t1 < starts[l1 + 1] else 0
        sizes.append(dac.merged_band_bytes(t1 - t0, t1 - t0 + halo, 16, dtype, stage))
    assert max(sizes) == bands.smem_bytes <= BUDGET
    assert bands.lists == sum(t not in starts for t in bands.bounds[1:-1])
    # greedy: no band could have taken the next row as well
    assert bands.smem_bytes > BUDGET - 2 * 80 * 16 * (4 + 4)


def test_a_row_over_the_budget_raises_with_its_numbers():
    row = dac.merged_band_bytes(80, 160, 16, torch.float32, True)   # level 0's row + halo
    assert row == dac.BAND_HEAD + 80 * 64 + 160 * 64        # f32 slab, f32 staged rows
    with pytest.raises(ValueError, match=rf"row of 80 tokens \(halo 80\): {row} B .* 10000 B"):
        dac.plan_merged_bands(YOLO, 16, torch.float32, True, budget=10000)
    with pytest.raises(ValueError, match="bands within"):     # a row a band: 113 bands
        dac.plan_merged_bands(YOLO, 16, torch.float32, False,
                              budget=dac.merged_band_bytes(80, 80, 16, torch.float32, False))


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("stage", [True, False])
def test_the_three_band_cut_of_the_model(itemsize, stage):
    plan = dac.plan_merged_bands(LEVELS, 16, _dtype(itemsize), stage, _cut_three(16, itemsize,
                                                                                  stage))
    assert plan.bounds == (0, 27, 54, 80) and plan.lists == 1


# ------------------------------------------------------------------ model

def merged_banded_model(value, shapes, locs, attn, dout, budget, stage=True, itemsize=4,
                        threads=THREADS):
    """The banded kernel's partition in numpy, block by block and band by
    band, with the host's plan (plan_merged_bands at `budget`): a band walks
    the points of its carry list (in an order of its own: the atomics' order
    is the hardware's), then every point of the levels that start in it;
    where a point's level goes on past the band and the point has a row past
    it, it joins the list of the first later band holding such a row. Lane r
    of each G-lane group takes channel slices c = r, r + G, ...; the adds go
    in float64, channel by channel in slab_add's rotated order. Returns the
    three gradients and the counts of adds per (b, q, h, k, corner,
    channel), of d_value writes per (b, s, h, channel), of d_loc / d_attn
    writes per point and of walks per point."""
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = locs.shape
    LP = L * P
    VEC = _vec_of(D)
    chunks = D // VEC
    G = _group_lanes(chunks)
    groups = threads // G
    bounds = dac.plan_merged_bands(shapes, D, _dtype(itemsize), stage, budget).bounds
    starts = np.cumsum([0] + [h * w for h, w in shapes])
    S_lv = int(starts[-1])
    d_value = np.zeros((B, S, H, D))
    d_loc = np.full(locs.shape, np.nan)
    d_attn = np.full(attn.shape, np.nan)
    adds = np.zeros((B, Q, H, LP, 4, D), np.int64)
    writes = np.zeros((B, S, H, D), np.int64)
    point_writes = np.zeros((B, Q, H, LP), np.int64)
    walks = np.zeros((B, Q, H, LP), np.int64)
    for b in range(B):
        for h in range(H):
            writes[b, S_lv:, h] += 1                      # zero_pad_rows
            lists = [[] for _ in bounds[1:]]
            for bi, (t0, t1) in enumerate(zip(bounds, bounds[1:])):
                l0 = int(np.searchsorted(starts, t0, side="right")) - 1
                l1 = int(np.searchsorted(starts, t1 - 1, side="right")) - 1
                stage_end = t1 + shapes[l1][1] if t1 < starts[l1 + 1] else t1
                acc = np.zeros((t1 - t0, D))
                lf = l0 + 1 if t0 > starts[l0] else l0
                assert t0 > starts[l0] or not lists[bi]
                items = lists[bi][::-1] + [(q, k) for q in range(Q)
                                           for k in range(lf * P, (l1 + 1) * P)]
                for i, (q, k) in enumerate(items):
                    gi = i % groups                       # the item's lane group
                    l, p = divmod(k, P)
                    hl, wl = shapes[l]
                    lstart = int(starts[l])
                    walks[b, q, h, k] += 1
                    f = _footprint(*locs[b, q, h, l, p], hl, wl)
                    if f is None:
                        if t0 <= lstart:                  # lane 0, the band of row 0
                            g0 = np.nan if _nonfinite(*locs[b, q, h, l, p], hl, wl) else 0.0
                            d_loc[b, q, h, l, p] = g0
                            d_attn[b, q, h, l, p] = g0
                            point_writes[b, q, h, k] += 1
                        continue
                    t00, tx, ty, ix0, ix1, iy0, iy1 = f
                    y0 = (t00 if ix0 else t00 + 1) // wl          # x0 = -1 off column 0
                    r0 = min(max(t0 - lstart, 0), hl * wl) // wl
                    r1 = min(max(t1 - lstart, 0), hl * wl) // wl
                    if r1 < hl:                           # the level goes on: carry
                        after = y0 if y0 >= r1 else (y0 + 1 if iy1 and y0 + 1 >= r1 else -1)
                        if after >= 0:
                            tb = bi + 1
                            while bounds[tb + 1] <= lstart + after * wl:
                                tb += 1
                            lists[tb].append((q, k))
                    own = r0 <= max(y0, 0) < r1
                    top = iy0 and r0 <= y0 < r1
                    bottom = iy1 and r0 <= y0 + 1 < r1
                    if not (own or top or bottom):
                        continue
                    a = float(attn[b, q, h, l, p])
                    g = dout[b, q, h * D:(h + 1) * D].astype(np.float64)
                    for r in range(G):
                        rot = ((gi * G + r) % 32 // G) & (VEC - 1)
                        for c in range(r, chunks, G):
                            for cc, t, w in _corners(f, wl, a):
                                if not (top if cc < 2 else bottom):
                                    continue
                                for j in range(VEC):      # slab_add's rotated order
                                    cj = c * VEC + (j + rot) % VEC
                                    acc[lstart + t - t0, cj] += w * g[cj]
                                    adds[b, q, h, k, cc, cj] += 1
                    if own:                               # lane 0 after the shuffles
                        src = value[b, t0:stage_end, h] if stage else value[b, :, h]
                        first = t0 if stage else 0
                        e = np.zeros(4)
                        for cc, t, _ in _corners(f, wl, a):
                            tok = lstart + t
                            assert not stage or t0 <= tok < stage_end
                            e[cc] = g @ src[tok - first]
                        d_attn[b, q, h, l, p] = ((1 - ty) * ((1 - tx) * e[0] + tx * e[1])
                                                 + ty * ((1 - tx) * e[2] + tx * e[3]))
                        d_loc[b, q, h, l, p] = (
                            a * wl * ((1 - ty) * (e[1] - e[0]) + ty * (e[3] - e[2])),
                            a * hl * ((1 - tx) * (e[2] - e[0]) + tx * (e[3] - e[1])))
                        point_writes[b, q, h, k] += 1
                # store_slab: every row of the band once
                d_value[b, t0:t1, h] = acc
                writes[b, t0:t1, h] += 1
    return d_value, d_loc, d_attn, adds, writes, point_writes, walks


def _walks_wanted(locs, shapes, bounds):
    """Walks per point: in its level's first band and in each later band
    that holds one of its in-map rows (once, from a carry list)."""
    starts = np.cumsum([0] + [h * w for h, w in shapes])
    want = np.zeros(locs.shape[:3] + (locs.shape[3] * locs.shape[4],), np.int64)
    for b, q, h, l, p in np.ndindex(*locs.shape[:-1]):
        hl, wl = shapes[l]
        band_of = [int(np.searchsorted(bounds, starts[l] + y * wl, side="right")) - 1
                   for y in range(hl)]
        f = _footprint(*locs[b, q, h, l, p], hl, wl)
        bands = {band_of[0]}
        if f is not None:
            y0 = (f[0] if f[3] else f[0] + 1) // wl
            bands |= {band_of[y] for y, inside in ((y0, f[5]), (y0 + 1, f[6])) if inside}
        want[b, q, h, l * locs.shape[4] + p] = len(bands)
    return want


def _inputs(rng, nan=True, B=2, Q=9, H=2, D=16):
    """The model's inputs: LEVELS, locations spread 1.4x around the map
    (points half off it), the two dummy queries, NaN points."""
    value, shapes, locs, w = _make_inputs(rng, B=B, Q=Q, H=H, D=D, shapes=LEVELS)
    locs = ((locs - 0.5) * 1.4 + 0.5).astype(np.float32)
    locs[:, -1] = -10.0
    locs[:, -2] = -1.0
    if nan:
        locs[:, 0, :, 0, 1, 0] = np.nan
        locs[0, 1, 0, -1, 2, :] = np.nan
    dout = rng.normal(size=(B, Q, H * D)).astype(np.float32)
    return value, shapes, locs, w, dout


def _straddlers(locs):
    """Points of level 0 whose footprint's rows are 2 and 3: the two sides
    of the model's first boundary."""
    n = 0
    for idx in np.ndindex(*locs.shape[:3]):
        for p in range(locs.shape[4]):
            f = _footprint(*locs[idx][0, p], *LEVELS[0])
            if f is not None and f[5] and f[6] and (f[0] + (0 if f[3] else 1)) // 9 == 2:
                n += 1
    return n


@pytest.mark.parametrize("stage", [True, False])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_banded_partition_adds_each_corner_once_and_matches_jax(rng, stage, itemsize):
    value, shapes, locs, w, dout = _inputs(rng)
    assert _straddlers(locs) > 0
    budget = _cut_three(16, itemsize, stage)
    got = merged_banded_model(value, shapes, locs, w, dout, budget, stage, itemsize)
    d_value, d_loc, d_attn, adds, writes, point_writes, walks = got
    bounds = dac.plan_merged_bands(shapes, 16, _dtype(itemsize), stage, budget).bounds
    np.testing.assert_array_equal(walks, _walks_wanted(locs, shapes, bounds))
    want = np.zeros_like(adds)
    for b, q, h, l, p in np.ndindex(*locs.shape[:-1]):
        f = _footprint(*locs[b, q, h, l, p], *shapes[l])
        for cc, _, _ in ([] if f is None else _corners(f, shapes[l][1], 1.0)):
            want[b, q, h, l * locs.shape[4] + p, cc, :] = 1
    np.testing.assert_array_equal(adds, want)
    assert (writes == 1).all() and (point_writes == 1).all()
    assert (d_loc[:, -2:] == 0).all() and (d_attn[:, -2:] == 0).all()
    assert np.isnan(d_loc[:, 0, :, 0, 1]).all() and np.isnan(d_attn[:, 0, :, 0, 1]).all()
    _, ref = _xla(value, shapes, locs, w, dout)
    for g, r, name in zip((d_value, d_loc, d_attn), ref, ("d_value", "d_loc", "d_attn")):
        _close(g, r, name)


def test_banded_partition_matches_the_fused_merged_adjoint_interpret(rng, monkeypatch):
    """JAX's merged adjoint kernel in interpret mode (NaN-free inputs: JAX's
    d_value at a NaN point hangs on its float-to-int cast)."""
    from jax.experimental.pallas import tpu as pltpu

    from poet_tpu.ops.deform_attn_pallas_v3 import ms_deform_attn_fused

    monkeypatch.setenv("POET_V3_MERGED_ADJOINT", "1")
    value, shapes, locs, w, dout = _inputs(rng, nan=False)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda v, l, a: ms_deform_attn_fused(v, shapes, l, a),
                         jnp.asarray(value), jnp.asarray(locs), jnp.asarray(w))
        ref = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    got = merged_banded_model(value, shapes, locs, w, dout, _cut_three(16, 4, True))
    for g, r, name in zip(got[:3], ref, ("d_value", "d_loc", "d_attn")):
        _close(g, r, name)


# --------------------------------------------------------------- wrappers

@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_banded_wrapper_refuses_cpu_tensors(device):
    k = dac.MS_DEFORM_ATTN_MERGED_BANDED
    before = k.launches
    args = [torch.zeros((2, 16, 2, 8), device=device), ((3, 4), (2, 2)),
            torch.zeros((2, 5, 2, 2, 4, 2), device=device),
            torch.zeros((2, 5, 2, 2, 4), device=device), torch.zeros((2, 5, 16), device=device)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        k(*args)
    assert k.launches == before
    assert dac.BWD_LIB._lib is None


@pytest.mark.parametrize("Q, dtype, route", [(6380, torch.bfloat16, ("banded", True)),
                                             (10, torch.bfloat16, ("banded", False)),
                                             (6380, torch.float32, ("atomic",)),
                                             (10, torch.float32, ("atomic",))])
def test_entry_sends_the_yolo_pyramid_to_the_rules_route(monkeypatch, Q, dtype, route):
    value = torch.empty((16, 6380, 16, 16), dtype=dtype, device="meta")
    locs = torch.empty((16, Q, 16, 4, 4, 2), device="meta")
    calls = []
    monkeypatch.setattr(dac, "MS_DEFORM_ATTN_MERGED_BANDED",
                        lambda *a: calls.append(("banded", a[5])))
    monkeypatch.setattr(dac, "MS_DEFORM_ATTN_MERGED", lambda *a: calls.append(("atomic",)))
    dac.merged_adjoint(value, YOLO, locs, None, None)
    assert calls == [route]


def test_train_profiler_names_the_banded_kernel():
    from poet_tpu_torch.tools.profile_train import kernel_class

    assert kernel_class("void (anonymous namespace)::ms_deform_attn_merged_banded_kernel"
                        "<__nv_bfloat16, 8, true>") == "merged adjoint kernel (banded)"


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_chip_smoke_launch_plan_puts_the_yolo_step_on_the_banded_route(dtype):
    """The YOLO train step's 10 merged launches (5 encoder, 5 decoder, S =
    6380) on the banded route in bf16, the atomic route in f32; the flagship
    step's on the slab route."""
    import chip_smoke as cs
    from poet_tpu_torch.flagship import flagship_config

    cfg = flagship_config(dtype)
    got = cs.path_launches(cfg, 6380, 1, train=True)
    key = "merged_banded" if dtype == "bfloat16" else "merged"
    assert got[key] == 10 and not {"merged", "merged_banded", "merged_slab"} - {key} & set(got)
    assert cs.path_launches(cfg, 1600, 1, train=True)["merged_slab"] == 10
    assert cs.KERNEL_KEYS[-1] == "merged_banded"
    assert cs.all_kernels()[-1] is dac.MS_DEFORM_ATTN_MERGED_BANDED
