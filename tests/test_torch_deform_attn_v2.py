"""The port's separable (v2) deformable-attention forward against the JAX
package's `ms_deform_attn_pallas_v2` (the TPU kernel in interpret mode), on
the CPU.

* `ms_deform_attn_v2` on CPU tensors (the plain version) against the Pallas
  kernel at JAX's own tolerance (2e-5, `tests/test_deform_attn_pallas_v2.py`):
  JAX's two cases, edge levels, points on and beyond the -1 / W borders,
  dummy queries at -10, and a bf16 value (one bf16 rounding apart);
* a torch model of the CUDA kernel's index arithmetic (the zero-bordered
  slab packed level after level, row bands from `plan_bands`, each corner
  row added in its band) against the same Pallas kernel, at budgets that
  force many bands;
* the band planner: every padded row in exactly one band, each band within
  its budget, the fewest bands;
* what the entry and the kernel's wrapper refuse.

The kernel itself runs only on the card (chip_smoke.py phase 21).
"""

import numpy as np
import pytest
import torch

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


def _slab_kernel_model(value, shapes, locs, attn, bands):
    """The CUDA kernel's arithmetic in torch, f32: each (b, h) slab is the
    padded levels packed densely (row-major cells of D values, zero
    border), cut into `bands` of padded rows; a point counts when its base
    lies in [-1, W-1] x [-1, H-1]; each of its two corner rows is added in
    the band that holds it, at padded cell base + 1."""
    from poet_tpu_torch.ops.deform_attn_v2_cuda import padded_rows

    B, S, H, D = value.shape
    Q, P = locs.shape[1], locs.shape[4]
    row_cells = padded_rows(shapes)
    row_start = np.concatenate([[0], np.cumsum(row_cells)])     # first cell of each row
    slab = torch.zeros((B, H, int(row_start[-1]), D))
    row_off, cell_off, tok = [], [], 0
    for h_l, w_l in shapes:
        r0 = sum(hh + 2 for hh, _ in shapes[:len(row_off)])
        row_off.append(r0)
        cell_off.append(int(row_start[r0]))
        v = torch.from_numpy(value[:, tok:tok + h_l * w_l]).reshape(B, h_l, w_l, H, D)
        padded = torch.zeros((B, h_l + 2, w_l + 2, H, D))
        padded[:, 1:-1, 1:-1] = v
        slab[:, :, cell_off[-1]:cell_off[-1] + (h_l + 2) * (w_l + 2)] = \
            padded.permute(0, 3, 1, 2, 4).reshape(B, H, -1, D)
        tok += h_l * w_l
    locs, attn = torch.from_numpy(locs), torch.from_numpy(attn)
    b_i = torch.arange(B).view(B, 1, 1)
    h_i = torch.arange(H).view(1, 1, H)
    acc = torch.zeros((B, Q, H, D))
    for k in range(len(bands) - 1):
        r_lo, r_hi = bands[k], bands[k + 1]
        c_lo, c_hi = int(row_start[r_lo]), int(row_start[r_hi])
        band = slab[:, :, c_lo:c_hi]                    # the block's shared memory
        for l, (h_l, w_l) in enumerate(shapes):
            wp = w_l + 2
            for p in range(P):
                x = locs[:, :, :, l, p, 0] * w_l - 0.5
                y = locs[:, :, :, l, p, 1] * h_l - 0.5
                ok = (x >= -1) & (x < w_l) & (y >= -1) & (y < h_l)
                x0 = torch.floor(torch.where(ok, x, 0.0))
                y0 = torch.floor(torch.where(ok, y, 0.0))
                tx, ty = x - x0, y - y0
                a = attn[:, :, :, l, p]
                pr = row_off[l] + y0.long() + 1
                base = cell_off[l] + (y0.long() + 1) * wp + x0.long() + 1 - c_lo
                for dr, wy in ((0, (1 - ty) * a), (1, ty * a)):
                    inb = ok & (pr + dr >= r_lo) & (pr + dr < r_hi)
                    cell = torch.where(inb, base + dr * wp, 0)
                    for dc, wx in ((0, 1 - tx), (1, tx)):
                        s = band[b_i, h_i, (cell + dc).clamp(max=c_hi - c_lo - 1)]
                        acc += torch.where(inb, wx * wy, 0.0)[..., None] * s
    return acc.reshape(B, Q, H * D).numpy()


@pytest.mark.parametrize("case,budget_rows", [("jax_q6", 1), ("jax_q6", 3),
                                              ("borders", 2), ("edge_levels", 1),
                                              ("dummy_queries", 1000)])
def test_slab_bands_model_matches_pallas_v2_interpret(rng, case, budget_rows):
    """The kernel's layout and band arithmetic, at a budget of about
    `budget_rows` of the widest padded row (one row per band at 1)."""
    from poet_tpu_torch.ops.deform_attn_v2_cuda import padded_rows, plan_bands

    value, shapes, locs, w = _case(rng, case)
    D = value.shape[-1]
    budget = budget_rows * max(padded_rows(shapes)) * D * 4
    bands = plan_bands(shapes, D, 4, budget)
    assert (len(bands) > 2) == (budget_rows < 1000)
    np.testing.assert_allclose(_slab_kernel_model(value, shapes, locs, w, bands),
                               _jax_v2(value, shapes, locs, w), atol=V2_ATOL)


@pytest.mark.parametrize("shapes,itemsize,budget", [
    (FLAGSHIP, 2, None), (FLAGSHIP, 4, None), (YOLO, 2, None), (YOLO, 4, None),
    (YOLO, 2, 232448), (YOLO, 4, 30000), (FLAGSHIP, 4, 5000), (((1, 7), (3, 1), (1, 1)), 4, 600),
])
def test_plan_bands_covers_every_padded_row_once(shapes, itemsize, budget):
    from poet_tpu_torch.ops.deform_attn_v2_cuda import (
        DEFAULT_SMEM_BUDGET,
        _greedy,
        padded_rows,
        plan_bands,
    )

    budget = budget or DEFAULT_SMEM_BUDGET
    D = 16
    bands = plan_bands(shapes, D, itemsize, budget)
    rows = padded_rows(shapes)
    assert bands[0] == 0 and bands[-1] == len(rows)
    assert all(a < b for a, b in zip(bands[:-1], bands[1:]))     # each row in one band
    sizes = [sum(rows[a:b]) * D * itemsize for a, b in zip(bands[:-1], bands[1:])]
    assert max(sizes) <= budget and sum(sizes) == sum(rows) * D * itemsize
    assert len(bands) == len(_greedy([r * D * itemsize for r in rows], budget))  # fewest


def test_plan_bands_pyramid_sizes():
    """The sizes the kernel's design was reckoned on, at D = 16."""
    from poet_tpu_torch.ops.deform_attn_v2_cuda import (
        DEFAULT_SMEM_BUDGET,
        padded_rows,
        plan_bands,
    )

    assert sum(padded_rows(FLAGSHIP)) == 1880 and sum(padded_rows(YOLO)) == 6922
    assert 1880 * 16 * 2 == 60160 and 6922 * 16 * 2 == 221504
    assert 62 * 82 * 16 * 4 == 325376                  # YOLO level 0, padded, f32
    assert len(plan_bands(FLAGSHIP, 16, 2)) - 1 == 1   # the flagship fits whole in bf16
    assert len(plan_bands(YOLO, 16, 2)) - 1 == 2
    assert len(plan_bands(YOLO, 16, 4)) - 1 == 4
    assert 443008 / DEFAULT_SMEM_BUDGET > 3


def test_plan_bands_refuses():
    from poet_tpu_torch.ops.deform_attn_v2_cuda import plan_bands

    with pytest.raises(ValueError, match="exceeds the band budget"):
        plan_bands(YOLO, 16, 4, 82 * 16 * 4 - 1)       # one YOLO level-0 row does not fit
    with pytest.raises(ValueError, match="bands needed"):
        plan_bands(YOLO, 16, 4, 82 * 16 * 4)           # over 100 bands


@pytest.mark.parametrize("B,H,Q,slices", [(16, 16, 1600, 2), (16, 16, 1600, 4),
                                          (16, 16, 10, 2), (2, 16, 6380, 2), (1, 2, 300, 2)])
def test_query_chunk_fills_the_card(B, H, Q, slices):
    from poet_tpu_torch.ops.deform_attn_v2_cuda import THREADS_PER_BLOCK, query_chunk

    sms = 132                                          # an H100 SXM
    qc = query_chunk(B, H, Q, slices, sms)
    assert 1 <= qc <= Q and qc * slices <= THREADS_PER_BLOCK
    assert B * H * -(-Q // qc) >= min(sms, B * H * Q)


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
