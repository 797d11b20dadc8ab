"""The port's three probes (`poet_tpu_torch/tools/`) against the JAX package's
TPU probe scripts, on the CPU.

* dyn gather: `scripts/test_dyn_gather.py:kernel` (loaded by path; the
  script is not a package) through `pl.pallas_call` in interpret mode, on
  the script's four cases, against the port's `take_along_axis` (the plain
  version on the CPU): exactly equal; an index out of range raises.
* kpad: the port's plain chained product against a jnp restatement of
  `scripts/bench_kpad.py:33-48` (its body is a closure that `bench_k` times
  and drops), and against R * (a @ b), within f32 tolerance.
* v3 variants: the exact variants' plain version against JAX's
  `ms_deform_attn_pallas_v3` in interpret mode (the script's
  `build_variant` cannot run: it unpacks five values from `v3._prep`, which
  returns four); each ablation's plain definition against a direct loop in
  numpy; what the kernels refuse.

The kernels themselves run only on the card (chip_smoke.py phase 22).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from tests.test_deform_attn import _make_inputs
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the chained products: the same f32 sums of exact bf16 products in another
# order, relative to the result's scale
KPAD_RTOL = 1e-5
V3_ATOL = 2e-5                 # JAX's tolerance for its deformable kernels


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _dyn_gather_script():
    spec = importlib.util.spec_from_file_location(
        "test_dyn_gather_script", os.path.join(ROOT, "scripts", "test_dyn_gather.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas_take(table, idx):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    kernel = _dyn_gather_script().kernel
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(idx.shape, table.dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM))(table, idx))


# the script's four cases: (table rows, index rows, dtype); 128 columns
GATHER_CASES = {"same_shape_f32": (512, 512, np.float32),
                "64_rows_into_512": (512, 64, np.float32),
                "bf16": (512, 512, jnp.bfloat16),
                "4800_rows": (4800, 4800, np.float32)}


@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_take_along_axis_matches_dyn_gather_kernel_interpret(rng, case):
    from poet_tpu_torch.tools import dyn_gather

    T, R, dtype = GATHER_CASES[case]
    table = rng.normal(size=(T, 128)).astype(np.float32).astype(dtype)
    idx = rng.integers(0, T, size=(R, 128)).astype(np.int32)
    want = _pallas_take(jnp.asarray(table), jnp.asarray(idx))
    t = torch.from_numpy(table.astype(np.float32))
    if dtype == jnp.bfloat16:
        t = t.bfloat16()
    got = dyn_gather.take_along_axis(t, torch.from_numpy(idx))
    assert got.dtype == t.dtype and got.shape == (R, 128)
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    np.testing.assert_array_equal(want.astype(np.float32),
                                  np.take_along_axis(table, idx, axis=0).astype(np.float32))
    assert dyn_gather.TAKE_ALONG_AXIS.launches == 0 and dyn_gather.GATHER_LIB._lib is None


def test_take_along_axis_refuses():
    from poet_tpu_torch.tools.dyn_gather import TAKE_ALONG_AXIS, take_along_axis

    table = torch.zeros((5, 3))
    for bad in (-1, 5):
        idx = torch.zeros((2, 3), dtype=torch.int32)
        idx[1, 2] = bad
        with pytest.raises(IndexError):
            take_along_axis(table, idx)
    with pytest.raises(IndexError):                          # numpy raises there too
        np.take_along_axis(table.numpy(), idx.numpy(), axis=0)
    with pytest.raises(TypeError, match="int32"):
        take_along_axis(table, torch.zeros((2, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match="expected table"):
        take_along_axis(table, torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(TypeError, match="table dtype"):
        TAKE_ALONG_AXIS(table.double(), torch.zeros((2, 3), dtype=torch.int32))
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            TAKE_ALONG_AXIS(table.to(device), torch.zeros((2, 3), dtype=torch.int32,
                                                          device=device), check_range=False)
    assert TAKE_ALONG_AXIS.launches == 0 and TAKE_ALONG_AXIS._fn is None


def _gather_walk(R, C, vec, blocks):
    """The kernel's walk (csrc/take_along_axis.cu): each thread starts at its
    global index split into (row, slice) and steps by the grid's stride,
    itself split once into rows and slices. Returns the slices each thread
    visits, as (thread, row, first column)."""
    from poet_tpu_torch.tools.dyn_gather import THREADS

    slices, stride = C // vec, blocks * THREADS
    dr, ds = divmod(stride, slices)
    visits = []
    for start in range(stride):
        r, s = divmod(start, slices)
        while r < R:
            visits.append((start, r, s * vec))
            r, s = r + dr, s + ds
            if s >= slices:
                r, s = r + 1, s - slices
    return visits


@settings(max_examples=40, deadline=None)
@given(R=st.integers(0, 70), C=st.integers(1, 40), itemsize=st.sampled_from([4, 2]),
       sms=st.integers(1, 3), misaligned=st.booleans())
def test_gather_walk_takes_every_slice_once(R, C, itemsize, sms, misaligned):
    """The kernel's slice plan on the CPU: 16-byte slices where C and the
    pointers allow (4 f32 / 8 bf16 columns), scalar columns else; the grid
    sized to the SMs; every (row, slice) taken by exactly one thread once;
    the gather the walk computes equals the plain version."""
    from poet_tpu_torch.tools.dyn_gather import (
        BLOCKS_PER_SM,
        THREADS,
        grid_blocks,
        slice_width,
        take_along_axis_torch,
    )

    ptrs = (4096, 8192 + 4 * misaligned, 512)
    vec = slice_width(C, itemsize, *ptrs)
    wide = 16 // itemsize
    assert vec == (wide if C % wide == 0 and not misaligned else 1)
    if R == 0:
        return
    blocks = grid_blocks(R, C, vec, sms)
    assert 1 <= blocks <= sms * BLOCKS_PER_SM
    assert blocks * THREADS >= min(R * C // vec, sms * BLOCKS_PER_SM * THREADS)
    visits = _gather_walk(R, C, vec, blocks)
    taken = sorted((r, c) for _, r, c in visits)
    assert taken == [(r, s * vec) for r in range(R) for s in range(C // vec)]
    rng = np.random.default_rng(R * 41 + C)
    table = torch.from_numpy(rng.normal(size=(7, C)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 7, size=(R, C)).astype(np.int32))
    out = torch.empty((R, C))
    for _, r, c in visits:
        out[r, c:c + vec] = table[idx[r, c:c + vec].long(), torch.arange(c, c + vec)]
    assert torch.equal(out, take_along_axis_torch(table, idx))


def test_gather_plan_at_the_cases():
    """The script's four cases take 16-byte slices, one a thread: the
    4800-row case's 153 600 slices fill 600 of the 1056 blocks the card's
    132 SMs hold at once; more rows than that are walked."""
    from poet_tpu_torch.tools.dyn_gather import CASES, COLUMNS, THREADS, grid_blocks, slice_width

    for _, T, R, dtype in CASES:
        itemsize = torch.empty((), dtype=dtype).element_size()
        vec = slice_width(COLUMNS, itemsize, 0, 0, 0)
        assert vec == 16 // itemsize
    assert grid_blocks(4800, COLUMNS, 4, 132) * THREADS == 4800 * COLUMNS // 4
    assert grid_blocks(64, COLUMNS, 4, 132) * THREADS == 64 * COLUMNS // 4
    assert grid_blocks(9600, COLUMNS, 4, 132) == 132 * 8


def _jax_kpad_chain(a, b, R):
    """scripts/bench_kpad.py:33-48, restated outside its pallas_call."""
    K = a.shape[1]
    acc = jnp.zeros((a.shape[0], b.shape[1]), jnp.float32)
    for _ in range(R):
        a_i = a + (acc[:, :K] * 1e-30).astype(a.dtype)
        acc = acc + jax.lax.dot_general(a_i, b, dimension_numbers=(((1,), (0,)), ((), ())),
                                        preferred_element_type=jnp.float32)
    return np.asarray(acc)


@pytest.mark.parametrize("K", [16, 27, 40])
def test_kpad_chain_matches_bench_kpad_body(rng, K):
    from poet_tpu_torch.tools.bench_kpad import KPAD_CHAIN, kpad_chain

    M, N, R = 32, 64, 3
    a = rng.normal(size=(M, K)).astype(jnp.bfloat16)
    b = rng.normal(size=(K, N)).astype(jnp.bfloat16)
    want = _jax_kpad_chain(jnp.asarray(a), jnp.asarray(b), R)
    ta = torch.from_numpy(a.astype(np.float32)).bfloat16()
    tb = torch.from_numpy(b.astype(np.float32)).bfloat16()
    got = kpad_chain(ta, tb, R, G=4).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=KPAD_RTOL * scale)
    # the feedback is numerically a no-op: R chained products are R (a @ b)
    exact = R * (a.astype(np.float64) @ b.astype(np.float64))
    np.testing.assert_allclose(got, exact, atol=KPAD_RTOL * scale)
    assert KPAD_CHAIN.launches == 0


def test_kpad_kernel_refuses():
    from poet_tpu_torch.tools.bench_kpad import KPAD_CHAIN, kpad_chain

    a, b = torch.zeros((32, 40), dtype=torch.bfloat16), torch.zeros((40, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="1 <= K <= min"):
        KPAD_CHAIN(a, b, 2)                                  # K > N: no feedback columns
    with pytest.raises(ValueError, match="M % 16"):
        KPAD_CHAIN(a[:20], b.new_zeros((40, 64)), 2)
    with pytest.raises(TypeError, match="bfloat16"):
        KPAD_CHAIN(a.float(), b, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        KPAD_CHAIN(a[:, :16].contiguous(), b[:16], 2)
    with pytest.raises(ValueError, match="R and G"):
        kpad_chain(a, b, 0)


V3_SHAPES = ((6, 9), (4, 5), (2, 3), (1, 2))         # L = 4, as 'unroll' needs


@pytest.mark.parametrize("variant", ["base", "unroll", "qt256", "treey"])
def test_exact_variants_plain_match_pallas_v3_interpret(rng, variant):
    from poet_tpu.ops.deform_attn_pallas_v3 import ms_deform_attn_pallas_v3
    from poet_tpu_torch.tools import bench_v3_variants as bv

    value, shapes, locs, w = _make_inputs(rng, B=2, Q=7, H=2, D=8, shapes=V3_SHAPES)
    want = np.asarray(ms_deform_attn_pallas_v3(jnp.asarray(value), shapes, jnp.asarray(locs),
                                               jnp.asarray(w)))
    got = bv.ms_deform_attn_variant(torch.from_numpy(value), shapes, torch.from_numpy(locs),
                                    torch.from_numpy(w), variant)
    np.testing.assert_allclose(got.numpy(), want, atol=V3_ATOL)
    assert bv.MS_DEFORM_ATTN_VARIANT.launches == 0 and bv.VARIANTS_LIB._lib is None


def _ablation_loop(value, shapes, locs, attn, variant):
    """noy, nox and bf16y by their definitions, one query, head and corner at
    a time (float32 coordinates and weights as the kernel computes them;
    bf16y: each step w16 * v + acc rounded once to bf16)."""
    f32 = np.float32
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = locs.shape
    out = np.zeros((B, Q, H, D), np.float64)
    for b in range(B):
        for q in range(Q):
            for h in range(H):
                acc = np.zeros(D, jnp.bfloat16 if variant == "bf16y" else np.float64)
                nonfinite = False
                start = 0
                for l, (hl, wl) in enumerate(shapes):
                    for p in range(P):
                        x = f32(locs[b, q, h, l, p, 0]) * f32(wl) - f32(0.5)
                        y = f32(locs[b, q, h, l, p, 1]) * f32(hl) - f32(0.5)
                        if not (np.isfinite(x) and np.isfinite(y)):
                            nonfinite = True             # C1: the row is NaN
                            continue
                        if not (x > -1 and x < wl and y > -1 and y < hl):
                            continue
                        a = f32(attn[b, q, h, l, p])
                        x0, y0 = np.floor(x), np.floor(y)
                        tx, ty = x - x0, y - y0
                        for dy, wy in ((0, (f32(1) - ty) * a), (1, ty * a)):
                            for dx, wx in ((0, f32(1) - tx), (1, tx)):
                                xi, yi = int(x0) + dx, int(y0) + dy
                                if not (0 <= xi < wl and 0 <= yi < hl):
                                    continue
                                v = value[b, start + yi * wl + xi, h].astype(np.float64)
                                if variant == "noy":
                                    acc += a * v
                                elif variant == "nox":
                                    acc += f32(wx * wy) * value[b, start, h].astype(np.float64)
                                else:
                                    w16 = np.float64(np.asarray(wx * wy).astype(jnp.bfloat16))
                                    acc = (w16 * v + acc.astype(np.float64)).astype(jnp.bfloat16)
                    start += hl * wl
                out[b, q, h] = np.nan if nonfinite else acc.astype(np.float64)
    return out.reshape(B, Q, H * D)


@pytest.mark.parametrize("variant", ["noy", "nox", "bf16y"])
def test_ablation_plain_definitions_match_a_direct_loop(rng, variant):
    from poet_tpu_torch.tools.bench_v3_variants import plain_variant

    value, shapes, locs, w = _make_inputs(rng, B=2, Q=4, H=2, D=8, shapes=((3, 4), (2, 2)))
    if variant == "bf16y":
        value = value.astype(jnp.bfloat16).astype(np.float32)    # the kernel takes bf16
    locs[0, 1, 0, 0, 2, 0] = np.nan                   # its row NaN (C1), as in the kernels
    want = _ablation_loop(value, shapes, locs, w, variant)
    v = torch.from_numpy(value)
    got = plain_variant(v.bfloat16() if variant == "bf16y" else v, shapes,
                        torch.from_numpy(locs), torch.from_numpy(w), variant).float().numpy()
    # noy, nox: f32 sums against float64 ones; bf16y: the plain version rounds
    # each step through f32 before bf16, so a step can land one bf16 ulp away
    atol = 2.0 ** -7 * np.abs(want).max() if variant == "bf16y" else 1e-5
    np.testing.assert_allclose(got, want, atol=atol)
    nan_row = np.zeros((2, 4, 2, 8), bool)
    nan_row[0, 1, 0] = True
    np.testing.assert_array_equal(np.isnan(got), nan_row.reshape(2, 4, 16))


def test_variant_kernels_refuse():
    from poet_tpu_torch.tools.bench_v3_variants import (
        MS_DEFORM_ATTN_VARIANT,
        ms_deform_attn_variant,
    )

    shapes = ((3, 4), (2, 2), (1, 1), (1, 2))

    def args(device="meta", dtype=torch.bfloat16, D=8, L=4, P=4):
        return (torch.empty((2, 19, 2, D), dtype=dtype, device=device), shapes[:L],
                torch.empty((2, 5, 2, L, P, 2), device=device),
                torch.empty((2, 5, 2, L, P), device=device))

    with pytest.raises(ValueError, match="not in"):
        ms_deform_attn_variant(*args(device="cpu"), "sep")
    with pytest.raises(ValueError, match="fixes L = P = 4"):
        ms_deform_attn_variant(*args(device="cpu", L=3), "unroll")
    with pytest.raises(ValueError, match="fixes L = P = 4"):
        ms_deform_attn_variant(*args(device="cpu", P=2), "unroll")
    with pytest.raises(TypeError, match="bfloat16 value"):
        MS_DEFORM_ATTN_VARIANT(*args(dtype=torch.float32), "base")
    with pytest.raises(ValueError, match="D % 8"):
        MS_DEFORM_ATTN_VARIANT(*args(D=6), "noy")
    with pytest.raises(ValueError, match="CUDA tensors"):
        MS_DEFORM_ATTN_VARIANT(*args(), "nox")
    with pytest.raises(ValueError, match="CUDA tensors"):
        MS_DEFORM_ATTN_VARIANT(*args(device="cpu"), "base")
    # over the budget: a (b, h) slab past the shared memory a block may use,
    # or a head wider than a TMA box
    big = (torch.empty((1, 7300, 1, 16), dtype=torch.bfloat16, device="meta"), ((73, 100),),
           torch.empty((1, 3, 1, 1, 4, 2), device="meta"),
           torch.empty((1, 3, 1, 1, 4), device="meta"))
    with pytest.raises(ValueError, match="over the budget"):
        MS_DEFORM_ATTN_VARIANT(*big, "base")
    with pytest.raises(ValueError, match="over the budget"):
        MS_DEFORM_ATTN_VARIANT(*args(D=264), "base")
    with pytest.raises(ValueError, match="staging"):
        MS_DEFORM_ATTN_VARIANT(*args(), "base", staging="ldg")
    assert MS_DEFORM_ATTN_VARIANT.launches == 0
