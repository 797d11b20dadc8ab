"""The min-distance (ADD-S nearest neighbour) op of the port against the TPU
kernel and numpy, on the CPU.

`ops/nn_cuda.py:min_dist_sq_plain` (the direct difference form, chunked
over est) against `poet_tpu/ops/nn_pallas.py:min_dist_sq_pallas` in
interpret mode (the TPU kernel's |g|^2 + |e|^2 - 2 g.e expansion, padded to
its 512-point gt and 1024-point est tiles) and against a float64 numpy
search, over shapes on both sides of those tiles; NaN propagation; and the
CUDA entry refusing CPU tensors. The CUDA kernel itself is held against the
plain version on the card by `chip_smoke.py` phase 15.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

# tolerances relative to the case's max |gt|^2 (clouds of one extent, so
# every squared distance is <= 4 max|gt|^2):
# plain (f32, direct form) vs numpy float64: a few f32 ulps of a distance
PLAIN_RTOL = 1e-6
# the TPU kernel's expansion cancels |g|^2 + |e|^2 against 2 g.e: its
# rounding is a few ulps of |g|^2 + |e|^2 rather than of the distance
PALLAS_RTOL = 2e-6


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _clouds(P, N, M, seed=0):
    rng = np.random.default_rng(seed)
    return ((0.05 * rng.normal(size=(P, N, 3))).astype(np.float32),
            (0.05 * rng.normal(size=(P, M, 3))).astype(np.float32))


def _numpy(gt, est):
    d = ((gt.astype(np.float64)[:, :, None, :] - est.astype(np.float64)[:, None, :, :]) ** 2)
    return d.sum(-1).min(-1)


def _pallas(gt, est):
    from poet_tpu.ops.nn_pallas import min_dist_sq_pallas

    return np.asarray(min_dist_sq_pallas(jnp.asarray(gt), jnp.asarray(est)))


# (P, N, M): inside one tile, across the 512 gt / 1024 est tiles, one point,
# M << N and M >> N
SHAPES = [(2, 300, 300), (3, 513, 1025), (1, 1, 1), (2, 1100, 7), (2, 9, 2100)]


@pytest.mark.parametrize("P,N,M", SHAPES)
def test_plain_matches_the_tpu_kernel_and_numpy(P, N, M):
    from poet_tpu_torch.ops.nn_cuda import min_dist_sq_plain

    gt, est = _clouds(P, N, M)
    scale = float((gt.astype(np.float64) ** 2).sum(-1).max())
    plain = min_dist_sq_plain(torch.from_numpy(gt), torch.from_numpy(est)).numpy()
    assert plain.shape == (P, N) and plain.dtype == np.float32
    np.testing.assert_allclose(plain, _numpy(gt, est), rtol=0, atol=PLAIN_RTOL * scale)
    np.testing.assert_allclose(plain, _pallas(gt, est), rtol=0, atol=PALLAS_RTOL * scale)


def test_plain_chunks_over_est(monkeypatch):
    """Chunking over est (to bound the (P, N, chunk) temporaries) changes
    nothing: a chunk of 3 points gives the unchunked answer bit for bit."""
    from poet_tpu_torch.ops import nn_cuda

    gt, est = (torch.from_numpy(a) for a in _clouds(2, 40, 50))
    whole = nn_cuda.min_dist_sq_plain(gt, est)
    monkeypatch.setattr(nn_cuda, "PLAIN_CHUNK_ELEMENTS", 2 * 40 * 3)
    torch.testing.assert_close(nn_cuda.min_dist_sq_plain(gt, est), whole, rtol=0, atol=0)


def test_duplicated_points_are_exactly_zero():
    """The direct difference form is exactly 0 for a duplicated point (the
    expansion leaves rounding residue there)."""
    from poet_tpu_torch.ops.nn_cuda import min_dist_sq_plain

    gt, est = _clouds(2, 64, 100)
    gt[:, ::2] = est[:, 3:3 + 32]
    got = min_dist_sq_plain(torch.from_numpy(gt), torch.from_numpy(est)).numpy()
    assert (got[:, ::2] == 0).all() and (got[:, 1::2] > 0).all()


def test_nan_propagates_as_in_the_tpu_kernel():
    """A NaN est point makes its whole cloud's row NaN and a NaN gt point its
    own entry, in the plain version as in the TPU kernel (jnp.minimum
    propagates NaN): a diverged pose must not score a finite ADD-S."""
    from poet_tpu_torch.ops.nn_cuda import min_dist_sq

    gt, est = _clouds(3, 520, 1030)
    est[1, 700, 2] = np.nan
    gt[2, 17, 0] = np.nan
    got = min_dist_sq(torch.from_numpy(gt), torch.from_numpy(est)).numpy()
    want = _pallas(gt, est)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1]).all() and np.isnan(got).sum() == 520 + 1
    ok = ~np.isnan(want)
    scale = float((gt[0].astype(np.float64) ** 2).sum(-1).max())
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=PALLAS_RTOL * scale)


def test_cuda_entry_refuses_cpu_tensors_and_counts_nothing():
    from poet_tpu_torch.ops.nn_cuda import MIN_DIST_SQ, min_dist_sq

    gt, est = (torch.from_numpy(a) for a in _clouds(1, 8, 9))
    n0 = MIN_DIST_SQ.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        MIN_DIST_SQ(gt, est)
    min_dist_sq(gt, est)                      # the CPU entry: the plain version
    assert MIN_DIST_SQ.launches == n0


@pytest.mark.parametrize("gt_shape,est_shape,dtype,error", [
    ((1, 8, 3), (2, 9, 3), torch.float32, ValueError),     # pose counts differ
    ((1, 8, 2), (1, 9, 3), torch.float32, ValueError),     # not 3-D points
    ((1, 8, 3), (1, 0, 3), torch.float32, ValueError),     # empty est cloud
    ((1, 8, 3), (1, 9, 3), torch.float64, TypeError),
])
def test_operands_are_checked(gt_shape, est_shape, dtype, error):
    from poet_tpu_torch.ops.nn_cuda import min_dist_sq

    with pytest.raises(error):
        min_dist_sq(torch.zeros(gt_shape, dtype=dtype), torch.zeros(est_shape, dtype=dtype))
