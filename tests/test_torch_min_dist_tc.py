"""A model of the min-distance kernel's tensor-core ranking, on the CPU.

`csrc/min_dist_sq_fwd.cu` runs only on the card, so these tests restate its
algorithm in numpy and hold that model against the port's plain version
(`min_dist_sq_plain`) and against JAX's Pallas kernel in interpret mode:
  * the ranking s(g, e) = [gx, gy, gz, 1] . [-2ex, -2ey, -2ez, |e|^2], a
    product of depth 4 in the 3xTF32 split, TF32 rounding emulated bit for
    bit (`tests/test_torch_conv_stem_tc.py:tf32`): the small products as
    one depth-8 product [A_hi | A_lo] . [B_lo ; B_hi] (m16n8k8), which
    seeds the big one A_hi B_hi (m16n8k4);
  * the thread structure: a thread sees columns 2t, 2t+1 of every n8 tile,
    keeps per row the min of its 8 columns in a group of four tiles and
    the first group that gave its running minimum (strict <: a NaN never
    wins); est points past M are far padding columns;
  * the winners' direct distances (8 per thread), recomputed and merged
    over the row's 4 threads; the est cloud's NaN flag and the gt point's own NaN check.
Cases: centred, uncentred ~1 m from the origin, exact duplicates (exactly
0), near-duplicates within 1e-4 m, ties (a gt point midway between two est
points), NaN in est and in gt, and M that is not a multiple of 8 or of the
256-point est tile. Tolerance: `chip_smoke.py`'s NN_RTOL, 2e-6 of the
case's max |gt|^2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_conv_stem_tc import split
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

NN_RTOL = 2e-6
PALLAS_RTOL = 2e-6          # tests/test_torch_min_dist.py: the TPU form's own rounding
FAR = np.float32(3.0e38)    # the kernel's padding column


def model(gt: np.ndarray, est: np.ndarray) -> np.ndarray:
    """The kernel's arithmetic: gt (P, N, 3), est (P, M, 3) f32 -> (P, N)."""
    P, N, _ = gt.shape
    M = est.shape[1]
    Mp = -(-M // 32) * 32              # whole groups of four n8 tiles
    a = np.concatenate([gt, np.ones((P, N, 1), np.float32)], -1)              # (P, N, 4)
    b = np.concatenate([-2 * est, (est * est).sum(-1, keepdims=True, dtype=np.float32)], -1)
    b = np.concatenate([b, np.tile(np.array([0, 0, 0, FAR], np.float32), (P, Mp - M, 1))], 1)
    ah, al = split(a)
    bh, bl = split(b)

    def mma(u, v, c):                 # d = u . v + c, one rounding to f32
        return (np.einsum("pnk,pmk->pnm", u.astype(np.float64), v) + c).astype(np.float32)

    with np.errstate(invalid="ignore"):
        # small = [A_hi | A_lo] . [B_lo ; B_hi] (one k8 product), then A_hi B_hi + small
        small = mma(np.concatenate([ah, al], -1), np.concatenate([bl, bh], -1), np.float32(0))
        s = mma(ah, bh, small)                                                # (P, N, Mp)
        # thread t of a row sees columns 2t, 2t+1 of each n8 tile; a group is
        # four tiles: (P, N, groups, tile, thread, column)
        v = np.fmin.reduce(s.reshape(P, N, Mp // 32, 4, 4, 2), axis=(3, 5))   # fminf
        v = np.where(np.isnan(v), np.inf, v)                                  # `<` never picks NaN
        win = v.argmin(axis=2)          # (P, N, thread): the first group of its running minimum
        m = (win[..., None, None] * 32 + np.arange(4)[:, None] * 8
             + 2 * np.arange(4)[:, None, None] + np.arange(2))                # (P, N, 4, 4, 2)
        m = m.reshape(P, N, 4, 8)                                             # per thread: 8
        real = m < M
        e = np.take_along_axis(est[:, None, :, :], np.minimum(m, M - 1).reshape(P, N, 32, 1),
                               axis=2).reshape(P, N, 4, 8, 3)
        d = e - gt[:, :, None, None, :]
        d = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])
        d = np.where(real, d, np.inf).min(axis=(2, 3))
    nan = np.isnan(est).any(axis=(1, 2))[:, None] | np.isnan(gt).any(-1)
    return np.where(nan, np.float32(np.nan), d).astype(np.float32)


def _clouds(P, N, M, kind, seed=0):
    """The kinds of `chip_smoke.py:nn_inputs`, made with numpy."""
    rng = np.random.default_rng(seed)
    gt = (0.05 * rng.standard_normal((P, N, 3))).astype(np.float32)
    est = (0.05 * rng.standard_normal((P, M, 3))).astype(np.float32)
    pick = np.take_along_axis(est, rng.integers(0, M, (P, N, 1)), 1)
    if kind == "uncentred":
        shift = np.array([0.3, -0.2, 1.0], np.float32)
        gt, est = gt + shift, est + shift + np.float32(0.01)
    elif kind == "duplicates":
        gt[:, 0::2] = pick[:, 0::2]
    elif kind == "near":
        noise = 1e-4 * (2 * rng.random((P, N, 3)) - 1) / np.sqrt(3)
        gt[:, 0::2] = (pick + noise).astype(np.float32)[:, 0::2]
    elif kind == "ties":
        half = rng.standard_normal((P, N // 2, 3))
        half = (1e-3 * half / np.linalg.norm(half, axis=-1, keepdims=True)).astype(np.float32)
        mid = gt[:, 0::2][:, :N // 2]
        est[:, 0:N // 2 * 2:2], est[:, 1:N // 2 * 2:2] = mid + half, mid - half
    elif kind == "nan":
        est[1, M // 2, 2] = np.nan
        gt[2, N // 3, 0] = np.nan
    return np.ascontiguousarray(gt), np.ascontiguousarray(est)


def _plain(gt, est):
    from poet_tpu_torch.ops.nn_cuda import min_dist_sq_plain

    return min_dist_sq_plain(torch.from_numpy(gt), torch.from_numpy(est)).numpy()


# (P, N, M, kind): M past a multiple of 8, of a group and of the 256-point est tile
CASES = [
    (3, 200, 300, "centred"),
    (1, 1, 1, "centred"),
    (2, 130, 513, "centred"),
    (3, 600, 7, "centred"),
    (2, 9, 1100, "centred"),
    (3, 300, 400, "uncentred"),
    (3, 300, 250, "duplicates"),
    (3, 300, 250, "near"),
    (3, 200, 500, "ties"),
    (4, 120, 150, "nan"),
]


@pytest.mark.parametrize("P,N,M,kind", CASES)
def test_model_matches_the_plain_version(P, N, M, kind):
    gt, est = _clouds(P, N, M, kind)
    ref, got = _plain(gt, est), model(gt, est)
    assert got.shape == (P, N) and got.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    scale = float((np.nan_to_num(gt, nan=0.0).astype(np.float64) ** 2).sum(-1).max())
    np.testing.assert_allclose(got[ok], ref[ok], rtol=0, atol=NN_RTOL * scale)
    assert (got[ok] >= 0).all()
    if kind == "duplicates":
        assert (got[:, 0::2] == 0).all()
    if kind == "nan":
        assert np.isnan(got[1]).all() and np.isnan(got).sum() == N + 1


@pytest.mark.parametrize("P,N,M,kind", [(2, 300, 300, "centred"), (3, 513, 1025, "uncentred")])
def test_model_matches_the_pallas_kernel(P, N, M, kind):
    from jax.experimental.pallas import tpu as pltpu

    from poet_tpu.ops.nn_pallas import min_dist_sq_pallas

    gt, est = _clouds(P, N, M, kind, seed=5)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(min_dist_sq_pallas(jnp.asarray(gt), jnp.asarray(est)))
    scale = float((gt.astype(np.float64) ** 2).sum(-1).max())
    np.testing.assert_allclose(model(gt, est), want, rtol=0, atol=PALLAS_RTOL * scale)


def test_ranking_error_is_f32_sized():
    """The 3xTF32 ranking keeps s within a few 2^-23 of |e|^2 + 2 |g||e|,
    where the hi product alone is more than 2^-16 off: the bound on a wrong
    winner's excess in the kernel's note."""
    gt, est = _clouds(2, 64, 96, "uncentred", seed=3)
    a = np.concatenate([gt, np.ones((2, 64, 1), np.float32)], -1)
    b = np.concatenate([-2 * est, (est * est).sum(-1, keepdims=True)], -1)
    exact = np.einsum("pnk,pmk->pnm", a.astype(np.float64), b.astype(np.float64))
    ah, al = split(a)
    bh, bl = split(b)
    s = sum(np.einsum("pnk,pmk->pnm", u.astype(np.float64), v)
            for u, v in ((al, bh), (ah, bl), (ah, bh))).astype(np.float32)
    mag = (np.abs(b[:, None, :, 3]) + 2 * np.linalg.norm(gt, axis=-1)[..., None]
           * np.linalg.norm(est, axis=-1)[:, None, :])
    assert np.abs(s - exact).max() / mag.max() < 8 * 2.0 ** -23
    one = np.einsum("pnk,pmk->pnm", ah.astype(np.float64), bh)
    assert np.abs(one - exact).max() / mag.max() > 2.0 ** -16
