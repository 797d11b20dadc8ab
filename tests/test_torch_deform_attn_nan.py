"""NaN sampling locations (ROADMAP C1): the port's rule against `jax.grad` of
`poet_tpu.ops.deform_attn.ms_deform_attn_xla`, on the CPU.

The rule (`csrc/ms_deform_attn_point.cuh`, `ops/deform_attn.py`): a point
with a NaN or infinite pixel coordinate makes its (b, q, h) output row NaN;
its d_attn and both of its d_loc coordinates are NaN; it adds nothing to
d_value; every other entry is unchanged. JAX gives the same NaN output rows
and NaN d_attn; which d_value tokens turn NaN and whether d_loc's other
coordinate is NaN hang on XLA's cast of a NaN index to an integer, and there
the port states its own rule: d_value as with the point removed.

The case is ROADMAP C1's: B=1, levels (4, 4) and (2, 2), H=2, D=4, Q=3,
L=P=2, the x of loc[0, 1, 0, 0, 1] NaN; plus an infinite and a both-NaN
point. The kernels are held to the same rule on the card (chip_smoke.py
phases 3, 6, 18, 19, 21).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poet_tpu.ops.deform_attn import ms_deform_attn_xla
from poet_tpu_torch.ops.deform_attn import (
    ms_deform_attn_torch,
    ms_deform_attn_torch_backward,
    nonfinite_points,
)
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

SHAPES = ((4, 4), (2, 2))
B, H, D, Q, L, P = 1, 2, 4, 3, 2, 2
TOL = 1e-5


def _case(points):
    """Seeded inputs with the listed (index, coordinate, value) overrides."""
    rng = np.random.default_rng(0)
    value = rng.standard_normal((B, 20, H, D)).astype(np.float32)
    locs = rng.uniform(0, 1, (B, Q, H, L, P, 2)).astype(np.float32)
    attn = rng.uniform(size=(B, Q, H, L, P)).astype(np.float32)
    dout = rng.standard_normal((B, Q, H * D)).astype(np.float32)
    for idx, coord, v in points:
        locs[idx + (coord,)] = v
    return value, locs, attn, dout


def _jax(value, locs, attn, dout):
    def f(v, l, a):
        return jnp.vdot(ms_deform_attn_xla(v, SHAPES, l, a), dout)

    out = np.asarray(ms_deform_attn_xla(value, SHAPES, locs, attn))
    return out, [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(value, locs, attn)]


def _port(value, locs, attn, dout):
    args = [torch.from_numpy(x) for x in (value, locs, attn)]
    out = ms_deform_attn_torch(args[0], SHAPES, *args[1:]).numpy()
    grads = ms_deform_attn_torch_backward(*args[:1], SHAPES, *args[1:], torch.from_numpy(dout))
    return out, [g.numpy() for g in grads]


def _finite_close(got, want, name):
    both = np.isfinite(got) & np.isfinite(want)
    np.testing.assert_allclose(got[both], want[both], rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want[both]).max())),
                               err_msg=name)


POINT = (0, 1, 0, 0, 1)                     # (b, q, h, l, p) of ROADMAP C1's case


@pytest.mark.parametrize("points", [
    [(POINT, 0, np.nan)],                                      # C1's case: x NaN
    [(POINT, 1, np.nan)],                                      # y NaN
    [(POINT, 0, np.nan), (POINT, 1, np.nan)],                  # both
    [(POINT, 0, np.inf)],                                      # infinite: JAX's x - floor(x) is NaN
    [(POINT, 0, np.nan), ((0, 2, 1, 1, 0), 1, -np.inf)],       # two rows
], ids=["x", "y", "xy", "inf", "two rows"])
def test_rule_against_jax_grad(points):
    value, locs, attn, dout = _case(points)
    bad = np.zeros((B, Q, H, L, P), bool)
    for idx, _, _ in points:
        bad[idx] = True
    rows = np.repeat(bad.reshape(B, Q, H, -1).any(-1)[..., None], D, -1).reshape(B, Q, H * D)

    out_j, (dv_j, dl_j, da_j) = _jax(value, locs, attn, dout)
    out_p, (dv_p, dl_p, da_p) = _port(value, locs, attn, dout)
    # the forward: NaN rows exactly where JAX has them, the rest equal
    np.testing.assert_array_equal(np.isnan(out_p), rows)
    np.testing.assert_array_equal(np.isnan(out_j), rows)
    _finite_close(out_p, out_j, "out")
    # d_attn: NaN at the point, as JAX's; elsewhere JAX's
    np.testing.assert_array_equal(np.isnan(da_p), bad)
    np.testing.assert_array_equal(np.isnan(da_j), bad)
    _finite_close(da_p, da_j, "d_attn")
    # d_loc: both coordinates NaN at the point (the stated rule; JAX's NaN
    # lies within them), elsewhere JAX's
    np.testing.assert_array_equal(np.isnan(dl_p), np.repeat(bad[..., None], 2, -1))
    assert not (np.isnan(dl_j) & ~np.isnan(dl_p)).any()
    _finite_close(dl_p, dl_j, "d_loc")
    # d_value: finite; JAX's where JAX's is finite; the point removed where not
    assert np.isfinite(dv_p).all()
    _finite_close(dv_p, dv_j, "d_value")
    removed = attn.copy()
    removed[bad] = 0.0
    _, (dv_r, _, _) = _jax(value, np.where(np.isfinite(locs), locs, 0.5), removed, dout)
    np.testing.assert_allclose(dv_p, dv_r, rtol=0, atol=TOL * float(np.abs(dv_r).max()))


def test_jax_reproduces_roadmap_c1():
    """The case as ROADMAP C1 records it: JAX's NaN output row for (query 1,
    head 0), NaN d_attn at the point, d_loc NaN in y and finite in x, and NaN
    d_value at tokens 0, 1, 4, 5 of level 0, head 0 (XLA on the CPU clamps
    the NaN x index to column 0)."""
    value, locs, attn, dout = _case([(POINT, 0, np.nan)])
    out, (dv, dl, da) = _jax(value, locs, attn, dout)
    assert np.isnan(out[0, 1, :D]).all() and np.isfinite(np.delete(out[0, 1], range(D))).all()
    assert np.isnan(dl[POINT][1]) and np.isfinite(dl[POINT][0])
    assert sorted(set(np.argwhere(np.isnan(dv))[:, 1].tolist())) == [0, 1, 4, 5]
    assert np.isnan(da[POINT])


def test_nonfinite_points_is_the_pixel_coordinate():
    """NaN, +-inf, and a finite location whose pixel coordinate overflows."""
    locs = torch.full((1, 1, 1, 2, 1, 2), 0.5)
    locs[0, 0, 0, 0, 0, 0] = float("nan")
    assert nonfinite_points(SHAPES, locs).tolist() == [[[[[True], [False]]]]]
    locs[0, 0, 0, 0, 0, 0] = 0.5
    locs[0, 0, 0, 1, 0, 1] = 3e38                     # x 2 (the level's W) overflows
    locs[0, 0, 0, 1, 0, 0] = 3e38
    assert nonfinite_points(SHAPES, locs).tolist() == [[[[[False], [True]]]]]


def test_entry_autograd_follows_the_rule():
    """The model's entries on CPU tensors (gather and dense routes) take the
    plain version: autograd gives the rule's gradients."""
    from poet_tpu_torch.ops.deform_attn_cuda import ms_deform_attn
    from poet_tpu_torch.ops.deform_attn_dense_cuda import ms_deform_attn_dense

    value, locs, attn, dout = _case([(POINT, 0, np.nan)])
    _, want = _port(value, locs, attn, dout)
    for entry in (ms_deform_attn, ms_deform_attn_dense):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (value, locs, attn)]
        out = entry(leaves[0], SHAPES, *leaves[1:])
        assert torch.isnan(out[0, 1, :D]).all()
        out.backward(torch.from_numpy(dout))
        for leaf, w in zip(leaves, want):
            np.testing.assert_array_equal(np.isnan(leaf.grad.numpy()), np.isnan(w))
            _finite_close(leaf.grad.numpy(), w, entry.__name__)
