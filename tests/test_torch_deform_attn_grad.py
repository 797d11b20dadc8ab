"""The port's deformable-attention adjoint against the JAX package.

`ms_deform_attn_torch_backward` (the plain adjoint the two CUDA kernels are
held against on the card, and the CPU backward of the model's entry) and
`ms_deform_attn(...).backward()` (the autograd Function the model calls)
against `jax.grad` of `ms_deform_attn_xla` and of the v3 Pallas kernel's
`ms_deform_attn_fused_t2` entry in interpret mode (its custom VJP reaches
`_bwd_dval_kernel` and `_bwd_dloc_kernel`). Same numpy inputs, f32; each
gradient within RTOL x its max |reference| (the same f32 sums in other
orders). The CUDA kernels themselves run only on the card (chip_smoke.py
phase 6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poet_tpu.ops.deform_attn import ms_deform_attn_xla
from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch_backward
from tests.test_deform_attn import _make_inputs
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-5

# (levels, Q, loc spread, trailing pad tokens); spread s maps [-0.2, 1.2]
# to 0.5 +- 0.7 s, so 8.0 puts most points far out of the map
GEOMETRIES = {
    "three_levels": (((6, 9), (4, 5), (2, 3)), 6, 1.0, 0),
    "edge_levels": (((1, 7), (3, 1), (1, 1)), 5, 1.0, 0),
    "far_out_of_map": (((6, 9), (4, 5), (2, 3)), 9, 8.0, 0),
    "pad_tokens": (((5, 7), (3, 4)), 7, 1.0, 5),
}


def _inputs(rng, shapes, Q, spread, pad, B=2, H=4, D=8):
    """Value (with `pad` trailing tokens), locations with the dummy-query
    conventions in the last two queries (-1 boxes, the -10 fill), attention,
    and an upstream gradient dout (B, Q, H*D)."""
    value, shapes, locs, w = _make_inputs(rng, B=B, Q=Q, H=H, D=D, shapes=shapes)
    locs = ((locs - 0.5) * spread + 0.5).astype(np.float32)
    locs[:, -1] = -10.0
    locs[:, -2] = -1.0
    if pad:
        value = np.concatenate([value, rng.normal(size=(B, pad, H, D)).astype(np.float32)], 1)
    dout = rng.normal(size=(B, Q, H * D)).astype(np.float32)
    return value, shapes, locs, w, dout


def _xla_grads(value, shapes, locs, w, dout):
    def f(v, l, a):
        return jnp.sum(ms_deform_attn_xla(v, shapes, l, a) * dout)

    g = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(value), jnp.asarray(locs), jnp.asarray(w))
    return [np.asarray(x) for x in g]


def _fused_t2_grads(value, shapes, locs, w, dout):
    """jax.grad through ms_deform_attn_fused_t2 on staged operands (locT/attnT
    (B, F, Q_pad), Q padded to the kernel's tile with -10), un-staged to the
    public layouts; only the real queries are returned."""
    from jax.experimental.pallas import tpu as pltpu

    from poet_tpu.ops.deform_attn_pallas_v3 import _QT, ms_deform_attn_fused_t2

    B, Q, H, L, P, _ = locs.shape
    Q_pad = -(-Q // _QT) * _QT
    loc2 = np.full((B, Q_pad, H * L * P * 2), -10.0, np.float32)
    loc2[:, :Q] = locs.reshape(B, Q, -1)
    att2 = np.zeros((B, Q_pad, H * L * P), np.float32)
    att2[:, :Q] = w.reshape(B, Q, -1)
    doT = np.zeros((B, Q_pad, dout.shape[-1]), np.float32)
    doT[:, :Q] = dout

    def f(v, lT, aT):
        outT = ms_deform_attn_fused_t2(v, tuple(shapes), lT, aT)     # (B, H*D, Q_pad)
        return jnp.sum(outT * jnp.asarray(doT.transpose(0, 2, 1)))

    with pltpu.force_tpu_interpret_mode():
        gv, gl, ga = jax.grad(f, argnums=(0, 1, 2))(
            jnp.asarray(value), jnp.asarray(loc2.transpose(0, 2, 1)),
            jnp.asarray(att2.transpose(0, 2, 1)))
    gl = np.asarray(gl).transpose(0, 2, 1)[:, :Q].reshape(locs.shape)
    ga = np.asarray(ga).transpose(0, 2, 1)[:, :Q].reshape(w.shape)
    return [np.asarray(gv), gl, ga]


def _plain_grads(value, shapes, locs, w, dout):
    got = ms_deform_attn_torch_backward(torch.from_numpy(value), shapes,
                                        torch.from_numpy(locs), torch.from_numpy(w),
                                        torch.from_numpy(dout))
    return [g.numpy() for g in got]


def _entry_grads(value, shapes, locs, w, dout):
    """ms_deform_attn (the autograd Function) with .backward()."""
    from poet_tpu_torch.ops.deform_attn_cuda import ms_deform_attn

    leaves = [torch.from_numpy(x).requires_grad_() for x in (value, locs, w)]
    ms_deform_attn(leaves[0], shapes, *leaves[1:]).backward(torch.from_numpy(dout))
    return [t.grad.numpy() for t in leaves]


def _assert_close(got, want, names=("d_value", "d_loc", "d_attn"), rtol=RTOL):
    for g, r, name in zip(got, want, names):
        assert g.shape == r.shape, (name, g.shape, r.shape)
        scale = max(float(np.abs(r).max()), 1e-30)
        np.testing.assert_allclose(g, r, rtol=0, atol=rtol * scale, err_msg=name)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("port", ["plain", "entry"])
def test_adjoint_matches_xla_grad(rng, geometry, port):
    value, shapes, locs, w, dout = _inputs(rng, *GEOMETRIES[geometry])
    got = (_plain_grads if port == "plain" else _entry_grads)(value, shapes, locs, w, dout)
    _assert_close(got, _xla_grads(value, shapes, locs, w, dout))


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_adjoint_matches_fused_t2_interpret(rng, geometry):
    value, shapes, locs, w, dout = _inputs(rng, *GEOMETRIES[geometry])
    _assert_close(_plain_grads(value, shapes, locs, w, dout),
                  _fused_t2_grads(value, shapes, locs, w, dout))


def test_adjoint_zero_for_dummy_queries_and_pad_tokens(rng):
    """The dummy queries (-1, -10) get exactly 0 in d_loc and d_attn, and the
    trailing pad tokens exactly 0 in d_value."""
    shapes, Q, spread, pad = GEOMETRIES["pad_tokens"]
    value, shapes, locs, w, dout = _inputs(rng, shapes, Q, spread, pad)
    d_value, d_loc, d_attn = _plain_grads(value, shapes, locs, w, dout)
    S_lv = sum(h * wd for h, wd in shapes)
    assert np.all(d_value[:, S_lv:] == 0.0)
    assert np.all(d_loc[:, -2:] == 0.0) and np.all(d_attn[:, -2:] == 0.0)
    assert np.abs(d_value[:, :S_lv]).max() > 0 and np.abs(d_loc[:, :-2]).max() > 0


def test_adjoint_bf16_value_accumulates_in_f32(rng):
    """bf16 value and dout: d_value comes back in bf16, one rounding of the f32
    sum (2^-8 relative) of the gradient at the bf16-rounded inputs; d_loc and
    d_attn stay f32."""
    value, shapes, locs, w, dout = _inputs(rng, *GEOMETRIES["three_levels"])
    v16 = torch.from_numpy(value).bfloat16()
    do16 = torch.from_numpy(dout).bfloat16()
    got = ms_deform_attn_torch_backward(v16, shapes, torch.from_numpy(locs),
                                        torch.from_numpy(w), do16)
    assert got[0].dtype == torch.bfloat16
    assert got[1].dtype == got[2].dtype == torch.float32
    want = _xla_grads(v16.float().numpy(), shapes, locs, w, do16.float().numpy())
    scale = float(np.abs(want[0]).max())
    np.testing.assert_allclose(got[0].float().numpy(), want[0], rtol=2 ** -8,
                               atol=RTOL * scale, err_msg="d_value")
    _assert_close([g.numpy() for g in got[1:]], want[1:], names=("d_loc", "d_attn"))


def test_entry_backward_on_cpu_builds_and_launches_nothing(rng):
    from poet_tpu_torch.ops import deform_attn_cuda as dac

    value, shapes, locs, w, dout = _inputs(rng, *GEOMETRIES["three_levels"])
    before = [k.launches for k in dac.KERNELS]
    _entry_grads(value, shapes, locs, w, dout)
    assert [k.launches for k in dac.KERNELS] == before
    assert all(lib._lib is None for lib in dac.LIBRARIES)


@pytest.mark.parametrize("kernel", ["MS_DEFORM_ATTN_DVALUE", "MS_DEFORM_ATTN_DLOC",
                                    "MS_DEFORM_ATTN_MERGED"])
def test_adjoint_kernel_wrappers_reject_cpu_tensors(rng, kernel):
    from poet_tpu_torch.ops import deform_attn_cuda as dac

    value, shapes, locs, w, dout = _inputs(rng, *GEOMETRIES["three_levels"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(dac, kernel)(torch.from_numpy(value), shapes,
                             torch.from_numpy(locs), torch.from_numpy(w),
                             torch.from_numpy(dout))
    assert dac.BWD_LIB._lib is None
