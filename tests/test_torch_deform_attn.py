"""The port's deformable-attention core against the JAX package.

`poet_tpu_torch.ops.deform_attn.ms_deform_attn_torch` (the plain version the
CUDA kernel is held against on the card, and the CPU path of the model's
entry) against `ms_deform_attn_xla` and against the v3 Pallas kernel's
`ms_deform_attn_fused_t2` entry in interpret mode. Same numpy inputs, f32,
atol 2e-5 (the tolerance the JAX formulations hold among themselves).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from poet_tpu.ops.deform_attn import ms_deform_attn_xla
from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch
from tests.test_deform_attn import _make_inputs
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

ATOL = 2e-5

GEOMETRIES = [
    # (shapes, Q, loc spread): loc spread s maps [-0.2, 1.2] to 0.5 +- 0.7 s
    (((6, 9), (4, 5), (2, 3)), 6, 1.0),
    (((1, 7), (3, 1), (1, 1)), 5, 1.0),       # the edge levels of the chip check
    (((8, 8),), 7, 1.0),
    (((6, 9), (4, 5), (2, 3)), 9, 8.0),       # far out of the map
    (((5, 7), (3, 4)), 1, 2.5),
]


def _inputs(rng, shapes, Q, spread, B=2, H=4, D=8):
    value, shapes, locs, w = _make_inputs(rng, B=B, Q=Q, H=H, D=D, shapes=shapes)
    locs = ((locs - 0.5) * spread + 0.5).astype(np.float32)
    return value, shapes, locs, w


def _port(value, shapes, locs, w):
    return ms_deform_attn_torch(torch.from_numpy(value), shapes, torch.from_numpy(locs),
                                torch.from_numpy(w)).numpy()


@pytest.mark.parametrize("shapes,Q,spread", GEOMETRIES)
def test_plain_matches_xla(rng, shapes, Q, spread):
    value, shapes, locs, w = _inputs(rng, shapes, Q, spread)
    ref = np.asarray(ms_deform_attn_xla(jnp.asarray(value), shapes, jnp.asarray(locs),
                                        jnp.asarray(w)))
    np.testing.assert_allclose(_port(value, shapes, locs, w), ref, atol=ATOL)


def _fused_t2(value, shapes, locs, w):
    """ms_deform_attn_fused_t2 on staged operands: locT/attnT (B, F, Q_pad)
    with rows (h, l, p[, xy]), Q padded to the kernel's tile with -10."""
    from jax.experimental.pallas import tpu as pltpu

    from poet_tpu.ops.deform_attn_pallas_v3 import _QT, ms_deform_attn_fused_t2

    B, Q, H, L, P, _ = locs.shape
    D = value.shape[-1]
    Q_pad = -(-Q // _QT) * _QT
    loc2 = np.full((B, Q_pad, H * L * P * 2), -10.0, np.float32)
    loc2[:, :Q] = locs.reshape(B, Q, -1)
    att2 = np.zeros((B, Q_pad, H * L * P), np.float32)
    att2[:, :Q] = w.reshape(B, Q, -1)
    with pltpu.force_tpu_interpret_mode():
        outT = ms_deform_attn_fused_t2(jnp.asarray(value), tuple(shapes),
                                       jnp.asarray(loc2.transpose(0, 2, 1)),
                                       jnp.asarray(att2.transpose(0, 2, 1)))
    outT = np.asarray(outT)                                   # (B, H*D, Q_pad)
    return outT.transpose(0, 2, 1)[:, :Q].reshape(B, Q, H * D)


@pytest.mark.parametrize("shapes,Q,spread", [GEOMETRIES[0], GEOMETRIES[1], GEOMETRIES[3]])
def test_plain_matches_fused_t2_interpret(rng, shapes, Q, spread):
    value, shapes, locs, w = _inputs(rng, shapes, Q, spread)
    ref = _fused_t2(value, shapes, locs, w)
    np.testing.assert_allclose(_port(value, shapes, locs, w), ref, atol=ATOL)


def test_plain_trailing_pad_tokens_and_dummy_queries(rng):
    """S beyond the levels (pad tokens) is never read, and queries at the
    dummy conventions (-1 boxes, -10 padding) sample nothing."""
    value, shapes, locs, w = _inputs(rng, ((4, 5), (2, 3)), 4, 1.0)
    padded = np.concatenate([value, rng.normal(size=(2, 7, 4, 8)).astype(np.float32)], 1)
    np.testing.assert_allclose(_port(padded, shapes, locs, w),
                               _port(value, shapes, locs, w), atol=0)
    locs[:, 1] = -1.0
    locs[:, 2] = -10.0
    out = _port(value, shapes, locs, w)
    assert np.all(out[:, 1:3] == 0.0)


def test_plain_bf16_value_accumulates_in_f32(rng):
    value, shapes, locs, w = _inputs(rng, ((6, 9), (4, 5), (2, 3)), 6, 1.0)
    v16 = torch.from_numpy(value).bfloat16()
    got = ms_deform_attn_torch(v16, shapes, torch.from_numpy(locs), torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    ref = _port(v16.float().numpy(), shapes, locs, w)
    # one bf16 rounding of the f32 result: half an ulp, 2^-9 relative
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -8, atol=1e-6)


def test_cuda_entry_imports_without_nvcc_and_dispatches_cpu(rng):
    """Importing the kernel module builds nothing; CPU tensors take the plain
    version through the model's entry and never count a launch."""
    from poet_tpu_torch.ops import deform_attn_cuda as dac

    assert all(lib._lib is None and lib.source.is_file() for lib in dac.LIBRARIES)
    value, shapes, locs, w = _inputs(rng, ((4, 5), (2, 3)), 3, 1.0)
    before = [k.launches for k in dac.KERNELS]
    got = dac.ms_deform_attn(torch.from_numpy(value), shapes, torch.from_numpy(locs),
                             torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, _port(value, shapes, locs, w))
    assert [k.launches for k in dac.KERNELS] == before
    assert all(lib._lib is None for lib in dac.LIBRARIES)


def test_cuda_kernel_path_rejects_cpu_tensors(rng):
    from poet_tpu_torch.ops.deform_attn_cuda import FWD_LIB, MS_DEFORM_ATTN_FWD

    value, shapes, locs, w = _inputs(rng, ((4, 5), (2, 3)), 3, 1.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        MS_DEFORM_ATTN_FWD(torch.from_numpy(value), shapes, torch.from_numpy(locs),
                           torch.from_numpy(w))
    assert FWD_LIB._lib is None
