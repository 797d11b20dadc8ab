"""The port's stem conv entry on the CPU (its plain version) against the TPU
kernel `poet_tpu/ops/conv_stem_pallas.py` in interpret mode.

Rows: every configuration of `tests/test_conv_stem_pallas.py` (the ResNet
stem, the YOLOv4-CSP entry convs, an asymmetric 5x3/2 and a 1x1) plus a
leaky row, at B=2 and 38x52 (not multiples of any tile). f32 within 1e-5 of
the output's max |value|: the same f32 sums in another order. bf16: both
round an f32 result once, so they differ by at most one bf16 ulp (2^-7 of
the value) where the two f32 sums fall on either side of a rounding edge.
The CUDA kernel itself runs only on the card (`chip_smoke.py` phase 12).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poet_tpu.ops.conv_stem_pallas import conv_stem_pallas
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

B, H, W = 2, 38, 52
F32_RTOL = 1e-5
CONFIGS = [
    # (kh, kw, C, F, stride, padding, activation)
    (7, 7, 3, 64, 2, ((3, 3), (3, 3)), "relu"),     # ResNet-50 stem
    (3, 3, 3, 32, 1, ((1, 1), (1, 1)), "mish"),     # YOLOv4-CSP layer 0
    (3, 3, 32, 64, 2, ((1, 1), (1, 1)), "mish"),    # YOLOv4-CSP layer 1
    (5, 3, 4, 16, 2, ((2, 1), (1, 2)), None),       # asymmetric everything
    (1, 1, 8, 24, 1, ((0, 0), (0, 0)), "relu"),     # degenerate 1x1
    (3, 3, 32, 64, 1, ((1, 1), (1, 1)), "leaky"),   # YOLOv4-CSP layer 3, leaky
]


def _inputs(kh, kw, C, F, stride, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((kh, kw, C, F)) * 0.1).astype(np.float32)
    b = rng.standard_normal((F,)).astype(np.float32)
    return x, w, b


def _port(x, w, b, **kw):
    from poet_tpu_torch.ops.conv_stem_cuda import conv_stem

    def t(a):
        return a if a is None or isinstance(a, torch.Tensor) else torch.from_numpy(a)

    return conv_stem(t(x), t(w), t(b), **kw)


@pytest.mark.parametrize("kh,kw,C,F,stride,padding,act", CONFIGS)
def test_plain_matches_the_pallas_kernel_f32(kh, kw, C, F, stride, padding, act):
    x, w, b = _inputs(kh, kw, C, F, stride, seed=kh * 100 + C * 10 + stride)
    want = np.asarray(conv_stem_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                       stride=stride, padding=padding, activation=act,
                                       interpret=True))
    got = _port(x, w, b, stride=stride, padding=padding, activation=act)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=F32_RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("kh,kw,C,F,stride,padding,act", [CONFIGS[0], CONFIGS[3]])
def test_plain_matches_the_pallas_kernel_bf16_no_bias(kh, kw, C, F, stride, padding, act):
    x, w, _ = _inputs(kh, kw, C, F, stride, seed=7)
    x16, w16 = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = conv_stem_pallas(x16, w16, None, stride=stride, padding=padding, activation=act,
                            interpret=True)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want, np.float32)
    got = _port(torch.from_numpy(np.asarray(x16, np.float32)).bfloat16(),
                torch.from_numpy(np.asarray(w16, np.float32)).bfloat16(), None,
                stride=stride, padding=padding, activation=act)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=F32_RTOL * float(np.abs(want).max()))


def test_out_dtype_rounds_once():
    """An f32 output of bf16 inputs is the f32 result itself (no bf16 step)."""
    x, w, b = _inputs(3, 3, 3, 32, 1, seed=3)
    x16, w16 = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    kw = dict(stride=1, padding=((1, 1), (1, 1)), activation="mish")
    wide = _port(x16, w16, torch.from_numpy(b), out_dtype=torch.float32, **kw)
    ref = _port(x16.float(), w16.float(), torch.from_numpy(b), **kw)
    assert wide.dtype == torch.float32
    np.testing.assert_array_equal(wide.numpy(), ref.numpy())


def test_mish_is_the_one_exp_form():
    """`mish` is JAX's exact rewrite (clamp at 25, the final where), not
    `F.mish`; it stays finite at any input. Tolerance 1e-6 absolute: the two
    exps differ by an ulp, and 1 - 2 / ((1 + e)^2 + 1) cancels for x < 0."""
    from poet_tpu.models.yolov4 import mish as jmish
    from poet_tpu_torch.ops.conv_stem_cuda import mish

    x = np.concatenate([np.linspace(-30, 30, 4001), [-1e30, -88.0, 24.999, 25.0, 25.001, 1e30]]
                       ).astype(np.float32)
    got = mish(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jmish(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_kernel_refuses_cpu_tensors_and_the_entry_counts_no_launch():
    from poet_tpu_torch.ops.conv_stem_cuda import CONV_STEM_FWD
    from poet_tpu_torch.ops.cuda_build import STEM_LIB

    x, w, b = _inputs(3, 3, 3, 32, 1, seed=1)
    before = CONV_STEM_FWD.launches
    _port(x, w, b, stride=1, padding=((1, 1), (1, 1)), activation="mish")
    with pytest.raises(ValueError, match="CUDA tensors"):
        CONV_STEM_FWD(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                      stride=1, padding=((1, 1), (1, 1)), activation="mish")
    assert CONV_STEM_FWD.launches == before and STEM_LIB._lib is None


def test_entry_refuses_inputs_that_require_grad():
    """No gradient, as JAX's custom_vjp raises under differentiation."""
    from poet_tpu_torch.ops.conv_stem_cuda import conv_stem

    x, w, b = _inputs(3, 3, 3, 8, 1, seed=2)
    w = torch.from_numpy(w).requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        conv_stem(torch.from_numpy(x), w, torch.from_numpy(b), stride=1,
                  padding=((1, 1), (1, 1)))
    with pytest.raises(ValueError, match="activation"):
        conv_stem(torch.from_numpy(x), w.detach(), None, activation="gelu")
