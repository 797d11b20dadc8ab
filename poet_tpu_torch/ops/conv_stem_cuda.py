"""Fused small-C stem convolution: the entry the darknet body calls and its Hopper kernel's wrapper.

`conv_stem` is the contract of `poet_tpu/ops/conv_stem_pallas.py:
conv_stem_pallas`: x (B, H, W, C) NHWC, w (kh, kw, C, F) HWIO in x's dtype,
bias (F,) f32 or None, a stride and zero padding ((pt, pb), (pl, pr));
f32 accumulation, + bias, the activation in f32 (None, 'relu', the
one-exp `mish`, 'leaky' 0.1), one rounding to `out_dtype` (default x's):
  * it is the custom operator `torch.ops.poet_tpu_torch.conv_stem` (a fake
    implementation for tracing, so a `torch.export`ed detector holds it);
  * CPU tensors run the plain version, `conv_stem_torch`;
  * CUDA tensors launch `csrc/conv_stem_fwd.cu` through `CONV_STEM_FWD`, or
    raise. There is no fallback from one to the other.
There is no gradient: every caller is a frozen backbone's entry conv, and
the JAX op raises under differentiation too, so an input that requires
grad is refused on either device.

The kernel replaces the TPU kernel `conv_stem_pallas.py:_kernel`. It is an
implicit GEMM on the tensor cores for both dtypes (bf16 mma.sync; f32 as
3xTF32), bound by the bytes it moves; the design note is in the source.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from poet_tpu_torch.ops.cuda_build import DTYPE_CODE, STEM_LIB, device_guard, stream_of

Padding = Tuple[Tuple[int, int], Tuple[int, int]]


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish, x * tanh(softplus(x)), in the JAX package's one-exp form:
    tanh(log1p(e^x)) = 1 - 2 / ((1 + e^x)^2 + 1), with x clamped at 25
    before the exp and x itself returned above 25. Not `F.mish`: the
    textbook form differs from this one by up to 2e-6 in f32."""
    e = torch.exp(torch.clamp(x, max=25.0))
    t = 1.0 - 2.0 / ((1.0 + e) * (1.0 + e) + 1.0)
    return torch.where(x > 25.0, x, x * t)


ACTIVATIONS = {None: lambda x: x, "relu": torch.relu, "mish": mish,
               "leaky": lambda x: torch.where(x > 0, x, 0.1 * x)}
ACT_CODE = {None: 0, "relu": 1, "mish": 2, "leaky": 3}


def output_hw(x: torch.Tensor, w: torch.Tensor, stride: int, padding: Padding):
    (pt, pb), (pl, pr) = padding
    return ((x.shape[1] + pt + pb - w.shape[0]) // stride + 1,
            (x.shape[2] + pl + pr - w.shape[1]) // stride + 1)


def _check(x, w, bias, stride, padding, activation, out_dtype):
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"expected x (B, H, W, C) and w (kh, kw, C, F), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if bias is not None and tuple(bias.shape) != (w.shape[3],):
        raise ValueError(f"bias {tuple(bias.shape)} != ({w.shape[3]},)")
    (pt, pb), (pl, pr) = padding
    if stride < 1 or min(pt, pb, pl, pr) < 0:
        raise ValueError(f"stride {stride} and padding {padding} must be >= 1 and >= 0")
    if min(output_hw(x, w, stride, padding)) < 1:
        raise ValueError(f"the window does not fit: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"padding {padding}")
    if any(t.requires_grad for t in (x, w, bias) if t is not None):
        raise RuntimeError("conv_stem has no gradient (its callers are frozen backbones)")
    if out_dtype not in (None, torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype {out_dtype} not in (float32, bfloat16)")


def conv_stem_torch(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                    stride: int = 1, padding: Padding = ((0, 0), (0, 0)),
                    activation: Optional[str] = None,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain version: `F.conv2d` in f32 on the permuted tensors, + bias,
    + the activation, then one cast -> (B, Ho, Wo, F)."""
    _check(x, w, bias, stride, padding, activation, out_dtype)
    (pt, pb), (pl, pr) = padding
    xn = F.pad(x.float().permute(0, 3, 1, 2), (pl, pr, pt, pb))
    y = F.conv2d(xn, w.float().permute(3, 2, 0, 1), stride=stride)
    if bias is not None:
        y = y + bias.float()[:, None, None]
    y = ACTIVATIONS[activation](y)
    return y.permute(0, 2, 3, 1).to(out_dtype or x.dtype).contiguous()


class ConvStemForward:
    """Launches the stem kernel (`csrc/conv_stem_fwd.cu`). `launches`
    counts kernel launches and nothing else."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 *, stride: int = 1, padding: Padding = ((0, 0), (0, 0)),
                 activation: Optional[str] = None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Same contract as `conv_stem_torch`; CUDA tensors only."""
        _check(x, w, bias, stride, padding, activation, out_dtype)
        tensors = [t for t in (x, w, bias) if t is not None]
        if x.device.type != "cuda":
            raise ValueError(f"the CUDA kernel takes CUDA tensors, got {x.device}")
        if any(t.device != x.device for t in tensors):
            raise ValueError("x, w and bias must share one device")
        if x.dtype not in DTYPE_CODE or w.dtype != x.dtype:
            raise TypeError(f"x and w must both be float32 or both bfloat16, got "
                            f"{x.dtype} and {w.dtype}")
        if bias is not None and bias.dtype != torch.float32:
            raise TypeError(f"bias must be float32, got {bias.dtype}")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("x, w and bias must be contiguous")
        B, H, W, C = x.shape
        kh, kw, _, Fo = w.shape
        Ho, Wo = output_hw(x, w, stride, padding)
        out_dt = out_dtype or x.dtype
        lib = STEM_LIB.build()
        out = torch.empty((B, Ho, Wo, Fo), dtype=out_dt, device=x.device)
        (pt, _), (pl, _) = padding
        with device_guard(x):
            rc = lib.poet_conv_stem_fwd(
                x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
                out.data_ptr(), DTYPE_CODE[x.dtype], DTYPE_CODE[out_dt], B, H, W, C, Fo,
                kh, kw, stride, pt, pl, Ho, Wo, ACT_CODE[activation], stream_of(x))
        STEM_LIB.check(rc, "conv_stem_fwd")
        self.launches += 1
        return out


CONV_STEM_FWD = ConvStemForward()


@torch.library.custom_op("poet_tpu_torch::conv_stem", mutates_args=(), device_types="cpu")
def _conv_stem_op(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], stride: int,
                  padding: List[int], activation: str,
                  out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The stem as one operator, `padding` flattened (pt, pb, pl, pr) and ''
    for no activation: the plain version on the CPU; the kernel on CUDA
    (below)."""
    return conv_stem_torch(x, w, bias, **_keywords(stride, padding, activation, out_dtype))


def _keywords(stride, padding, activation, out_dtype):
    pt, pb, pl, pr = padding
    return {"stride": stride, "padding": ((pt, pb), (pl, pr)),
            "activation": activation or None, "out_dtype": out_dtype}


@_conv_stem_op.register_kernel("cuda")
def _conv_stem_cuda(x, w, bias, stride, padding, activation, out_dtype):
    return CONV_STEM_FWD(x, w, bias, **_keywords(stride, padding, activation, out_dtype))


@_conv_stem_op.register_fake
def _conv_stem_fake(x, w, bias, stride, padding, activation, out_dtype):
    kw = _keywords(stride, padding, activation, out_dtype)
    Ho, Wo = output_hw(x, w, stride, kw["padding"])
    return x.new_empty((x.shape[0], Ho, Wo, w.shape[3]), dtype=out_dtype or x.dtype)


def conv_stem(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
              stride: int = 1, padding: Padding = ((0, 0), (0, 0)),
              activation: Optional[str] = None,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The darknet body's stem entry, the operator
    `torch.ops.poet_tpu_torch.conv_stem`: CPU -> plain version, CUDA -> the
    hand-written kernel (which raises on what it does not take)."""
    _check(x, w, bias, stride, padding, activation, out_dtype)
    (pt, pb), (pl, pr) = padding
    return _conv_stem_op(x, w, bias, stride, [pt, pb, pl, pr], activation or "", out_dtype)
