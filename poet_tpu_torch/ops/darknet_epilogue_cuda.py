"""A darknet conv's FrozenBN + activation in one pass: the body's operator and its kernel's wrapper.

`darknet_epilogue(x, weight, bias, running_mean, running_var, eps,
activation)`: x (B, H, W, C), the output of a conv without bias,
contiguous, f32 or bf16; `FrozenBatchNorm`'s four (C,) f32 buffers and its
eps; activation 'mish', 'leaky' or 'linear'. It returns act(x * inv + off),
inv = weight * rsqrt(var + eps) and off = bias - mean * inv rounded to x's
dtype, in x's dtype and shape:
  * it is the custom operator `torch.ops.poet_tpu_torch.darknet_epilogue`
    (a fake implementation for tracing, so an exported detector holds it);
  * CPU tensors run the plain version, `darknet_epilogue_torch`:
    `FrozenBatchNorm`'s arithmetic (`frozen_bn`, which the module calls) and
    then `activate`, pass by pass, each pass rounded to x's dtype;
  * CUDA tensors launch `csrc/darknet_epilogue.cu` through
    `DARKNET_EPILOGUE`, or raise. There is no fallback from one to the other.
The kernel computes each element in f32 and rounds once: in f32 it is the
plain version up to expf's last bits; in bf16 it is the f32 version rounded
once, where the plain version rounds after each pass. There is no gradient:
the darknet is a frozen backbone, so an input that requires grad is refused.

The darknet body sends a conv here by `models/yolov4.py:_use_epilogue`, a
predicate on what its output shows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from poet_tpu_torch.ops.conv_stem_cuda import ACT_CODE, mish
from poet_tpu_torch.ops.cuda_build import DTYPE_CODE, EPILOGUE_LIB, device_guard, stream_of

ACTIVATIONS = ("mish", "leaky", "linear")      # the ones the kernel applies
CHANNEL_MULTIPLE = 8                           # C: whole 16-byte vectors in bf16 and f32
MAX_CHANNELS = 4096                            # the fold the kernel keeps in shared memory


def activate(x: torch.Tensor, act: str) -> torch.Tensor:
    """A darknet activation, as the JAX package's DarknetBody applies it."""
    if act == "mish":
        return mish(x)
    if act == "leaky":
        return F.leaky_relu(x, 0.1)
    if act == "logistic":
        return torch.sigmoid(x)
    if act != "linear":
        raise NotImplementedError(f"activation {act}")
    return x


def frozen_bn(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              running_mean: torch.Tensor, running_var: torch.Tensor, eps: float) -> torch.Tensor:
    """`models/resnet_fpn.py:FrozenBatchNorm` on an NCHW x from its four
    buffers (the module calls this): the fold in f32, rounded to x's dtype,
    then one scale and one offset in x's dtype."""
    inv = weight * torch.rsqrt(running_var + eps)
    off = bias - running_mean * inv
    return x * inv.to(x.dtype)[:, None, None] + off.to(x.dtype)[:, None, None]


def _check(x, weight, bias, running_mean, running_var, activation):
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not in {ACTIVATIONS}")
    if x.dim() != 4:
        raise ValueError(f"expected x (B, H, W, C), got {tuple(x.shape)}")
    C = x.shape[3]
    for name, t in (("weight", weight), ("bias", bias), ("running_mean", running_mean),
                    ("running_var", running_var)):
        if tuple(t.shape) != (C,):
            raise ValueError(f"{name} {tuple(t.shape)} != ({C},)")
    if any(t.requires_grad for t in (x, weight, bias, running_mean, running_var)):
        raise RuntimeError("darknet_epilogue has no gradient (the darknet is frozen)")


def darknet_epilogue_torch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                           running_mean: torch.Tensor, running_var: torch.Tensor, eps: float,
                           activation: str) -> torch.Tensor:
    """The plain version: `FrozenBatchNorm`'s arithmetic (`frozen_bn`) on
    x's NCHW view, then `activate`, as the darknet body ran them before the
    operator -> (B, H, W, C). The entry, `darknet_epilogue`, checks the
    arguments."""
    y = frozen_bn(x.permute(0, 3, 1, 2), weight, bias, running_mean, running_var, eps)
    return activate(y, activation).permute(0, 2, 3, 1)


class DarknetEpilogue:
    """Launches the epilogue kernel (`csrc/darknet_epilogue.cu`).
    `launches` counts kernel launches and nothing else."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 running_mean: torch.Tensor, running_var: torch.Tensor, eps: float,
                 activation: str) -> torch.Tensor:
        """Same contract as `darknet_epilogue_torch`; CUDA tensors only."""
        _check(x, weight, bias, running_mean, running_var, activation)
        buffers = (weight, bias, running_mean, running_var)
        if x.device.type != "cuda":
            raise ValueError(f"the CUDA kernel takes CUDA tensors, got {x.device}")
        if any(t.device != x.device for t in buffers):
            raise ValueError("x and the BN buffers must share one device")
        if x.dtype not in DTYPE_CODE:
            raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
        if any(t.dtype != torch.float32 for t in buffers):
            raise TypeError("the BN buffers must be float32")
        if not (x.is_contiguous() and all(t.is_contiguous() for t in buffers)):
            raise ValueError("x (B, H, W, C) and the BN buffers must be contiguous")
        C = x.shape[3]
        if C % CHANNEL_MULTIPLE or C > MAX_CHANNELS:
            raise ValueError(f"C = {C}: the kernel takes multiples of {CHANNEL_MULTIPLE} "
                             f"up to {MAX_CHANNELS}")
        if x.data_ptr() % 16:
            raise ValueError("x must be 16-byte aligned")
        out = torch.empty_like(x)
        if out.numel() == 0:
            return out
        lib = EPILOGUE_LIB.build()
        with device_guard(x):
            rc = lib.poet_darknet_epilogue(
                x.data_ptr(), out.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                running_mean.data_ptr(), running_var.data_ptr(), eps, DTYPE_CODE[x.dtype],
                x.numel(), C, ACT_CODE[None if activation == "linear" else activation],
                stream_of(x))
        EPILOGUE_LIB.check(rc, "darknet_epilogue")
        self.launches += 1
        return out


DARKNET_EPILOGUE = DarknetEpilogue()


@torch.library.custom_op("poet_tpu_torch::darknet_epilogue", mutates_args=(),
                         device_types="cpu")
def _darknet_epilogue_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         running_mean: torch.Tensor, running_var: torch.Tensor, eps: float,
                         activation: str) -> torch.Tensor:
    """The epilogue as one operator: the plain version on the CPU; the
    kernel on CUDA (below)."""
    return darknet_epilogue_torch(x, weight, bias, running_mean, running_var, eps, activation)


@_darknet_epilogue_op.register_kernel("cuda")
def _darknet_epilogue_cuda(x, weight, bias, running_mean, running_var, eps, activation):
    return DARKNET_EPILOGUE(x, weight, bias, running_mean, running_var, eps, activation)


@_darknet_epilogue_op.register_fake
def _darknet_epilogue_fake(x, weight, bias, running_mean, running_var, eps, activation):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def darknet_epilogue(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor, eps: float,
                     activation: str) -> torch.Tensor:
    """The darknet body's epilogue entry, the operator
    `torch.ops.poet_tpu_torch.darknet_epilogue`: CPU -> plain version,
    CUDA -> the hand-written kernel (which raises on what it does not
    take)."""
    _check(x, weight, bias, running_mean, running_var, activation)
    return _darknet_epilogue_op(x, weight, bias, running_mean, running_var, float(eps),
                                activation)
