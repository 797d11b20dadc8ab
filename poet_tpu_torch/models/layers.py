"""Layer primitives with flax's compute-dtype semantics and initializers.

flax modules take a compute `dtype` separate from their (f32) parameters:
`nn.Dense(dtype=bf16)` casts its input, kernel and bias to bf16; `LayerNorm`
and `GroupNorm` take their statistics in f32 and return the compute dtype.
These subclasses of the torch layers (and `Embedding`, a learned table) do
the same, keep torch's parameter
names (`weight`, `bias`) so state_dicts follow the reference checkpoints,
and carry the flax initializer of their JAX counterpart for
`utils/init.py:init_weights`. Norm epsilons are flax's 1e-6.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# truncated_normal(-2, 2) has std 0.8796...; flax's variance_scaling divides
# it out so the truncated draw keeps the requested variance
_TRUNC_STD = 0.87962566103423978


def variance_scaling_(t: torch.Tensor, scale: float, fan_in: int,
                      generator: torch.Generator) -> torch.Tensor:
    """flax `variance_scaling(scale, 'fan_in', 'truncated_normal')`."""
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                     generator=generator)


_INIT_SCALE = {"lecun_normal": 1.0, "he_normal": 2.0}


def _init_kernel(w: torch.Tensor, kind: str, g: torch.Generator) -> None:
    if kind == "zeros":
        with torch.no_grad():
            w.zero_()
    else:
        variance_scaling_(w, _INIT_SCALE[kind], w[0].numel(), g)


class Dense(nn.Linear):
    """flax `nn.Dense(dtype=compute_dtype)`; weight is torch's (out, in)."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32,
                 kernel_init: str = "lecun_normal",
                 bias_init: Optional[np.ndarray] = None):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype
        self.kernel_init = kernel_init
        self.bias_init = bias_init       # None -> zeros

    def seeded_init(self, g: torch.Generator) -> None:
        _init_kernel(self.weight, self.kernel_init, g)
        with torch.no_grad():
            if self.bias_init is None:
                self.bias.zero_()
            else:
                self.bias.copy_(torch.as_tensor(self.bias_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv(nn.Conv2d):
    """flax `nn.Conv(dtype=compute_dtype)` on NCHW tensors, explicit padding."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 kernel_init: str = "lecun_normal"):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias)
        self.compute_dtype = compute_dtype
        self.kernel_init = kernel_init

    def seeded_init(self, g: torch.Generator) -> None:
        _init_kernel(self.weight, self.kernel_init, g)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Embedding(nn.Embedding):
    """A learned f32 table, its rows read by index (the reference's
    nn.Embedding names: `weight`), with the flax initializer of its JAX
    `self.param`: 'normal' N(0, 1) (`initializers.normal(1.0)`) or 'uniform'
    U[0, 1) (`initializers.uniform(1.0)`)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, init: str = "normal"):
        super().__init__(num_embeddings, embedding_dim)
        if init not in ("normal", "uniform"):
            raise ValueError(f"init {init!r} not in ('normal', 'uniform')")
        self.init = init

    def seeded_init(self, g: torch.Generator) -> None:
        with torch.no_grad():
            if self.init == "normal":
                self.weight.normal_(0.0, 1.0, generator=g)
            else:
                self.weight.uniform_(0.0, 1.0, generator=g)


class LayerNorm(nn.LayerNorm):
    """flax `nn.LayerNorm(dtype=compute_dtype)`: f32 statistics, eps 1e-6."""

    def __init__(self, d: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__(d, eps=1e-6)
        self.compute_dtype = compute_dtype

    def seeded_init(self, g: torch.Generator) -> None:
        self.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class GroupNorm(nn.GroupNorm):
    """flax `nn.GroupNorm(dtype=compute_dtype)` on NCHW: f32 statistics, eps 1e-6,
    and flax's formulas (`use_fast_variance`): var = max(0, E[x^2] - E[x]^2) and
    y = (x - mean) * (rsqrt(var + eps) * scale) + bias. `F.group_norm`'s
    two-pass variance parts from it where a group's spread is small against
    its mean (one channel per group, as at hidden 32)."""

    def __init__(self, num_groups: int, num_channels: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(num_groups, num_channels, eps=1e-6)
        self.compute_dtype = compute_dtype

    def seeded_init(self, g: torch.Generator) -> None:
        self.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        xf = x.float()
        groups = xf.reshape(B, self.num_groups, -1)
        mean = groups.mean(-1)
        var = (groups.square().mean(-1) - mean.square()).clamp_min(0.0)
        per_channel = C // self.num_groups
        shape = (B, C) + (1,) * (x.dim() - 2)
        mean = mean.repeat_interleave(per_channel, 1).view(shape)
        mul = torch.rsqrt(var + self.eps).repeat_interleave(per_channel, 1) * self.weight
        y = (xf - mean) * mul.view(shape) + self.bias.view((1, C) + shape[2:])
        return y.to(self.compute_dtype)
