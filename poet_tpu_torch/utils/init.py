"""Seeded initialization with the JAX package's initializers.

The port draws its own numbers (a `torch.Generator`, not `jax.random`), so
it follows the JAX initializers by distribution, not by bits:
  * `he_normal` for the ResNet bottleneck convs, `lecun_normal` for every
    other conv and Dense (both truncated-normal variance scaling), zero biases,
  * zero kernels for `sampling_offsets` and `attention_weights`, with the
    rotated-grid bias on the offsets,
  * identity FrozenBatchNorm statistics, unit/zero norm affines,
  * `level_embed` from N(0, 1).
Each module that owns parameters knows its own initializer (`seeded_init`).
"""

from __future__ import annotations

import torch
import torch.nn as nn


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Initialize every parameter and buffer of `model` from `seed`, in
    module order, on the CPU generator (the same weights on any device)."""
    g = torch.Generator().manual_seed(seed)
    covered = set()
    for name, m in model.named_modules():
        if hasattr(m, "seeded_init"):
            m.seeded_init(g)
            prefix = f"{name}." if name else ""
            covered.update(prefix + n for n, _ in m.named_parameters(recurse=False))
            covered.update(prefix + n for n, _ in m.named_buffers(recurse=False))
    missing = sorted(set(model.state_dict()) - covered)
    if missing:
        raise RuntimeError(f"no initializer for {missing[:8]}")
    return model
