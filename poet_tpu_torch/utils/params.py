"""bf16 weights at rest for inference. Counterpart of `poet_tpu/utils/params.py`.

Modules compute in their compute dtype and cast f32 weights at each use
(`models/layers.py`). Casting the weight matrices and conv kernels of the
bf16-compute subtrees once, at rest, gives bit-identical outputs and removes
those per-call converts. The f32-compute islands keep f32: the
sampling_offsets / attention_weights / reference_points projections and
level_embed (MSDeformAttn's f32 coordinate path), and the translation /
rotation heads, which take f32 decoder states. Vectors (biases, norm
affines, FrozenBatchNorm statistics) stay f32: several feed f32 folds.
"""

from __future__ import annotations

import torch
import torch.nn as nn

_F32_ISLANDS = ("sampling_offsets", "attention_weights", "reference_points", "level_embed")
# top-level subtrees that compute in the model's compute dtype
_BF16_SUBTREES = ("backbone", "transformer", "input_proj")


def should_cast(name: str, p: torch.Tensor) -> bool:
    parts = name.split(".")
    return (p.dtype == torch.float32 and p.dim() >= 2
            and parts[0] in _BF16_SUBTREES
            and not any(part in _F32_ISLANDS for part in parts))


@torch.no_grad()
def cast_params_for_inference(model: nn.Module) -> nn.Module:
    """Cast the bf16-compute weights of a bf16 PoET module to bf16, in place."""
    for name, p in model.named_parameters():
        if should_cast(name, p):
            p.data = p.data.to(torch.bfloat16)
    return model
