"""ResNet-50 + FPN feature extractor with frozen BatchNorm.

Counterpart of `poet_tpu/models/resnet_fpn.py` (torchvision's
`resnet_fpn_backbone('resnet50')`). Submodules carry torchvision's names
(`body.layer1.0.conv1`, `fpn.inner_blocks.2`, ...) so torchvision and
reference checkpoints map one to one. Convolutions run NCHW (channels-last
memory on the card); `ResNetFPN` takes and returns NHWC like the JAX module.
Raw [0, 1] images go in without ImageNet normalization, as in the reference.

The stem is the plain convolution, as in the JAX package, whose
`resolve_stem_impl` resolves 'auto' to 'xla'. The port's stem kernel
(`ops/conv_stem_cuda.py`, the counterpart of `conv_stem_pallas.py`) is
held against this stem's function in `chip_smoke.py` phase 12, and serves
the darknet body's entry convs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from poet_tpu_torch.models.layers import Conv
from poet_tpu_torch.ops.darknet_epilogue_cuda import frozen_bn
from poet_tpu_torch.utils.tracing import traced


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics (torchvision FrozenBatchNorm2d).

    The scale/offset fold is computed in f32 and applied in the activation
    dtype, as in the JAX module.
    """

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def seeded_init(self, g: torch.Generator) -> None:
        """Identity statistics (the JAX initializers: ones/zeros)."""
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # NCHW
        return frozen_bn(x, self.weight, self.bias, self.running_mean, self.running_var,
                         self.eps)


def _conv(cin: int, cout: int, k: int, stride: int = 1, dtype=torch.float32) -> Conv:
    return Conv(cin, cout, k, stride=stride, padding=k // 2, bias=False,
                compute_dtype=dtype, kernel_init="he_normal")


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int = 1, downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = _conv(cin, width, 1, dtype=dtype)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = _conv(width, width, 3, stride=stride, dtype=dtype)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = _conv(width, width * 4, 1, dtype=dtype)
        self.bn3 = FrozenBatchNorm(width * 4)
        self.downsample = (nn.Sequential(_conv(cin, width * 4, 1, stride=stride, dtype=dtype),
                                         FrozenBatchNorm(width * 4))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet50(nn.Module):
    """Returns C2..C5 (strides 4, 8, 16, 32; 256/512/1024/2048 channels)."""

    WIDTHS = (64, 128, 256, 512)
    BLOCKS = (3, 4, 6, 3)

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        # the JAX stem is nn.Conv's default (lecun) init; bottlenecks are he
        self.conv1 = Conv(3, 64, 7, stride=2, padding=3, bias=False, compute_dtype=dtype)
        self.bn1 = FrozenBatchNorm(64)
        cin = 64
        for stage, (w, n) in enumerate(zip(self.WIDTHS, self.BLOCKS)):
            blocks = []
            for b in range(n):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(Bottleneck(cin, w, stride, downsample=(b == 0), dtype=dtype))
                cin = w * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:   # NCHW
        x = F.relu(self.bn1(self.conv1(x.to(self.dtype))))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for stage in range(4):
            x = getattr(self, f"layer{stage + 1}")(x)
            outs.append(x)
        return outs


class FPN(nn.Module):
    """torchvision FeaturePyramidNetwork + LastLevelMaxPool, restricted to
    `levels` (the top-down path only flows coarse -> fine, so unconsumed
    fine levels are never built)."""

    IN_CHANNELS = (256, 512, 1024, 2048)

    def __init__(self, out_channels: int = 256, dtype: torch.dtype = torch.float32,
                 levels: Optional[Sequence[str]] = None):
        super().__init__()
        n = len(self.IN_CHANNELS)
        self.want = (set(levels) if levels is not None
                     else {str(i) for i in range(n)} | {"pool"})
        want_num = ({int(k) for k in self.want if k != "pool"}
                    | ({n - 1} if "pool" in self.want else set()))
        self.finest = min(want_num)
        self.inner_blocks = nn.ModuleDict({
            str(i): Conv(self.IN_CHANNELS[i], out_channels, 1, compute_dtype=dtype)
            for i in range(self.finest, n)})
        self.layer_blocks = nn.ModuleDict({
            str(i): Conv(out_channels, out_channels, 3, padding=1, compute_dtype=dtype)
            for i in range(self.finest, n)
            if str(i) in self.want or (i == n - 1 and "pool" in self.want)})

    def forward(self, feats: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        n = len(feats)
        inners = {i: self.inner_blocks[str(i)](feats[i]) for i in range(self.finest, n)}
        laterals = {n - 1: inners[n - 1]}
        for i in range(n - 2, self.finest - 1, -1):
            # jax.image.resize 'nearest' samples half-pixel centres = nearest-exact
            up = F.interpolate(laterals[i + 1], size=inners[i].shape[-2:],
                               mode="nearest-exact")
            laterals[i] = inners[i] + up
        outs = {k: blk(laterals[int(k)]) for k, blk in self.layer_blocks.items()}
        if "pool" in self.want:
            # LastLevelMaxPool: 1x1 window, stride 2 — a plain subsample
            outs["pool"] = outs[str(n - 1)][:, :, ::2, ::2]
        return {k: v for k, v in outs.items() if k in self.want}


class ResNetFPN(nn.Module):
    """images (B, H, W, 3) in [0, 1] -> {level: (B, Hl, Wl, C)}."""

    def __init__(self, out_channels: int = 256, dtype: torch.dtype = torch.float32,
                 levels: Optional[Sequence[str]] = None):
        super().__init__()
        self.body = ResNet50(dtype=dtype)
        self.fpn = FPN(out_channels, dtype=dtype, levels=levels)

    @traced("backbone.body")
    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.body(images.permute(0, 3, 1, 2))     # NHWC -> NCHW view
        return {k: v.permute(0, 2, 3, 1) for k, v in self.fpn(feats).items()}


def downsample_mask(pad_mask: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Resize a (B, H, W) bool pad mask to a feature resolution (nearest,
    half-pixel centres as `jax.image.resize`)."""
    m = F.interpolate(pad_mask[:, None].float(), size=tuple(hw), mode="nearest-exact")
    return m[:, 0].bool()
