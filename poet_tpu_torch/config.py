"""Configuration for the port: the fields of `poet_tpu.config` that the
serving slice and the train step read, with the same names and defaults.

`poet_tpu.config` cannot be imported here (`poet_tpu/__init__.py` pulls in
JAX), so the dataclasses are restated. Fields that only select TPU
formulations (`enc_deform_impl`, `dec_deform_impl`, `enc_remat`) have no
counterpart: the port runs one deformable-attention entry everywhere.
Fields that nothing in the port reads are left out as well: the epoch and
batch counts (the caller's loop owns them), the backbone-name keywords (the
backbone is frozen by its module name), and the legacy matcher's type and
GIoU cost (only the pose matcher is ported).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Tuple


@dataclass
class OptimConfig:
    lr: float = 2e-4
    lr_backbone: float = 2e-5
    lr_linear_proj_names: Tuple[str, ...] = ("reference_points", "sampling_offsets")
    lr_linear_proj_mult: float = 0.1
    weight_decay: float = 1e-4
    lr_drop: int = 100              # StepLR drop interval (epochs)
    clip_max_norm: float = 0.1
    sgd: bool = False               # SGD(momentum=0.9) instead of AdamW
    grad_accum_steps: int = 1       # mean over k micro-batches per update
    mu_bf16: bool = False           # bf16 AdamW first moment (not ported yet)


@dataclass
class BackboneConfig:
    name: str = "maskrcnn"          # {maskrcnn, fasterrcnn, yolov4}
    position_embedding: str = "sine"     # {sine, learned}
    position_embedding_scale: float = 2 * math.pi


@dataclass
class ModelConfig:
    bbox_mode: str = "gt"                 # {gt, backbone, jitter}
    reference_points: str = "bbox"        # {bbox, learned}
    query_embedding: str = "bbox"         # {bbox, learned}
    rotation_representation: str = "6d"   # {6d, quat, silho_quat}
    class_mode: str = "specific"          # {agnostic, specific}
    num_feature_levels: int = 4
    enc_layers: int = 5
    dec_layers: int = 5
    dim_feedforward: int = 1024
    hidden_dim: int = 256
    dropout: float = 0.1                  # active only in model.train()
    nheads: int = 16
    num_queries: int = 10
    dec_n_points: int = 4
    enc_n_points: int = 4
    aleatoric: bool = False
    calibrate: bool = False
    n_classes: int = 21
    # transformer/backbone compute dtype; parameters stay f32 except where
    # utils/params.py casts them at rest for inference
    dtype: str = "float32"

    @property
    def rot_dim(self) -> int:
        return 6 if self.rotation_representation == "6d" else 4


@dataclass
class MatcherConfig:
    set_cost_class: float = 1.0
    set_cost_bbox: float = 1.0
    giou_thresh: float = 0.5        # backbone-mode post filter


@dataclass
class LossConfig:
    translation_loss_coef: float = 1.0
    rotation_loss_coef: float = 1.0


@dataclass
class PoETConfig:
    optim: OptimConfig = field(default_factory=OptimConfig)
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    loss: LossConfig = field(default_factory=LossConfig)
