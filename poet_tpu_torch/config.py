"""Configuration for the port: the fields of `poet_tpu.config` that the
serving slice reads, with the same names and defaults.

`poet_tpu.config` cannot be imported here (`poet_tpu/__init__.py` pulls in
JAX), so the dataclasses are restated. Fields that only select TPU
formulations (`enc_deform_impl`, `dec_deform_impl`, `enc_remat`) have no
counterpart: the port runs one deformable-attention entry everywhere.
`dropout` waits for the training port.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


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
    nheads: int = 16
    num_queries: int = 10
    dec_n_points: int = 4
    enc_n_points: int = 4
    aleatoric: bool = False
    n_classes: int = 21
    # transformer/backbone compute dtype; parameters stay f32 except where
    # utils/params.py casts them at rest for inference
    dtype: str = "float32"

    @property
    def rot_dim(self) -> int:
        return 6 if self.rotation_representation == "6d" else 4


@dataclass
class PoETConfig:
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
