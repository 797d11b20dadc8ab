"""Configuration for the port: the fields of `poet_tpu.config` that the
serving paths, the train step and evaluation read, with the same names and
defaults.

`poet_tpu.config` cannot be imported here (`poet_tpu/__init__.py` pulls in
JAX), so the dataclasses are restated.

`enc_deform_impl` / `dec_deform_impl` take JAX's names and values, and
`DEFORM_IMPLS` maps each onto one of the port's two routes of the
deformable-attention core: 'pallas' onto the dense one-hot kernels
(`ops/deform_attn_dense_cuda.py`, the counterparts of the TPU kernels that
value selects), every other value onto the gather kernels
(`ops/deform_attn_cuda.py`). The XLA formulations ('mxu', 'patch', 'sep',
'sep_cv', 'gather') compute the same function and have no TPU kernel of
their own; 'auto' and 'fused' are the gather kernels in both stacks (JAX's
decoder 'auto' resolves by memory length, to 'mxu' at every length it
measured). `merged_adjoint` is the counterpart of JAX's
`POET_V3_MERGED_ADJOINT=1`: the gather route's backward in one kernel
instead of two, the port's default (JAX's is the two-kernel adjoint).
`enc_remat` has no counterpart: the port's autograd
Functions save only their inputs, so there is nothing to rematerialize.
Fields that nothing in the port reads are left out as well: the epoch and
batch counts (the caller's loop owns them), the backbone-name keywords (the
backbone is frozen by its module name), and the legacy matcher's type and
GIoU cost (only the pose matcher is ported).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


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
    # darknet cfg of the yolov4 backbone; "" -> configs/{dataset}_yolov4-csp.cfg
    cfg_path: str = ""
    # yolov4 detections: score threshold, NMS IoU, class-agnostic NMS
    conf_thresh: float = 0.4
    iou_thresh: float = 0.5
    agnostic_nms: bool = False
    # yolov4: feature maps finer than this stride are decoded for detections
    # but not fed to the transformer; 1 = every map (the reference)
    encoder_min_stride: int = 1
    # yolov4 box decode: 'u5' (the reference wrapper's) or 'darknet'
    # (classic new_coords=0, the cfg's scale_x_y, exp-wh)
    yolo_box_decode: str = "u5"
    position_embedding: str = "sine"     # {sine, learned}
    position_embedding_scale: float = 2 * math.pi
    # fixed detector caps (bbox_mode='backbone'): detections per image, and
    # RPN proposals entering the RoI heads (torchvision's test-time 1000)
    max_detections: int = 100
    post_nms_top_n: int = 1000
    # per-FPN-level anchor sizes of the rcnn YAML; None -> torchvision's.
    # Reading that YAML is not ported yet (it comes with the CLI).
    anchor_sizes: Optional[Tuple[Tuple[int, ...], ...]] = None


# enc_deform_impl / dec_deform_impl -> the port's route of the sampling core
DEFORM_IMPLS = {"auto": "gather", "fused": "gather", "pallas": "dense", "mxu": "gather",
                "patch": "gather", "sep": "gather", "sep_cv": "gather", "gather": "gather"}


def deform_route(impl: str) -> str:
    """'gather' or 'dense' for a JAX deformable-attention impl name; any
    other value raises."""
    if impl not in DEFORM_IMPLS:
        raise ValueError(f"deformable-attention impl {impl!r} not in {tuple(DEFORM_IMPLS)}")
    return DEFORM_IMPLS[impl]


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
    # deformable-sampling core of the encoder and of the decoder's
    # cross-attention, JAX's names (DEFORM_IMPLS): 'pallas' runs the dense
    # one-hot kernels, every other value the gather kernels
    enc_deform_impl: str = "auto"
    dec_deform_impl: str = "auto"
    # the gather route's backward: one merged kernel (True) or the d_value
    # scatter + d_loc/d_attn gather pair (False). Merged: 3.24 against 4.50 ms
    # of adjoint kernels per bf16 train step on an H100 (PERF.md, section 5)
    merged_adjoint: bool = True

    def __post_init__(self):
        deform_route(self.enc_deform_impl)
        deform_route(self.dec_deform_impl)

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
class DataConfig:
    dataset: str = "ycbv"           # {ycbv, lmo}; lmo remaps the detector's ids
    dataset_path: str = "/data"     # root the evaluator's asset paths join onto


@dataclass
class EvalConfig:
    # the evaluator's assets, joined onto data.dataset_path (reference main.py:141-149)
    class_info: str = "/annotations/classes.json"
    models_path: str = "/models_eval/"
    model_symmetry: str = "/annotations/symmetries.json"


@dataclass
class PoETConfig:
    optim: OptimConfig = field(default_factory=OptimConfig)
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    data: DataConfig = field(default_factory=DataConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
