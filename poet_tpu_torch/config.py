"""Configuration for the port: the fields of `poet_tpu.config` that the
serving paths, the train step, evaluation and the CLI read, with the same
names and defaults, and `to_json` / `from_dict` as there.

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
`lr_backbone_names`, `aux_loss`, the legacy matcher's type and GIoU cost
and the TPU runtime's fields (`export_platforms`, `mesh_data`,
`zero_opt_state`, `rng_impl`, `xla_cache_dir`, `donate_step`) are kept for
the CLI's flags and the checkpoints' config echo; the detector backbone is
frozen by its module name, every layer's loss is always taken and only the
pose matcher is ported. `runtime.device` is the port's own: where the CLI
runs ('cuda' unless the caller asks for 'cpu').
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass
class OptimConfig:
    lr: float = 2e-4
    lr_backbone_names: Tuple[str, ...] = ("backbone",)
    lr_backbone: float = 2e-5
    lr_linear_proj_names: Tuple[str, ...] = ("reference_points", "sampling_offsets")
    lr_linear_proj_mult: float = 0.1
    batch_size: int = 16
    eval_batch_size: int = 16
    weight_decay: float = 1e-4
    epochs: int = 50
    lr_drop: int = 100              # StepLR drop interval (epochs)
    clip_max_norm: float = 0.1
    sgd: bool = False               # SGD(momentum=0.9) instead of AdamW
    grad_accum_steps: int = 1       # mean over k micro-batches per update
    mu_bf16: bool = False           # bf16 AdamW first moment (engine/train.py:AdamWMuBf16)


@dataclass
class BackboneConfig:
    name: str = "maskrcnn"          # {maskrcnn, fasterrcnn, yolov4}
    # the rcnn YAML (label map, anchor sizes) or the yolov4 darknet cfg;
    # "" -> torchvision's defaults / configs/{dataset}_yolov4-csp.cfg
    cfg_path: str = ""
    weights: Optional[str] = None   # --backbone_weights: a detector .pth / darknet .weights
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
    input_size: Tuple[int, int] = (480, 640)   # (H, W)
    # per-FPN-level anchor sizes of the rcnn YAML; None -> torchvision's.
    # `input_resize` is recorded from the YAML for parity and has no effect
    # (the reference's forward never applies its resize transform)
    anchor_sizes: Optional[Tuple[Tuple[int, ...], ...]] = None
    input_resize: Optional[Tuple[int, int]] = None


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
    aux_loss: bool = True
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
    matcher_type: str = "pose"
    set_cost_class: float = 1.0
    set_cost_bbox: float = 1.0
    set_cost_giou: float = 2.0      # the legacy matcher's; unused, as in the reference CLI
    giou_thresh: float = 0.5        # backbone-mode post filter


@dataclass
class LossConfig:
    translation_loss_coef: float = 1.0
    rotation_loss_coef: float = 1.0


@dataclass
class DataConfig:
    dataset: str = "ycbv"           # {ycbv, lmo}; lmo remaps the detector's ids
    dataset_path: str = "/data"     # root of the splits and the evaluator's assets
    train_set: str = "train"
    eval_set: str = "test"
    synt_background: Optional[str] = None   # not ported (ROADMAP A.1): raises
    jitter_probability: float = 0.5
    rgb_augmentation: bool = False
    grayscale: bool = False
    num_workers: int = 0            # loader threads; 0 -> 4
    cache_mode: bool = False        # the reference's in-RAM byte cache
    decoded_cache_mb: int = 0       # decoded-uint8 image cache budget (MB); 0 = off


@dataclass
class EvalConfig:
    eval_interval: int = 10
    # the evaluator's assets, joined onto data.dataset_path (reference main.py:141-149)
    class_info: str = "/annotations/classes.json"
    models_path: str = "/models_eval/"
    model_symmetry: str = "/annotations/symmetries.json"


@dataclass
class RuntimeConfig:
    # the reference's main.py:151-187 (inference, misc, distributed)
    inference: bool = False
    inference_path: Optional[str] = None
    inference_output: Optional[str] = None
    save_interval: int = 5
    output_dir: str = ""
    seed: int = 42
    resume: str = ""
    start_epoch: int = 0
    eval: bool = False
    eval_bop: bool = False
    export_model: Optional[str] = None      # not ported (ROADMAP A.2): raises
    export_batch_size: int = 1
    export_image_size: tuple = (480, 640)
    export_platforms: tuple = ("cpu", "tpu")
    mesh_data: int = -1
    dtype: str = "float32"
    donate_step: bool = True
    zero_opt_state: bool = False
    rng_impl: str = "threefry2x32"
    xla_cache_dir: Optional[str] = None
    device: str = "cuda"            # the port's device: 'cuda', or 'cpu' when asked


@dataclass
class PoETConfig:
    optim: OptimConfig = field(default_factory=OptimConfig)
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    data: DataConfig = field(default_factory=DataConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PoETConfig":
        kwargs = {}
        for f in dataclasses.fields(cls):
            sub = d.get(f.name, {})
            sub_cls = f.default_factory  # type: ignore[misc]
            sub_fields = {sf.name for sf in dataclasses.fields(sub_cls)}
            kwargs[f.name] = sub_cls(**{k: _tupled(v) for k, v in sub.items()
                                        if k in sub_fields})
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str) -> "PoETConfig":
        return cls.from_dict(json.loads(s))


def _tupled(v):
    """JSON lists back to the config's tuples (nested: anchor_sizes)."""
    return tuple(_tupled(x) for x in v) if isinstance(v, list) else v
