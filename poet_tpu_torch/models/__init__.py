"""Model factory. Counterpart of `poet_tpu/models/__init__.py:build_model`."""

from __future__ import annotations

import os

from poet_tpu_torch.config import PoETConfig
from poet_tpu_torch.models.backbone import MaskRCNNDetectorBackbone, MaskRCNNFeatureBackbone
from poet_tpu_torch.models.poet import MLP, PoET, compute_dtype_of  # noqa: F401

# LM-O dataset id remap (reference backbone_maskrcnn.py:55-57)
LMO_OBJ_ID_MAP = ((1, 1), (5, 2), (6, 3), (8, 4), (9, 5), (10, 6), (11, 7), (12, 8))
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_model(cfg: PoETConfig) -> PoET:
    """The PoET module for a config, on the CPU with torch's default init;
    `utils/init.py:init_weights` gives it the JAX package's initializers from
    a seed, and `utils/jax_params.py:load_jax_params` loads a JAX tree.

    maskrcnn/fasterrcnn: gt/jitter modes get the feature-only Mask R-CNN
    backbone; 'backbone' mode gets the full detector (RPN + RoI heads) with
    `n_classes + 1` detector classes (background included).
    yolov4: the YOLOv4-CSP backbone of the darknet cfg at `cfg_path`, or of
    the shipped `configs/{dataset}_yolov4-csp.cfg` when it is empty, in
    every mode (its detections feed bbox_mode='backbone').
    """
    dtype = compute_dtype_of(cfg.model)
    bb = cfg.backbone
    if bb.name == "yolov4":
        from poet_tpu_torch.models.yolov4 import YOLOv4Backbone, load_cfg_sections

        cfg_path = bb.cfg_path or os.path.join(REPO_ROOT, "configs",
                                               f"{cfg.data.dataset}_yolov4-csp.cfg")
        if not os.path.exists(cfg_path):
            raise FileNotFoundError(f"yolov4 needs a darknet cfg (backbone.cfg_path); the "
                                    f"shipped default {cfg_path} is not there")
        backbone = YOLOv4Backbone(
            load_cfg_sections(cfg_path), conf_thresh=bb.conf_thresh, iou_thresh=bb.iou_thresh,
            agnostic_nms=bb.agnostic_nms, max_detections=bb.max_detections,
            encoder_min_stride=bb.encoder_min_stride, box_decode=bb.yolo_box_decode,
            dtype=dtype)
    elif bb.name not in ("maskrcnn", "fasterrcnn"):
        raise NotImplementedError(f"backbone {bb.name!r}")
    elif cfg.model.bbox_mode == "backbone":
        backbone = MaskRCNNDetectorBackbone(
            num_classes=cfg.model.n_classes + 1,
            max_detections=bb.max_detections,
            post_nms_top_n=bb.post_nms_top_n,
            obj_id_map=LMO_OBJ_ID_MAP if cfg.data.dataset == "lmo" else None,
            anchor_sizes=bb.anchor_sizes,
            dtype=dtype)
    else:
        backbone = MaskRCNNFeatureBackbone(dtype=dtype)
    return PoET(backbone, cfg.model,
                position_embedding=bb.position_embedding,
                position_embedding_scale=bb.position_embedding_scale)
