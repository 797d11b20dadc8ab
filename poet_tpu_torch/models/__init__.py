"""Model factory. Counterpart of `poet_tpu/models/__init__.py:build_model`."""

from __future__ import annotations

from poet_tpu_torch.config import PoETConfig
from poet_tpu_torch.models.backbone import MaskRCNNDetectorBackbone, MaskRCNNFeatureBackbone
from poet_tpu_torch.models.poet import MLP, PoET, compute_dtype_of  # noqa: F401

# LM-O dataset id remap (reference backbone_maskrcnn.py:55-57)
LMO_OBJ_ID_MAP = ((1, 1), (5, 2), (6, 3), (8, 4), (9, 5), (10, 6), (11, 7), (12, 8))


def build_model(cfg: PoETConfig) -> PoET:
    """The PoET module for a config, on the CPU with torch's default init;
    `utils/init.py:init_weights` gives it the JAX package's initializers from
    a seed, and `utils/jax_params.py:load_jax_params` loads a JAX tree.

    gt/jitter modes get the feature-only Mask R-CNN backbone; 'backbone'
    mode gets the full detector (RPN + RoI heads) with `n_classes + 1`
    detector classes (background included).
    """
    if cfg.backbone.name not in ("maskrcnn", "fasterrcnn"):
        raise NotImplementedError(
            f"backbone {cfg.backbone.name!r} is not ported yet (ROADMAP queue A, "
            "YOLOv4-CSP)")
    dtype = compute_dtype_of(cfg.model)
    if cfg.model.bbox_mode == "backbone":
        backbone = MaskRCNNDetectorBackbone(
            num_classes=cfg.model.n_classes + 1,
            max_detections=cfg.backbone.max_detections,
            post_nms_top_n=cfg.backbone.post_nms_top_n,
            obj_id_map=LMO_OBJ_ID_MAP if cfg.data.dataset == "lmo" else None,
            anchor_sizes=cfg.backbone.anchor_sizes,
            dtype=dtype)
    else:
        backbone = MaskRCNNFeatureBackbone(dtype=dtype)
    return PoET(backbone, cfg.model,
                position_embedding=cfg.backbone.position_embedding,
                position_embedding_scale=cfg.backbone.position_embedding_scale)
