"""Model factory. Counterpart of `poet_tpu/models/__init__.py:build_model`."""

from __future__ import annotations

from poet_tpu_torch.config import PoETConfig
from poet_tpu_torch.models.backbone import MaskRCNNFeatureBackbone
from poet_tpu_torch.models.poet import MLP, PoET, compute_dtype_of  # noqa: F401


def build_model(cfg: PoETConfig) -> PoET:
    """The PoET module for a config, on the CPU with torch's default init;
    `utils/init.py:init_weights` gives it the JAX package's initializers from
    a seed, and `utils/jax_params.py:load_jax_params` loads a JAX tree.

    Only the gt/jitter path on the Mask R-CNN feature backbone is ported.
    """
    if cfg.backbone.name not in ("maskrcnn", "fasterrcnn"):
        raise NotImplementedError(
            f"backbone {cfg.backbone.name!r} is not ported yet (ROADMAP queue A, "
            "YOLOv4-CSP)")
    if cfg.model.bbox_mode == "backbone":
        raise NotImplementedError(
            "bbox_mode='backbone' needs the Mask R-CNN detector heads, not ported yet "
            "(ROADMAP queue A, detect+pose)")
    backbone = MaskRCNNFeatureBackbone(dtype=compute_dtype_of(cfg.model))
    return PoET(backbone, cfg.model,
                position_embedding=cfg.backbone.position_embedding,
                position_embedding_scale=cfg.backbone.position_embedding_scale)
