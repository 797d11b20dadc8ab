"""The program under test, `poet_tpu_torch`, reached only through its public
entries: the config dataclasses, `models.build_model`, `load_state_dict`,
`engine.serving.PoseServer` and `engine.train`. Nothing else of the harness
imports the program."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.lib.manifest import Config


def program_config(conf: Config, model_overrides=None):
    from poet_tpu_torch.config import PoETConfig

    cfg = PoETConfig()
    for k, v in dict(conf.model, **(model_overrides or {})).items():
        setattr(cfg.model, k, v)
    if conf.backbone == "darknet":
        for k, v in conf.data["detector"].items():
            if k != "pre_nms":
                setattr(cfg.backbone, k, v)
        cfg.backbone.cfg_path = str(conf.darknet_cfg)
    else:
        cfg.backbone.name = "maskrcnn"
    return cfg


def build(conf: Config, state: Dict[str, torch.Tensor], device, model_overrides=None):
    """(program config, model) with `state` copied into its parameters and
    frozen statistics; the model is built without its own initialization."""
    from poet_tpu_torch.models import build_model

    cfg = program_config(conf, model_overrides)
    with torch.device("meta"):
        model = build_model(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    return cfg, model


def pose_server(cfg, model, batch: int, hw, device):
    from poet_tpu_torch.engine.serving import PoseServer

    return PoseServer(cfg, model, batch_size=batch, image_size=tuple(hw), device=device)
