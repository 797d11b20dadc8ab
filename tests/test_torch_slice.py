"""The whole gt-mode serving slice against `poet_tpu`, at small width.

Full-depth ResNet-50-FPN at 128x128, B=2, 2 encoder / 2 decoder layers,
hidden 64, 4 heads, FFN 128, Q=10, f32. The port's seeded weights go to the
JAX model through the reference-checkpoint converters; JAX runs
`build_model(cfg).apply` with `enc_deform_impl='fused'` (the v3 Pallas
kernel, interpret mode) and the port runs its `PoseServer` / PoET on the
CPU. Every decoder layer's translations and rotations are compared, with a
zero pad mask and with a right-side pad strip.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from poet_tpu.utils.torch_import import (
    convert_poet_checkpoint,
    convert_resnet_fpn,
    state_dict_to_numpy,
)
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

B, HW, ENC, DEC, HEADS = 2, (128, 128), 2, 2, 4
# relative to the output scale: f32 through ResNet-50 and two layers of
# each transformer stack, summed in different orders by XLA and torch
RTOL_SCALE = 1e-4


def _configs():
    from poet_tpu.config import PoETConfig
    from poet_tpu_torch.flagship import flagship_config

    jcfg = PoETConfig()
    tcfg = flagship_config("float32")
    for cfg in (jcfg, tcfg):
        cfg.model.enc_layers, cfg.model.dec_layers = ENC, DEC
        cfg.model.hidden_dim, cfg.model.nheads, cfg.model.dim_feedforward = 64, HEADS, 128
        cfg.model.dtype = "float32"
    jcfg.model.enc_deform_impl = "fused"
    return jcfg, tcfg


@pytest.fixture(scope="module")
def setup():
    from poet_tpu.models import build_model as jbuild
    from poet_tpu_torch.flagship import flagship_batch
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    jcfg, tcfg = _configs()
    model = init_weights(build_model(tcfg), seed=0).eval()
    sd = state_dict_to_numpy(model.state_dict())
    tree = convert_poet_checkpoint(sd, enc_layers=ENC, dec_layers=DEC, nheads=HEADS)
    tree["backbone"] = {"fpn_body": convert_resnet_fpn(sd, prefix="backbone.backbone.")}
    images, _, targets = flagship_batch(B, *HW, seed=0)
    return tcfg, model, jbuild(jcfg), {"params": tree}, images, targets


def _jax_outputs(jmodel, params, images, pad_mask, targets):
    from jax.experimental.pallas import tpu as pltpu

    jt = {k: jnp.asarray(targets[k]) for k in ("boxes", "labels", "n_boxes")}
    with pltpu.force_tpu_interpret_mode():
        out = jmodel.apply(params, jnp.asarray(images), jnp.asarray(pad_mask), jt,
                           deterministic=True)
    return {k: np.asarray(v) for k, v in out.items()}


def _close(got, want, name):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=RTOL_SCALE, err_msg=name)


@pytest.mark.parametrize("pad", ["none", "right_strip"])
def test_slice_matches_jax(setup, pad):
    tcfg, model, jmodel, params, images, targets = setup
    pad_mask = np.zeros((B,) + HW, bool)
    if pad == "right_strip":
        pad_mask[1, :, 88:] = True           # image 1: 40 right columns padded
        images = images.copy()
        images[pad_mask] = 0.0
    want = _jax_outputs(jmodel, params, images, pad_mask, targets)

    with torch.inference_mode():
        got = model(torch.from_numpy(images), torch.from_numpy(pad_mask),
                    {k: torch.from_numpy(targets[k]) for k in ("boxes", "labels", "n_boxes")})
    got = {k: v.numpy() for k, v in got.items()}
    assert got["translations"].shape == want["translations"].shape == (DEC, B, 10, 3)
    assert got["rotations"].shape == want["rotations"].shape == (DEC, B, 10, 3, 3)
    for lvl in range(DEC):
        _close(got["translations"][lvl], want["translations"][lvl], f"translations[{lvl}]")
        _close(got["rotations"][lvl], want["rotations"][lvl], f"rotations[{lvl}]")
    for k in ("pred_boxes", "pred_classes", "n_boxes", "query_valid"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    if pad == "none":
        # the serving endpoint (tracker mode, zero pad mask) gives the last layer
        from poet_tpu_torch.engine.serving import PoseServer

        server = PoseServer(tcfg, model, batch_size=B, image_size=HW, device="cpu")
        res = server.infer(images, targets["boxes"], targets["labels"], targets["n_boxes"])
        _close(res["translation"], want["translations"][-1], "server translation")
        _close(res["rotation"], want["rotations"][-1], "server rotation")
        np.testing.assert_array_equal(res["classes"], want["pred_classes"])
        assert server.latency_stats()["frames"] == 1
