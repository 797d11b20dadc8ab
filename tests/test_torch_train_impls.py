"""PoET built with each deformable-attention impl, against JAX's, on the CPU.

A small PoET: the full ResNet-50-FPN at 64x64 (levels 4x4, 2x2, 1x1 and the
extra 1x1: power-of-two sizes keep the encoder's initial sampling points on
cell edges in both frameworks alike, and the 22 tokens keep the interpreted
Pallas kernels fast), B=1, 2 encoder / 2 decoder layers, hidden 32, 4 heads,
FFN 64, dropout 0, f32. JAX builds it three ways:
  * 'pallas' in both stacks (the one-hot Pallas kernels, interpret mode);
  * 'fused' in the encoder with POET_FUSED_T=0 and POET_V3_MERGED_ADJOINT=1
    (the v3 kernels with the merged adjoint, interpret mode; the decoder's
    'auto', which JAX resolves to 'mxu', keeps the interpreter to one stack);
  * 'sep' in both (an XLA formulation; the module test of every XLA value is
    in tests/test_torch_deform_attn_impls.py);
and the port builds the same config (`ModelConfig.enc_deform_impl`,
`dec_deform_impl`, `merged_adjoint`). One parameter tree serves all three:
JAX's init gives each impl the same tree, and `load_jax_params` loads it
into each port model unchanged. The forward (every decoder layer's poses)
within 1e-5 of scale, and JAX's loss (`poet_tpu/engine/train.py:
make_loss_fn`'s matcher and criterion on those outputs, what
`make_train_step` differentiates) with its gradient against the port's loss
and backward: losses within 1e-5, each gradient within 1e-4 of its max (PR
2's tolerances, tests/test_torch_train.py).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poet_tpu.utils.torch_import import (
    convert_poet_checkpoint,
    convert_resnet_fpn,
    state_dict_to_numpy,
)
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_train import GRAD_ATOL, GRAD_RTOL, LOSS_RTOL, _targets

B, HW, ENC, DEC, HIDDEN, HEADS, FFN = 1, (64, 64), 2, 2, 32, 4, 64
# forward: f32 through ResNet-50 and two layers of each stack, relative to
# the output scale
FWD_RTOL_SCALE = 1e-5
# name: (enc_deform_impl and dec_deform_impl of both configs, the port's
# merged_adjoint, JAX's environment)
VARIANTS = {
    "pallas": ("pallas", "pallas", False, {}),
    "fused_merged": ("fused", "auto", True,
                     {"POET_FUSED_T": "0", "POET_V3_MERGED_ADJOINT": "1"}),
    "sep": ("sep", "sep", False, {}),
}


def _configs(enc_impl, dec_impl, merged):
    from poet_tpu.config import PoETConfig
    from poet_tpu_torch.flagship import flagship_config

    jcfg, tcfg = PoETConfig(), flagship_config("float32")
    for cfg in (jcfg, tcfg):
        cfg.model.enc_layers, cfg.model.dec_layers = ENC, DEC
        cfg.model.hidden_dim, cfg.model.nheads, cfg.model.dim_feedforward = HIDDEN, HEADS, FFN
        cfg.model.dtype, cfg.model.dropout = "float32", 0.0
        cfg.model.enc_deform_impl, cfg.model.dec_deform_impl = enc_impl, dec_impl
    tcfg.model.merged_adjoint = merged
    jcfg.model.enc_remat = "off"        # numerics unchanged; the port saves inputs only
    return jcfg, tcfg


@pytest.fixture(scope="module")
def shared():
    """The port's seeded weights as a JAX tree, and a batch."""
    from poet_tpu_torch.flagship import flagship_batch
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    _, tcfg = _configs("auto", "auto", False)
    sd = state_dict_to_numpy(init_weights(build_model(tcfg), seed=0).state_dict())
    tree = convert_poet_checkpoint(sd, enc_layers=ENC, dec_layers=DEC, nheads=HEADS)
    tree["backbone"] = {"fpn_body": convert_resnet_fpn(sd, prefix="backbone.backbone.")}
    images, pad_mask, targets = flagship_batch(B, *HW, seed=0)
    return {"params": tree}, (images, pad_mask, _targets(targets))


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request, shared):
    """JAX's forward outputs, losses and gradients for one impl, and the port
    model built with the same impl and loaded from the JAX tree."""
    from jax.experimental.pallas import tpu as pltpu

    from poet_tpu.engine import train as jtrain
    from poet_tpu.models import build_model as jbuild
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.jax_params import load_jax_params

    *impls, merged, env = VARIANTS[request.param]
    params, (images, pad_mask, targets) = shared
    jcfg, tcfg = _configs(*impls, merged)
    jmodel = jbuild(jcfg)
    jin = (jnp.asarray(images), jnp.asarray(pad_mask),
           {k: jnp.asarray(v) for k, v in targets.items()})
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)                       # read while JAX traces
        # JAX's init of this impl gives the converted tree's structure
        tree = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *jin))
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(params)
        m = jcfg.model

        def loss_and_outputs(trained, backbone, images, pad_mask, targets):
            """make_loss_fn's loss at f32 and dropout 0, with the outputs kept."""
            outputs = jmodel.apply({"params": {**trained, "backbone": backbone}}, images,
                                   pad_mask, targets, deterministic=True)
            match = jtrain.match_poses(
                outputs["pred_boxes"], outputs["pred_classes"], targets["boxes"],
                targets["labels"], outputs["n_boxes"], targets["n_boxes"],
                bbox_mode=m.bbox_mode, class_mode=m.class_mode,
                cost_bbox=jcfg.matcher.set_cost_bbox, cost_class=jcfg.matcher.set_cost_class,
                giou_thresh=jcfg.matcher.giou_thresh)
            losses = jtrain.crit.compute_losses(outputs, targets, match,
                                                rotation_mode=m.rotation_representation,
                                                aleatoric=m.aleatoric)
            total = jtrain.crit.weighted_total(losses, jcfg.loss.translation_loss_coef,
                                               jcfg.loss.rotation_loss_coef)
            return total, (outputs, dict(losses, loss=total))

        # the gradient of everything but the frozen backbone (JAX's step
        # zeroes the backbone's; the port's has none)
        trained = {k: v for k, v in params["params"].items() if k != "backbone"}
        with pltpu.force_tpu_interpret_mode():
            (_, (outputs, losses)), grads = jax.jit(
                jax.value_and_grad(loss_and_outputs, has_aux=True))(
                    trained, params["params"]["backbone"], *jin)
    model = load_jax_params(build_model(tcfg), jax.device_get(params))
    grad_tree = {"params": {**jax.device_get(grads), "backbone": jax.tree_util.tree_map(
        np.zeros_like, jax.device_get(params["params"]["backbone"]))}}
    holder = load_jax_params(build_model(tcfg), grad_tree)
    want_grads = {k: v.clone() for k, v in holder.state_dict().items()}
    return (tcfg, model, {k: np.asarray(v) for k, v in outputs.items()},
            {k: float(v) for k, v in losses.items()}, want_grads)


def test_port_routes_match_the_variant(variant):
    from poet_tpu_torch.models.transformer import MSDeformAttn

    tcfg, model = variant[:2]
    adjoint = "merged" if tcfg.model.merged_adjoint else "pair"
    stacks = (model.transformer.encoder.layers, model.transformer.decoder.layers)
    for stack, impl in zip(stacks, (tcfg.model.enc_deform_impl, tcfg.model.dec_deform_impl)):
        cores = [m for layer in stack for m in layer.modules() if isinstance(m, MSDeformAttn)]
        assert len(cores) == len(stack) == 2
        route = "dense" if impl == "pallas" else "gather"
        assert {(m.impl, m.route, m.adjoint) for m in cores} == {(impl, route, adjoint)}


def test_forward_matches_jax(variant, shared):
    tcfg, model, want = variant[:3]
    _, (images, pad_mask, targets) = shared
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(images), torch.from_numpy(pad_mask),
                           {k: torch.from_numpy(targets[k]) for k in ("boxes", "labels",
                                                                      "n_boxes")})
    for k in ("translations", "rotations"):
        assert got[k].shape == want[k].shape and got[k].shape[:2] == (DEC, B)
        scale = max(float(np.abs(want[k]).max()), 1.0)
        np.testing.assert_allclose(got[k].numpy() / scale, want[k] / scale,
                                   atol=FWD_RTOL_SCALE, err_msg=k)
    for k in ("pred_boxes", "pred_classes", "n_boxes", "query_valid"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_train_step_losses_and_gradients_match_jax(variant, shared):
    """The port's loss and backward (the route's adjoint: its plain version
    on the CPU) against JAX's; frozen tensors get no gradient in the port
    (JAX's step zeroes theirs; here JAX does not differentiate them)."""
    from poet_tpu_torch.engine.train import label_params, make_loss_fn, prepare_batch

    tcfg, model, _, want_losses, want_grads = variant
    _, batch = shared
    m = copy.deepcopy(model).train()
    total, losses = make_loss_fn(m, tcfg)(*prepare_batch(tcfg, *batch, device="cpu"), None)
    total.backward()
    got = {k: float(v.detach()) for k, v in losses.items()}
    got["loss"] = float(total.detach())
    assert set(got) == set(want_losses)
    for k, v in want_losses.items():
        np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=k)
    grads = {n: p.grad for n, p in m.named_parameters() if p.grad is not None}
    labels = label_params(m, tcfg)
    for name, lab in labels.items():
        ref = want_grads[name].numpy()
        if lab == "frozen":
            assert name not in grads and not np.any(ref), name
            continue
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(grads[name].numpy(), ref, rtol=0,
                                   atol=GRAD_RTOL * scale + GRAD_ATOL, err_msg=name)
    assert sum(lab != "frozen" for lab in labels.values()) > 100
