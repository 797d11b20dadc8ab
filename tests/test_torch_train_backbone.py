"""Training on detections (bbox_mode='backbone') against `poet_tpu`, on the CPU.

Two detectors at small size, frozen, as in JAX: the Mask R-CNN of
`tests/test_torch_detect.py` (2 images of 128x160, 4 classes, 32
proposals, 10 detections, its seeded well-conditioned weights) and the
YOLOv4-CSP mini cfg of `tests/test_torch_yolov4.py` (2 images of 128x128,
`flagship.darknet_state`), each under a PoET of 2 + 2 layers, hidden 64,
f32, dropout 0. JAX runs its `make_train_step` (forward, `match_poses` on
the model's own detections, losses, backward, update) with its v3 Pallas
kernels in interpret mode and its CPU RoIAlign (the slab path: its Pallas
RoIAlign has no JVP, and JAX's step differentiates through the Mask R-CNN
heads, ROADMAP C2); the port its `make_train_step`, which matches the
forward's queries inside the step.

The targets are the detector's own detections (every valid query has a
target of its class with GIoU 1, so the match is real: the matched count is
asserted) with seeded poses. The sampling-offset and attention kernels
are perturbed off zero (`_perturb`), and every ReLU's pre-activation is
asserted at least RELU_MARGIN from its kink (`_relu_margin`). Detect+pose losses are chaotic in the box
coordinates (the box embedding's sin/cos(c 2^k)), and the two detectors'
boxes differ by ~5e-4 px (f32 through the backbones in other orders): both
models here round the detections' pixel corners to whole pixels, each side
at least 1 px, before they select their queries (`_snap`, applied by a
test subclass on each side), so both steps see the same queries. Compared over 2 SGD steps (linear: the updates carry
the gradients' and the clip's errors, where AdamW's first steps would
magnify f32 noise on tiny gradients to lr): losses within 1e-5 and grad
norm within 1e-4 relative each step, the first step's every gradient within
1e-4 of its max, every parameter within 1e-3 of lr after the second, the
detector bit-unchanged.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

B, LR = 2, 1e-3
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
PARAM_ATOL = 1e-3 * LR
STEPS = 2
# the least |pre-activation| of any ReLU on the path: one within the two
# frameworks' rounding of 0 (~1e-6 here) takes its token's gradient into
# one side's weight row and not the other's (seen: 6e-7, seed 3 on YOLO)
RELU_MARGIN = 1e-5
PERTURB_SEED = {"maskrcnn": 3, "yolov4": 4}


def _t(x):
    return torch.from_numpy(np.array(x))


def _snap(boxes, xp):
    """xyxy pixel boxes with each corner rounded to a whole pixel and each
    side at least 1 px (a sliver would round to zero area: no GIoU)."""
    r = xp.round(boxes)
    x1, y1, x2, y2 = (r[..., i] for i in range(4))
    return xp.stack([x1, y1, xp.maximum(x2, x1 + 1), xp.maximum(y2, y1 + 1)], -1)


def _snap_port(model):
    """The port model, its detections' boxes snapped before the query
    selection."""
    select = model._select_detections

    def snapped(dets, Q, image_size):
        return select(dict(dets, boxes=_snap(dets["boxes"], torch)), Q, image_size)

    model._select_detections = snapped
    return model


def _snap_jax(jmodel):
    """JAX's PoET with the same snapping (a subclass: `_select_detections`
    is a plain method of the flax module)."""
    from poet_tpu.models.poet import PoET

    class SnappedPoET(PoET):
        def _select_detections(self, detections, Q, image_size):
            return super()._select_detections(
                dict(detections, boxes=_snap(detections["boxes"], jnp)), Q, image_size)

    return SnappedPoET(backbone=jmodel.backbone.clone(), cfg=jmodel.cfg,
                       position_embedding=jmodel.position_embedding,
                       position_embedding_scale=jmodel.position_embedding_scale)


def _capture():
    """Passes the gradients on and keeps them in its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))


def _maskrcnn():
    from poet_tpu.models import build_model as jbuild
    from poet_tpu.utils.torch_import import convert_maskrcnn_heads, convert_resnet_fpn
    from tests.test_detector_numeric_parity import _rcnn_state_dict
    from tests.test_torch_detect import H_IMG, NCLS, W_IMG, _configs

    jcfg, tcfg = _configs()
    init_cfg = copy.deepcopy(jcfg)
    init_cfg.model.enc_deform_impl = "sep"          # the same tree, no interpreted kernel
    tree = jax.jit(jbuild(init_cfg).init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                          jnp.zeros((1, 64, 64), bool), None)["params"]
    tree = jax.tree_util.tree_map(np.asarray, tree)
    sd = _rcnn_state_dict(num_classes=NCLS)
    tree["backbone"] = {"fpn_body": convert_resnet_fpn(sd), "detector": convert_maskrcnn_heads(sd)}
    images = np.random.default_rng(11).uniform(size=(B, H_IMG, W_IMG, 3)).astype(np.float32)
    return jcfg, tcfg, tree, images


def _yolo(tmp_path_factory):
    from poet_tpu.models import build_model as jbuild
    from poet_tpu_torch.flagship import darknet_state
    from tests.test_torch_yolov4 import H_IMG, MINI_CFG, W_IMG, _configs, _frozen

    cfg_path = tmp_path_factory.mktemp("cfg") / "mini.cfg"
    cfg_path.write_text(MINI_CFG)
    jcfg, tcfg = _configs(str(cfg_path))
    for cfg in (jcfg, tcfg):
        # every detection a query: no top-k among near-equal scores
        cfg.model.num_queries = cfg.backbone.max_detections
    jcfg.model.enc_deform_impl = "fused"
    images = np.random.default_rng(5).uniform(size=(B, H_IMG, W_IMG, 3)).astype(np.float32)
    tree = jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(0), jnp.asarray(images[:1]),
                                      jnp.zeros((1, H_IMG, W_IMG), bool), None)["params"]
    tree = jax.tree_util.tree_map(np.asarray, tree)
    tree["backbone"]["body"] = darknet_state(_frozen(MINI_CFG))
    return jcfg, tcfg, tree, images


def _relu_margin(model, images, pad_mask):
    """The least |pre-activation| of every ReLU in the transformer's FFNs
    and the pose heads, in the port's forward."""
    from poet_tpu_torch.models.poet import MLP

    mins, hooks = [], []
    for name, m in model.named_modules():
        if name.endswith("linear1"):
            hooks.append(m.register_forward_hook(
                lambda mod, a, out: mins.append(float(out.abs().min()))))
        elif isinstance(m, MLP):
            for layer in m.layers[:-1]:
                hooks.append(layer.register_forward_hook(
                    lambda mod, a, out: mins.append(float(out.abs().min()))))
    try:
        with torch.no_grad():
            copy.deepcopy(model).eval()(_t(images), _t(pad_mask))
    finally:
        for h in hooks:
            h.remove()
    return min(mins)


def _perturb(tree, seed):
    """Sampling-offset and attention kernels N(0, 0.02) instead of zero: at
    zero every encoder sampling point sits on a cell edge (pixel-centre grid
    plus integer offsets), where d_loc is one-sided and f32 rounding picks
    the side wherever a level's size is not a power of two (128x160)."""
    rng = np.random.default_rng(seed)
    for layer in tree["transformer"].values():
        if not isinstance(layer, dict):
            continue
        for attn in ("self_attn", "cross_attn"):
            for proj in ("sampling_offsets", "attention_weights"):
                if proj in layer.get(attn, {}):
                    k = layer[attn][proj]["kernel"]
                    layer[attn][proj]["kernel"] = (0.02 * rng.normal(size=k.shape)).astype(
                        np.float32)


@pytest.fixture(scope="module", params=["maskrcnn", "yolov4"])
def runs(request, tmp_path_factory):
    from jax.experimental.pallas import tpu as pltpu

    from poet_tpu.engine.train import TrainState, make_optimizer as jmake, make_train_step
    from poet_tpu.models import build_model as jbuild
    from poet_tpu_torch.engine.train import (
        fetch_metrics, make_loss_fn, make_optimizer, make_train_step as port_step, match_outputs,
        prepare_batch,
    )
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.jax_params import load_jax_params

    jcfg, tcfg, tree, images = (_maskrcnn() if request.param == "maskrcnn"
                                else _yolo(tmp_path_factory))
    _perturb(tree, PERTURB_SEED[request.param])
    for cfg in (jcfg, tcfg):
        cfg.model.dropout = 0.0
        cfg.optim.lr, cfg.optim.sgd = LR, True
    jcfg.model.enc_remat = "off"          # remat cannot partial-eval interpreted kernels
    H, W = images.shape[1:3]
    pad_mask = np.zeros((B, H, W), bool)
    model = _snap_port(load_jax_params(build_model(tcfg), tree))
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    assert _relu_margin(model, images, pad_mask) > RELU_MARGIN

    # the targets: the detector's own (snapped) detections, seeded poses
    Q = tcfg.model.num_queries
    with torch.no_grad():
        out = copy.deepcopy(model).eval()(_t(images), _t(pad_mask))
    rng = np.random.default_rng(21)
    q, r = np.linalg.qr(rng.normal(size=(B * Q, 3, 3)))
    q *= np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[:, :, 0] *= np.linalg.det(q)[:, None]
    targets = {"boxes": out["pred_boxes"].numpy(), "labels": out["pred_classes"].numpy(),
               "n_boxes": out["n_boxes"].numpy().astype(np.int32),
               "relative_position": rng.normal(size=(B, Q, 3)).astype(np.float32),
               "relative_rotation": q.reshape(B, Q, 3, 3).astype(np.float32)}
    batch = (images, pad_mask, targets)

    # JAX: make_train_step with its own optimizer behind a transform that
    # keeps the raw gradients
    params = {"params": tree}
    tx = optax.chain(_capture(), jmake(jcfg, params, steps_per_epoch=10))
    state = TrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    step = make_train_step(_snap_jax(jbuild(jcfg)), jcfg, tx, donate=False)
    jargs = (jnp.asarray(images), jnp.asarray(pad_mask),
             {k: jnp.asarray(v) for k, v in targets.items()})
    jax_metrics, jax_grads = [], None
    with pltpu.force_tpu_interpret_mode():
        for _ in range(STEPS):
            state, metrics = step(state, *jargs, jax.random.PRNGKey(0))
            jax_metrics.append({k: float(v) for k, v in metrics.items()})
            if jax_grads is None:
                jax_grads = jax.device_get(state.opt_state[0])

    # the port: its first step's gradients, then the steps
    m = copy.deepcopy(model).train()
    dev_batch = prepare_batch(tcfg, *batch, device="cpu")
    assert dev_batch[3] is None                     # matched in the step, not on the host
    total, _ = make_loss_fn(m, tcfg)(*dev_batch, None)
    total.backward()
    port_grads = {n: p.grad for n, p in m.named_parameters() if p.grad is not None}
    with torch.no_grad():
        matched = int(match_outputs(tcfg, m.eval()(_t(images), _t(pad_mask)),
                                    {k: _t(v) for k, v in targets.items()}).valid.sum())
    opt = make_optimizer(tcfg, model, steps_per_epoch=10)
    pstep = port_step(model, tcfg, opt)
    port_metrics = [fetch_metrics(pstep(*prepare_batch(tcfg, *batch, device="cpu"), None))
                    for _ in range(STEPS)]
    holder = build_model(tcfg)

    def to_port(t):
        load_jax_params(holder, jax.device_get(t))
        return {k: v.clone() for k, v in holder.state_dict().items()}

    return {"model": model, "initial": initial, "targets": targets, "matched": matched,
            "port_metrics": port_metrics, "jax_metrics": jax_metrics,
            "port_grads": port_grads, "jax_grads": to_port(jax_grads),
            "jax_params": to_port(state.params)}


def test_queries_match_their_targets(runs):
    n = runs["targets"]["n_boxes"]
    assert (n >= 2).all()
    assert runs["matched"] == int(n.sum()) > 0


def test_losses_and_grad_norm_match_jax(runs):
    for i, (got, want) in enumerate(zip(runs["port_metrics"], runs["jax_metrics"])):
        assert set(got) == set(want)
        for k in want:
            rtol = GRAD_RTOL if k == "grad_norm" else LOSS_RTOL
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=f"step {i} {k}")
        assert want["loss"] > 0


def test_gradients_match_jax(runs):
    got, want = runs["port_grads"], runs["jax_grads"]
    for name, g in got.items():
        ref = want[name].numpy()
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=GRAD_RTOL * scale + GRAD_ATOL,
                                   err_msg=name)
    assert not any(n.startswith("backbone.") for n in got)      # the detector is frozen
    assert len(got) > 100


def test_parameters_after_the_steps_match_jax(runs):
    moved = 0
    for name, p in runs["model"].state_dict().items():
        np.testing.assert_allclose(p.numpy(), runs["jax_params"][name].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
        if name.startswith("backbone."):
            assert torch.equal(p, runs["initial"][name]), name
        else:
            moved += int(not torch.equal(p, runs["initial"][name]))
    assert moved > 100
