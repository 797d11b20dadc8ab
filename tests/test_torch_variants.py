"""The model's options and the optimizer's against `poet_tpu`, on the CPU.

A.4 of the port: the aleatoric heads (and calibrate, which trains them
alone), the learned query embedding, the learned reference points, the
learned position embedding and the bf16 AdamW first moment. The model is
the gt-mode slice at small width (full ResNet-50-FPN, B=2, 2 encoder / 2
decoder layers, hidden 64, 4 heads, f32, dropout 0); JAX runs its v3
Pallas kernels in interpret mode (`enc_deform_impl='fused'`).

* the forward of each option alone and of all four together, the port's
  seeded weights carried to JAX by the reference-checkpoint converter,
  every output within 1e-5 of its scale (128x128);
* one train step with all four: losses (1e-5), grad norm and every gradient
  (the query table, the reference-point projection and the row/column
  tables among them) within 1e-4 of each tensor's max (256x128, whose level
  sizes are powers of two; the sampling-offset and attention kernels are
  perturbed off zero, without which no gradient reaches the position
  tables);
  the aleatoric rotation loss takes the SO(3) log map of each matched
  pair's relative rotation, which is ill-conditioned as the angle nears pi
  (the log map's cosine clamp sits 0.014 rad from it): with a pair 0.016
  rad from pi, JAX's own 'fused' and 'sep' cores part by 1.6e-4 of the
  loss, and the flagship batch's uniform rotations put a pair there in
  most draws. The steps with the aleatoric loss therefore take as each
  valid query's target rotation the geodesic midpoint of the first and the
  last decoder layer's predictions (`_midpoint_targets`), at most pi/2 from
  both, and assert that margin;
* `label_params` against JAX's for each option and for calibrate;
* calibrate: 3 steps of the port's `make_train_step` against JAX's
  `make_train_step` with its own optimizer (SGD(0.9), clip 0.1, whose norm
  takes every gradient, the frozen transformer's included): losses and
  grad norm (1e-5, 1e-4) each step, every parameter within 1e-3 of lr
  after the third, the frozen ones bit-unchanged. SGD, being linear, puts
  the clip's factor into every update; AdamW would divide it out, and its
  first steps, lr g / (|g| + 1e-8), turn gradients that agree to 1e-4 of
  their max into updates up to lr apart where |g| ~ 1e-8 (seen: 1% of lr
  on 2 of 4096 head weights);
* `mu_bf16`: 5 updates of the port's optimizer and of optax on the same
  gradient arrays: the stored first moment bf16 and bit-equal to optax's,
  the parameters within 1e-6 of each tensor's max; the checkpoint round
  trip keeps the moment in bf16;
* `PoseServer`'s variances against JAX's `PoseServer`, tracker mode and
  detector mode (Mask R-CNN, `tests/test_torch_detect.py`'s small config);
* the learned embedding's 50x50 limit, and the bridge both ways for the new
  keys (the zoo import, `load_jax_params`).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from poet_tpu.utils.torch_import import (
    assemble_poet_params,
    convert_poet_checkpoint,
    convert_resnet_fpn,
    state_dict_to_numpy,
)
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_train import _capture_grads, _targets

B, ENC, DEC, HEADS, C = 2, 2, 2, 4, 64
FWD_HW, TRAIN_HW = (128, 128), (256, 128)
LR = 1e-3
# every output against its scale (max |JAX value|, at least 1): f32 through
# ResNet-50 and two layers of each stack in other orders
FWD_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
PARAM_ATOL = 1e-3 * LR
# mu_bf16: the parameters after 5 updates, against each tensor's max
MU_PARAM_RTOL = 1e-6
# the least distance from pi (rad) of a matched pair's relative rotation
# angle in the steps with the aleatoric loss (see the module docstring)
ROTATION_MARGIN = 1.0
# detector-mode variances on each side's own detections, whose boxes differ
# by ~5e-4 px (tests/test_torch_detect.py holds the poses there to 1e-3)
DET_RTOL = 1e-3

ALL = {"aleatoric": True, "query_embedding": "learned", "reference_points": "learned",
       "position_embedding": "learned"}
OPTIONS = {k: {k: v} for k, v in ALL.items()}
OPTIONS["all"] = ALL


def _t(x):
    return torch.from_numpy(np.array(x))


def _set_options(cfg, opts):
    for k, v in opts.items():
        if k == "position_embedding":
            cfg.backbone.position_embedding = v
        elif k in ("mu_bf16", "sgd", "clip_max_norm", "lr"):
            setattr(cfg.optim, k, v)
        else:
            setattr(cfg.model, k, v)


def _configs(opts, hidden=C, layers=(ENC, DEC)):
    from poet_tpu.config import PoETConfig
    from poet_tpu_torch.flagship import flagship_config

    jcfg, tcfg = PoETConfig(), flagship_config("float32")
    for cfg in (jcfg, tcfg):
        m = cfg.model
        m.enc_layers, m.dec_layers = layers
        m.hidden_dim, m.nheads, m.dim_feedforward = hidden, HEADS, 2 * hidden
        m.dtype, m.dropout = "float32", 0.0
        cfg.optim.lr = LR
        _set_options(cfg, opts)
    jcfg.model.enc_deform_impl = "fused"
    jcfg.model.enc_remat = "off"          # remat cannot partial-eval interpreted kernels
    return jcfg, tcfg


def _port_model(tcfg, seed=0, perturb=False):
    """The port's seeded model; `perturb`: the sampling-offset and attention
    kernels N(0, 0.02) instead of zero."""
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    model = init_weights(build_model(tcfg), seed=seed)
    if perturb:
        g = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith(("sampling_offsets.weight", "attention_weights.weight")):
                    p.normal_(0.0, 0.02, generator=g)
    return model


def _reference_keys(sd):
    """A port state dict in the reference checkpoint's names: the learned
    position embedding under the Joiner's `backbone.1.`."""
    return {("backbone.1." + k[len("position_embedding."):])
            if k.startswith("position_embedding.") else k: v for k, v in sd.items()}


def _bridge(model, tcfg):
    """The port's weights as JAX `params`, through `poet_tpu`'s converter."""
    sd = state_dict_to_numpy(model.state_dict())
    tree = convert_poet_checkpoint(_reference_keys(sd), enc_layers=tcfg.model.enc_layers,
                                   dec_layers=tcfg.model.dec_layers, nheads=HEADS,
                                   aleatoric=tcfg.model.aleatoric)
    tree["backbone"] = {"fpn_body": convert_resnet_fpn(sd, prefix="backbone.backbone.")}
    return {"params": tree}


def _to_port(tcfg, tree):
    """A JAX parameter-shaped tree -> state dict under port names."""
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.jax_params import load_jax_params

    holder = load_jax_params(build_model(tcfg), jax.device_get(tree))
    return {k: v.clone() for k, v in holder.state_dict().items()}


def _batch(hw, seed=0):
    from poet_tpu_torch.flagship import flagship_batch

    images, pad_mask, targets = flagship_batch(B, *hw, seed=seed)
    return images, pad_mask, _targets(targets)


def _jax_inputs(images, pad_mask, targets):
    return jnp.asarray(images), jnp.asarray(pad_mask), {k: jnp.asarray(v)
                                                        for k, v in targets.items()}


def _predicted_rotations(model, batch):
    images, pad_mask, targets = batch
    with torch.no_grad():
        return copy.deepcopy(model).eval()(_t(images), _t(pad_mask),
                                           {k: _t(v) for k, v in targets.items()})["rotations"]


def _midpoint_targets(model, batch):
    """The batch with each valid query's target rotation the geodesic
    midpoint of the first and last decoder layers' predicted rotations."""
    from scipy.spatial.transform import Rotation

    images, pad_mask, targets = batch
    rot = _predicted_rotations(model, batch).double().numpy()
    first, last = rot[0], rot[-1]
    half = Rotation.from_rotvec(Rotation.from_matrix(
        np.swapaxes(first, -1, -2).reshape(-1, 3, 3) @ last.reshape(-1, 3, 3)).as_rotvec() / 2)
    mid = (first.reshape(-1, 3, 3) @ half.as_matrix()).reshape(first.shape)
    valid = np.arange(first.shape[1])[None, :] < targets["n_boxes"][:, None]
    targets = dict(targets, relative_rotation=np.where(
        valid[..., None, None], mid, targets["relative_rotation"]).astype(np.float32))
    return images, pad_mask, targets


def _rotation_margin(model, batch):
    """pi minus the largest relative rotation angle between a valid query's
    predicted rotation (every decoder layer) and its target (gt mode: query
    q is matched to target q)."""
    _, _, targets = batch
    rot = _predicted_rotations(model, batch)
    rel = rot.double() @ _t(targets["relative_rotation"]).double().transpose(-1, -2)
    cos = (rel.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    valid = torch.arange(rot.shape[2])[None, :] < _t(targets["n_boxes"])[:, None]
    return float(np.pi - torch.arccos(cos.clamp(-1, 1))[:, valid].max())


def _assert_scaled(got, want, rtol, name):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float64) / scale, np.asarray(want) / scale,
                               rtol=0, atol=rtol, err_msg=name)


# ---------------------------------------------------------------------------
# the forward of each option
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("option", list(OPTIONS))
def test_forward_matches_jax(option):
    from jax.experimental.pallas import tpu as pltpu

    from poet_tpu.models import build_model as jbuild

    jcfg, tcfg = _configs(OPTIONS[option])
    model = _port_model(tcfg).eval()
    images, pad_mask, targets = _batch(FWD_HW)
    with pltpu.force_tpu_interpret_mode():
        want = jbuild(jcfg).apply(_bridge(model, tcfg), *_jax_inputs(images, pad_mask, targets),
                                  deterministic=True)
    with torch.no_grad():
        got = model(_t(images), _t(pad_mask), {k: _t(v) for k, v in targets.items()})
    assert set(got) == set(want)
    assert ("translations_aleatoric" in got) == tcfg.model.aleatoric
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape, k
        if k in ("pred_classes", "n_boxes", "query_valid", "pred_boxes", "pred_scores"):
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        else:
            _assert_scaled(got[k].numpy(), w, FWD_RTOL, k)


def test_learned_options_change_the_forward():
    """Each option moves the poses away from the default model's (the same
    seed): none of them is silently the default."""
    images, pad_mask, targets = _batch(FWD_HW)
    args = (_t(images), _t(pad_mask), {k: _t(v) for k, v in targets.items()})
    with torch.no_grad():
        base = _port_model(_configs({})[1]).eval()(*args)["translations"]
        for option in ("query_embedding", "reference_points", "position_embedding"):
            out = _port_model(_configs(OPTIONS[option])[1]).eval()(*args)["translations"]
            assert float((out - base).abs().max()) > 1e-3, option


# ---------------------------------------------------------------------------
# the gradients with every option
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grad_setup():
    from jax.experimental.pallas import tpu as pltpu

    from poet_tpu.engine.train import TrainState, make_train_step
    from poet_tpu.models import build_model as jbuild

    jcfg, tcfg = _configs(ALL)
    model = _port_model(tcfg, perturb=True)
    params = _bridge(model, tcfg)
    batch = _midpoint_targets(model, _batch(TRAIN_HW))
    assert _rotation_margin(model, batch) > ROTATION_MARGIN
    tx = _capture_grads()
    state = TrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    with pltpu.force_tpu_interpret_mode():
        new_state, metrics = make_train_step(jbuild(jcfg), jcfg, tx, donate=False)(
            state, *_jax_inputs(*batch), jax.random.PRNGKey(0))
    return tcfg, model, batch, {k: float(v) for k, v in metrics.items()}, \
        _to_port(tcfg, new_state.opt_state)


def test_losses_and_grad_norm_with_every_option(grad_setup):
    from poet_tpu_torch.engine.train import make_optimizer, make_train_step, prepare_batch

    tcfg, model, batch, want, _ = grad_setup
    m = copy.deepcopy(model)
    step = make_train_step(m, tcfg, make_optimizer(tcfg, m, steps_per_epoch=10))
    got = {k: float(v) for k, v in step(*prepare_batch(tcfg, *batch, device="cpu"),
                                        None).items()}
    assert set(got) == set(want)
    for k in want:
        # the norm of the gradients, each held to GRAD_RTOL of its max below
        rtol = GRAD_RTOL if k == "grad_norm" else LOSS_RTOL
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


def test_gradients_with_every_option(grad_setup):
    """Every gradient of the port's loss against JAX's, the new parameters'
    among them (each nonzero: the options are on the gradient's path)."""
    from poet_tpu_torch.engine.train import make_loss_fn, prepare_batch

    tcfg, model, batch, _, want = grad_setup
    m = copy.deepcopy(model).train()
    total, _ = make_loss_fn(m, tcfg)(*prepare_batch(tcfg, *batch, device="cpu"), None)
    total.backward()
    got = {n: p.grad for n, p in m.named_parameters() if p.grad is not None}
    new = ("query_embed.weight", "transformer.reference_points.weight",
           "transformer.reference_points.bias", "position_embedding.row_embed.weight",
           "position_embedding.col_embed.weight",
           "translation_head_aleatoric.0.layers.0.weight",
           f"rotation_head_aleatoric.{DEC - 1}.layers.2.bias")
    for name in new:
        assert name in got and float(got[name].abs().max()) > 0, name
    for name, g in got.items():
        ref = want[name].numpy()
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=GRAD_RTOL * scale + GRAD_ATOL,
                                   err_msg=name)
    assert len(got) > 100


# ---------------------------------------------------------------------------
# param groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("option", list(OPTIONS) + ["calibrate"])
def test_label_params_match_jax(option):
    """Every port parameter's group equals the groups of the JAX leaves
    under its flax path, and every trained JAX leaf is covered."""
    from poet_tpu.engine.train import label_params as jlabel
    from poet_tpu.models import build_model as jbuild
    from poet_tpu_torch.engine.train import label_params
    from poet_tpu_torch.utils.jax_params import flax_path

    opts = dict(ALL, calibrate=True) if option == "calibrate" else OPTIONS[option]
    jcfg, tcfg = _configs(opts)
    jcfg.model.enc_deform_impl = "sep"
    images, pad_mask, targets = _jax_inputs(*_batch((64, 64)))
    jmodel = jbuild(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), images, pad_mask,
                                                targets))
    jl = {tuple(k.key for k in path)[1:]: lab
          for path, lab in jax.tree_util.tree_leaves_with_path(jlabel(shapes, jcfg))}
    got = label_params(_port_model(tcfg), tcfg)
    covered = set()
    for name, lab in got.items():
        module, leaf = name.rsplit(".", 1)
        if ".self_attn.out_proj" in name and ".decoder." in name:
            module = module.rsplit(".", 1)[0]               # flax MHA's `out`
        prefix = flax_path(module)
        if leaf == "level_embed":                           # a parameter of the module itself
            prefix += (leaf,)
        under = {p: lb for p, lb in jl.items() if p[:len(prefix)] == prefix}
        assert under and set(under.values()) == {lab}, (name, prefix, set(under.values()))
        covered.update(under)
    # every trained JAX leaf has a port parameter (the frozen backbone's batch
    # norm statistics are buffers in the port)
    assert {p for p, lb in jl.items() if lb != "frozen"} <= covered
    labels = list(got.values())
    if option == "calibrate":
        assert set(labels) == {"main", "frozen"}
        assert {n.split(".")[0] for n, lab in got.items() if lab == "main"} == {
            "translation_head_aleatoric", "rotation_head_aleatoric"}
    for name in ("query_embed.weight", "position_embedding.row_embed.weight"):
        if name in got and option != "calibrate":
            assert got[name] == "main", name
    if "transformer.reference_points.weight" in got and option != "calibrate":
        assert got["transformer.reference_points.weight"] == "linear_proj"


# ---------------------------------------------------------------------------
# calibrate: three steps against JAX make_train_step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def calibrate_runs():
    from jax.experimental.pallas import tpu as pltpu

    from poet_tpu.engine.train import TrainState, make_optimizer as jmake, make_train_step
    from poet_tpu.models import build_model as jbuild
    from poet_tpu_torch.engine.train import fetch_metrics, make_optimizer
    from poet_tpu_torch.engine.train import make_train_step as port_step
    from poet_tpu_torch.engine.train import prepare_batch

    jcfg, tcfg = _configs(dict(ALL, calibrate=True, sgd=True))
    model = _port_model(tcfg, perturb=True)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    params = _bridge(model, tcfg)
    # the pose heads are frozen: each step predicts the rotations the targets
    # were made from
    batches = [_midpoint_targets(model, _batch(TRAIN_HW, seed=s)) for s in range(3)]
    assert min(_rotation_margin(model, b) for b in batches) > ROTATION_MARGIN

    tx = jmake(jcfg, params, steps_per_epoch=10)
    state = TrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    step = make_train_step(jbuild(jcfg), jcfg, tx, donate=False)
    jax_metrics = []
    with pltpu.force_tpu_interpret_mode():
        for batch in batches:
            state, metrics = step(state, *_jax_inputs(*batch), jax.random.PRNGKey(0))
            jax_metrics.append({k: float(v) for k, v in metrics.items()})

    opt = make_optimizer(tcfg, model, steps_per_epoch=10)
    pstep = port_step(model, tcfg, opt)
    port_metrics = [fetch_metrics(pstep(*prepare_batch(tcfg, *batch, device="cpu"), None))
                    for batch in batches]
    return (tcfg, model, opt, initial, port_metrics, jax_metrics,
            _to_port(tcfg, state.params))


def test_calibrate_steps_match_jax(calibrate_runs):
    """Losses and grad norm of each step (the norm over every gradient:
    the frozen transformer's are not zero), then every parameter within
    1e-3 of lr: the clip divided the heads' gradients by that norm."""
    tcfg, model, opt, _, got, want, want_params = calibrate_runs
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for k in w:
            rtol = GRAD_RTOL if k == "grad_norm" else LOSS_RTOL
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=f"step {i} {k}")
        assert w["grad_norm"] > tcfg.optim.clip_max_norm      # the clip acted
    heads = sum(p.numel() for p in opt.params)
    reached = sum(p.numel() for p in opt.clip_params)
    assert reached > 2 * heads                                 # the norm is not the heads'
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want_params[name].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def test_calibrate_trains_the_aleatoric_heads_alone(calibrate_runs):
    _, model, _, initial, _, _, want_params = calibrate_runs
    moved = 0
    for name, p in model.state_dict().items():
        if "_head_aleatoric." in name:
            moved += int(not torch.equal(p, initial[name]))
        else:
            assert torch.equal(p, initial[name]), name             # bit-unchanged
            assert torch.equal(want_params[name], initial[name]), name
    assert moved > 10


# ---------------------------------------------------------------------------
# mu_bf16
# ---------------------------------------------------------------------------

def _masked_leaves(tree):
    """{flax path: array} of a masked optimizer-state tree (MaskedNode
    leaves of other groups hold no array)."""
    return {tuple(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _nested(flat):
    out = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


@pytest.fixture(scope="module")
def mu_runs():
    from poet_tpu.engine.train import make_optimizer as jmake
    from poet_tpu_torch.engine.train import make_optimizer

    opts = dict(ALL, mu_bf16=True, clip_max_norm=0.0)
    jcfg, tcfg = _configs(opts, hidden=32, layers=(1, 1))
    model = _port_model(tcfg)
    params = _bridge(model, tcfg)
    backbone = params["params"].pop("backbone")        # frozen: no update, no state
    tx = jmake(jcfg, params, steps_per_epoch=10)
    update = jax.jit(tx.update)
    state = tx.init(params)
    rng = np.random.default_rng(3)
    opt = make_optimizer(tcfg, model, steps_per_epoch=10)
    named = dict(model.named_parameters())
    trained = {id(p) for p in opt.params}
    zeros = jax.tree_util.tree_map(np.zeros_like, backbone)
    for i in range(5):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.normal(size=x.shape) * 10.0 ** rng.uniform(-4, 0))
            .astype(np.float32), params)
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
        port_grads = _to_port(tcfg, {"params": dict(grads["params"], backbone=zeros)})
        for name, p in named.items():
            if id(p) in trained:
                p.grad = port_grads[name].clone()
        opt.step()
    mu = {}
    for label in ("main", "linear_proj"):            # the AdamW groups with parameters
        mu.update(_masked_leaves(state.inner_states[label].inner_state[0].mu))
    mu_dtypes = {a.dtype for a in mu.values()}
    mu = _nested({k: a.astype(np.float32) for k, a in mu.items()})
    params["params"]["backbone"] = backbone
    mu["params"]["backbone"] = zeros
    return tcfg, model, opt, mu_dtypes, _to_port(tcfg, mu), _to_port(tcfg, params)


def test_mu_bf16_first_moment_is_bf16_and_equals_optax(mu_runs):
    tcfg, model, opt, mu_dtypes, want_mu, _ = mu_runs
    assert mu_dtypes == {jnp.dtype(jnp.bfloat16)}
    n = 0
    for name, p in model.named_parameters():
        st = opt.torch_opt.state.get(p)
        if not st:
            continue
        assert st["exp_avg"].dtype == torch.bfloat16 and st["exp_avg_sq"].dtype == torch.float32
        assert st["step"] == 5
        assert torch.equal(st["exp_avg"].float(), want_mu[name]), name
        n += 1
    assert n == len(opt.params) > 50


def test_mu_bf16_parameters_match_optax(mu_runs):
    _, model, opt, _, _, want = mu_runs
    trained = {id(p) for p in opt.params}
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=0,
                                   atol=MU_PARAM_RTOL * float(np.abs(ref).max()), err_msg=name)
        assert id(p) in trained or name.startswith("backbone.")


def test_mu_bf16_state_round_trip_keeps_bf16(mu_runs, tmp_path):
    from poet_tpu_torch.engine.checkpoint import load_checkpoint, save_checkpoint
    from poet_tpu_torch.engine.train import Optimizer

    tcfg, model, opt, _, _, _ = mu_runs
    path = save_checkpoint(str(tmp_path), "checkpoint.pth", model, opt, 0, 5, tcfg)
    payload, _ = load_checkpoint(path)
    fresh = copy.deepcopy(model)
    opt2 = Optimizer(tcfg, fresh, steps_per_epoch=10)
    opt2.load_state_dict(payload["optimizer"])
    for p, q in zip(opt.params, opt2.params):
        a, b = opt.torch_opt.state[p], opt2.torch_opt.state[q]
        assert b["exp_avg"].dtype == torch.bfloat16 and torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"]) and a["step"] == b["step"]


# ---------------------------------------------------------------------------
# PoseServer's variances
# ---------------------------------------------------------------------------

def test_pose_server_variances_tracker_mode():
    from poet_tpu.engine.serving import PoseServer as JServer
    from poet_tpu_torch.engine.serving import PoseServer

    jcfg, tcfg = _configs(ALL)
    jcfg.model.enc_deform_impl = "sep"          # the server's XLA program; the same function
    model = _port_model(tcfg)
    params = _bridge(model, tcfg)
    images, _, targets = _batch(FWD_HW)
    boxes = (targets["boxes"], targets["labels"], targets["n_boxes"])
    want = JServer(jcfg, params, batch_size=B, image_size=FWD_HW).infer(images, *boxes)
    server = PoseServer(tcfg, model, batch_size=B, image_size=FWD_HW, device="cpu")
    got = server.infer(images, *boxes)
    assert set(got) == set(want) and {"translation_var", "rotation_var"} <= set(got)
    for k in ("translation_var", "rotation_var", "translation", "rotation"):
        _assert_scaled(got[k], want[k], FWD_RTOL, k)
    assert (got["translation_var"] > 0).all() and got["rotation_var"].shape == (B, 10, 3)
    streamed = list(server.stream([images], lambda prev: boxes))
    for k in got:
        np.testing.assert_array_equal(streamed[0][k], got[k], err_msg=k)


def test_pose_server_variances_detector_mode():
    """Mask R-CNN detector mode: the variances of each port row beside the
    JAX row of the same class and box (the two detectors' rows agree to
    ~5e-4 px), within DET_RTOL of scale; `stream` answers what `infer` does."""
    from poet_tpu.engine.serving import PoseServer as JServer
    from poet_tpu.models import build_model as jbuild
    from poet_tpu.utils.torch_import import convert_maskrcnn_heads, convert_resnet_fpn as jfpn
    from poet_tpu_torch.engine.serving import PoseServer
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.jax_params import load_jax_params
    from tests.test_detector_numeric_parity import _rcnn_state_dict
    from tests.test_torch_detect import H_IMG, NCLS, W_IMG, _configs as detect_configs

    jcfg, tcfg = detect_configs()
    for cfg in (jcfg, tcfg):
        cfg.model.aleatoric = True
    jcfg.model.enc_deform_impl = "sep"
    tree = jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                      jnp.zeros((1, 64, 64), bool), None)["params"]
    tree = jax.tree_util.tree_map(np.asarray, tree)
    sd = _rcnn_state_dict(num_classes=NCLS)
    tree["backbone"] = {"fpn_body": jfpn(sd), "detector": convert_maskrcnn_heads(sd)}
    images = np.random.default_rng(11).uniform(size=(B, H_IMG, W_IMG, 3)).astype(np.float32)
    want = JServer(jcfg, {"params": tree}, batch_size=B, image_size=(H_IMG, W_IMG)).infer(images)
    model = load_jax_params(build_model(tcfg), tree)
    server = PoseServer(tcfg, model, batch_size=B, image_size=(H_IMG, W_IMG), device="cpu")
    got = server.infer(images)
    np.testing.assert_array_equal(got["n_boxes"], want["n_boxes"])
    scale = np.array([W_IMG, H_IMG, W_IMG, H_IMG])
    paired = 0
    for b in range(B):
        n = int(want["n_boxes"][b])
        for j in range(n):
            i = [i for i in range(n) if got["classes"][b, i] == want["classes"][b, j]
                 and (np.abs(got["boxes"][b, i] - want["boxes"][b, j]) * scale).max() < 5e-3]
            assert len(i) >= 1, (b, j)
            for k in ("translation_var", "rotation_var"):
                _assert_scaled(got[k][b, i[0]], want[k][b, j], DET_RTOL, f"{k} {b} {j}")
            paired += 1
    assert paired >= 6
    streamed = list(server.stream([images]))
    for k in ("translation_var", "rotation_var"):
        np.testing.assert_array_equal(streamed[0][k], got[k], err_msg=k)
        assert np.isfinite(got[k]).all() and (got[k] > 0).all()


# ---------------------------------------------------------------------------
# the learned embedding's limit, the bridge
# ---------------------------------------------------------------------------

def test_position_embedding_learned_matches_jax_and_refuses_past_50():
    from poet_tpu.models.backbone import PositionEmbeddingLearned as JPos
    from poet_tpu_torch.models.backbone import PositionEmbeddingLearned

    mask = np.zeros((2, 7, 9), bool)
    jmod = JPos(num_pos_feats=8)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(mask))
    port = PositionEmbeddingLearned(8)
    with torch.no_grad():
        port.row_embed.weight.copy_(_t(params["params"]["row_embed"]))
        port.col_embed.weight.copy_(_t(params["params"]["col_embed"]))
    want = np.asarray(jmod.apply(params, jnp.asarray(mask)))
    with torch.no_grad():
        got = port(_t(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 2, 5, :8], got[1, 0, 5, :8])     # x features first
    # a stride-8 YOLO level at 480x640 is 60x80: both refuse it
    big = np.zeros((1, 60, 80), bool)
    with pytest.raises(ValueError, match="50x50"):
        jmod.apply(params, jnp.asarray(big))
    with pytest.raises(ValueError, match="50x50"):
        port(_t(big))
    with pytest.raises(ValueError, match="50x50"):
        port(_t(np.zeros((1, 40, 51), bool)))


def test_bridge_both_ways_for_the_new_keys():
    """A zoo file of the port's weights (reference names: the detector under
    `backbone.0.`, the learned tables under `backbone.1.`): JAX's
    `assemble_poet_params` gives JAX init's tree, which `load_jax_params`
    loads back bit for bit; the port's own zoo import gives its state dict,
    and drops the aleatoric heads for a model without them, as JAX does."""
    from poet_tpu.models import build_model as jbuild
    from poet_tpu_torch.engine.checkpoint import zoo_to_port
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.jax_params import load_jax_params

    jcfg, tcfg = _configs(ALL)
    jcfg.model.enc_deform_impl = "sep"
    model = _port_model(tcfg, seed=5)
    sd = state_dict_to_numpy(model.state_dict())
    zoo = _reference_keys({("backbone.0." + k[len("backbone."):])
                           if k.startswith("backbone.") else k: v for k, v in sd.items()})
    for k in ("query_embed.weight", "transformer.reference_points.bias",
              "backbone.1.row_embed.weight", "translation_head_aleatoric.1.layers.2.weight"):
        assert k in zoo, k
    tree = assemble_poet_params(zoo, ENC, DEC, HEADS, aleatoric=True)
    images, pad_mask, targets = _jax_inputs(*_batch((64, 64)))
    jmodel = jbuild(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), images, pad_mask,
                                                targets))["params"]
    flat = {tuple(k.key for k in p): v.shape
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    want = {tuple(k.key for k in p): v.shape
            for p, v in jax.tree_util.tree_leaves_with_path(shapes)}
    assert flat == want
    back = load_jax_params(build_model(tcfg), tree).state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k

    zoo_t = {k: torch.from_numpy(v) for k, v in zoo.items()}
    ported = zoo_to_port(zoo_t, aleatoric=True)
    assert set(ported) == set(sd) and all(torch.equal(ported[k], _t(sd[k])) for k in sd)
    plain = zoo_to_port(zoo_t, aleatoric=False)
    assert set(ported) - set(plain) == {k for k in sd if "_head_aleatoric." in k}
    without = {k: v for k, v in zoo_t.items() if "_head_aleatoric." not in k}
    with pytest.raises(KeyError, match="aleatoric"):
        zoo_to_port(without, aleatoric=True)
