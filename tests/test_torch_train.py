"""The port's train step against JAX `make_train_step`, on the CPU.

One train step of the slice (256x128, full ResNet-50, B=2, 2/2 layers,
hidden 64, 4 heads, dropout 0 — flax Dropout at rate 0 is the identity),
the same numpy inputs and weights to both packages at f32 (the v3 Pallas
kernel in interpret mode, `enc_deform_impl='fused'`): losses, grad norm and
every gradient, and the parameters after one update of SGD, of AdamW with
clipping, and of each accumulated over k=2; `label_params` through
`utils/jax_params.flax_path`; and, at 64x64 with dropout 0.1, the
generator's determinism and the loss falling over 15 steps with the frozen
backbone bit-identical. The pieces of the step are in
tests/test_torch_train_pieces.py.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from poet_tpu.utils.torch_import import (
    convert_poet_checkpoint,
    convert_resnet_fpn,
    state_dict_to_numpy,
)
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

# The slice is test_torch_slice.py's, twice as tall: at 128x128 the extra
# stride-128 level is 1x1, so each GroupNorm group of input_proj.3 holds two
# values, whose normalized output is +-1 whatever the input — its gradient is
# ~0 and both frameworks compute only rounding residue. Power-of-two level
# sizes keep the encoder's initial sampling points (reference grid + integer
# grid-init offsets) exactly on cell edges in both frameworks alike; elsewhere
# f32 rounding picks a side, and d_loc jumps between the two sides.
B, HW, ENC, DEC, HEADS, LR = 2, (256, 128), 2, 2, 4, 1e-3
# losses: the same f32 sums in other orders, relative
LOSS_RTOL = 1e-5
# each gradient tensor against its max |JAX value|: f32 through ResNet-50 and
# two layers of each transformer stack, backward in other orders (+ a floor
# for tensors whose gradient is exactly zero in both)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
# parameters after one update: a fraction of the step size lr
PARAM_ATOL = 1e-3 * LR


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# The slice: one train step against JAX make_train_step
# ---------------------------------------------------------------------------

def _configs(dropout=0.0):
    from poet_tpu.config import PoETConfig
    from poet_tpu_torch.flagship import flagship_config

    jcfg, tcfg = PoETConfig(), flagship_config("float32")
    for cfg in (jcfg, tcfg):
        cfg.model.enc_layers, cfg.model.dec_layers = ENC, DEC
        cfg.model.hidden_dim, cfg.model.nheads, cfg.model.dim_feedforward = 64, HEADS, 128
        cfg.model.dtype, cfg.model.dropout = "float32", dropout
        cfg.optim.lr = LR
    jcfg.model.enc_deform_impl = "fused"
    return jcfg, tcfg


def _capture_grads():
    """An optax transform that leaves the parameters and keeps the gradients
    in its state: `make_train_step` then hands back exactly its gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree_util.tree_map(jnp.zeros_like, grads),
                                           grads))


def _targets(targets):
    keys = ("boxes", "labels", "n_boxes", "relative_position", "relative_rotation")
    return {k: targets[k] for k in keys}


@pytest.fixture(scope="module")
def slice_setup():
    from jax.experimental.pallas import tpu as pltpu

    from poet_tpu.engine.train import TrainState, make_train_step
    from poet_tpu.models import build_model as jbuild
    from poet_tpu_torch.flagship import flagship_batch
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    jcfg, tcfg = _configs()
    model = init_weights(build_model(tcfg), seed=0)
    sd = state_dict_to_numpy(model.state_dict())
    tree = convert_poet_checkpoint(sd, enc_layers=ENC, dec_layers=DEC, nheads=HEADS)
    tree["backbone"] = {"fpn_body": convert_resnet_fpn(sd, prefix="backbone.backbone.")}
    params = {"params": tree}
    batches = []
    for seed in (0, 1):
        images, pad_mask, targets = flagship_batch(B, *HW, seed=seed)
        batches.append((images, pad_mask, _targets(targets)))

    jmodel = jbuild(jcfg)
    tx = _capture_grads()
    state = TrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    step = make_train_step(jmodel, jcfg, tx, donate=False)
    jax_out = []
    with pltpu.force_tpu_interpret_mode():
        for images, pad_mask, targets in batches:
            new_state, metrics = step(state, jnp.asarray(images), jnp.asarray(pad_mask),
                                      {k: jnp.asarray(v) for k, v in targets.items()},
                                      jax.random.PRNGKey(0))
            jax_out.append(({k: float(v) for k, v in metrics.items()},
                            jax.device_get(new_state.opt_state)))
    return jcfg, tcfg, model, params, batches, jax_out


@pytest.fixture(scope="module")
def to_port(slice_setup):
    """JAX parameter-shaped tree -> state dict under port names."""
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.jax_params import load_jax_params

    holder = build_model(slice_setup[1])

    def convert(tree):
        load_jax_params(holder, jax.device_get(tree))
        return {k: v.clone() for k, v in holder.state_dict().items()}

    return convert


@pytest.fixture(scope="module")
def port_grads(slice_setup):
    """The port's gradients of the loss on each batch (backward through the
    deformable adjoint's plain version), by parameter name."""
    from poet_tpu_torch.engine.train import make_loss_fn, prepare_batch

    _, tcfg, model, _, batches, _ = slice_setup
    out = []
    for batch in batches:
        m = copy.deepcopy(model).train()
        total, _ = make_loss_fn(m, tcfg)(*prepare_batch(tcfg, *batch, device="cpu"), None)
        total.backward()
        out.append({n: p.grad for n, p in m.named_parameters() if p.grad is not None})
    return out


def test_train_step_losses_and_grad_norm_match_jax(slice_setup):
    """`make_train_step` (forward, losses, backward, clip, AdamW) returns the
    losses and grad norm that JAX's step returns."""
    from poet_tpu_torch.engine.train import make_optimizer, make_train_step, prepare_batch

    jcfg, tcfg, model, params, batches, jax_out = slice_setup
    m = copy.deepcopy(model)
    step = make_train_step(m, tcfg, make_optimizer(tcfg, m, steps_per_epoch=10))
    got = {k: float(v) for k, v in
           step(*prepare_batch(tcfg, *batches[0], device="cpu"), None).items()}
    want = jax_out[0][0]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)


def test_train_step_gradients_match_jax(slice_setup, to_port, port_grads):
    """Every gradient of the port's loss (backward through the deformable
    adjoint) against the gradients JAX's `make_train_step` computed, mapped
    onto port names. Frozen tensors get none in the port and 0 in JAX."""
    from poet_tpu_torch.engine.train import label_params

    jcfg, tcfg, model, params, batches, jax_out = slice_setup
    want = to_port(jax_out[0][1])
    labels = label_params(model, tcfg)
    for name, lab in labels.items():
        ref = want[name].numpy()
        if lab == "frozen":
            assert name not in port_grads[0] and not np.any(ref), name
            continue
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(port_grads[0][name].numpy(), ref, rtol=0,
                                   atol=GRAD_RTOL * scale + GRAD_ATOL, err_msg=name)
    assert sum(lab != "frozen" for lab in labels.values()) > 100


def _jax_update(jcfg, params, grads_list, **optim):
    """optax: `make_optimizer` of the JAX package applied to `grads_list`.
    The frozen backbone is left out of the (jitted) update: it labels
    'frozen' (set_to_zero) and its gradients are 0, so neither its update nor
    the clip's global norm changes, and the compile halves."""
    from poet_tpu.engine.train import make_optimizer as jmake

    cfg = copy.deepcopy(jcfg)
    for k, v in optim.items():
        setattr(cfg.optim, k, v)

    def trained(tree):
        return {"params": {k: v for k, v in tree["params"].items() if k != "backbone"}}

    sub = trained(params)
    tx = jmake(cfg, sub, steps_per_epoch=10)
    update = jax.jit(tx.update)
    state = tx.init(sub)
    for grads in grads_list:
        updates, state = update(trained(grads), state, sub)
        sub = optax.apply_updates(sub, updates)
    return {"params": {**params["params"], **sub["params"]}}


def _port_update_on(tcfg, model, grads_list, **optim):
    """The port's `make_optimizer` on the slice model, fed the given
    port-named gradients."""
    from poet_tpu_torch.engine.train import make_optimizer

    cfg = copy.deepcopy(tcfg)
    for k, v in optim.items():
        setattr(cfg.optim, k, v)
    model = copy.deepcopy(model)
    opt = make_optimizer(cfg, model, steps_per_epoch=10)
    named = dict(model.named_parameters())
    trained = {id(p) for p in opt.params}
    for grads in grads_list:
        for name, p in named.items():
            if id(p) in trained:
                p.grad = grads[name].clone()
        opt.step()
    assert opt.updates == 1
    return model


def _assert_params_match(want, stepped, initial):
    moved = 0
    for name, p in stepped.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
        moved += int(not torch.equal(p.detach(), initial[name]))
    assert moved > 100


@pytest.mark.parametrize("variant", ["sgd", "sgd_accum2", "adamw_clip", "adamw_accum2"])
def test_params_after_one_update_match_jax(slice_setup, to_port, port_grads, variant):
    """SGD (linear in the gradient): the port's optimizer on the port's own
    gradients of the batches against optax on JAX's — the whole step. AdamW:
    its first update is lr * g / (|g| + 1e-8) per element, which turns the
    f32 noise of entries with |g| near 1e-8 (1e-4 of a tensor's max is what
    the gradient test holds) into up to lr; so the port's optimizer gets
    JAX's gradients of the step, on the full model (all param groups, clip,
    StepLR, MultiSteps), and is held to optax on them."""
    jcfg, tcfg, model, params, batches, jax_out = slice_setup
    initial = {k: v.detach().clone() for k, v in model.named_parameters()}
    n = 2 if variant.endswith("accum2") else 1
    optim = {"grad_accum_steps": n, "sgd": variant.startswith("sgd")}
    grads = port_grads[:n] if optim["sgd"] else [to_port(o[1]) for o in jax_out[:n]]
    stepped = _port_update_on(tcfg, model, grads, **optim)
    want = _jax_update(jcfg, params, [o[1] for o in jax_out[:n]], **optim)
    _assert_params_match(to_port(want), stepped, initial)


def test_train_and_eval_forward_share_the_match(slice_setup):
    """`make_eval_forward` matches the final layer exactly as the host-side
    training match does (gt mode: the identity)."""
    from poet_tpu_torch.engine.train import make_eval_forward, match_targets

    _, tcfg, model, _, batches, _ = slice_setup
    images, pad_mask, targets = batches[0]
    tg = {k: _t(v) for k, v in targets.items()}
    out = make_eval_forward(copy.deepcopy(model), tcfg)(_t(images), _t(pad_mask), tg)
    match = match_targets(tcfg, tg)
    assert torch.equal(out["match_tgt_idx"], match.tgt_idx)
    assert torch.equal(out["match_valid"], match.valid)
    assert out["pred_translation"].shape == (B, 10, 3)


# ---------------------------------------------------------------------------
# Dropout and training behaviour
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_train():
    """A dropout-0.1 model at 64x64 and a fixed batch, for behaviour tests."""
    from poet_tpu_torch.flagship import flagship_batch
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    _, tcfg = _configs(dropout=0.1)
    model = init_weights(build_model(tcfg), seed=1)
    images, pad_mask, targets = flagship_batch(B, 64, 64, seed=3)
    return tcfg, model, (images, pad_mask, _targets(targets))


def _run(tcfg, model, batch, seeds):
    from poet_tpu_torch.engine.train import (
        fetch_metrics,
        make_optimizer,
        make_train_step,
        prepare_batch,
    )

    model = copy.deepcopy(model)
    step = make_train_step(model, tcfg, make_optimizer(tcfg, model, steps_per_epoch=100))
    dev_batch = prepare_batch(tcfg, *batch, device="cpu")
    gen = torch.Generator().manual_seed(seeds[0])
    losses = [fetch_metrics(step(*dev_batch, gen))["loss"] for _ in seeds]
    return model, losses


def test_dropout_generator_makes_steps_reproducible(small_train):
    tcfg, model, batch = small_train
    m1, l1 = _run(tcfg, model, batch, [0])
    m2, l2 = _run(tcfg, model, batch, [0])
    m3, l3 = _run(tcfg, model, batch, [1])
    assert l1 == l2 and l1 != l3
    w = "transformer.encoder.layers.0.linear1.weight"
    assert torch.equal(m1.state_dict()[w], m2.state_dict()[w])
    assert not torch.equal(m1.state_dict()[w], m3.state_dict()[w])


def test_train_mode_without_generator_raises(small_train):
    from poet_tpu_torch.engine.train import make_loss_fn, prepare_batch

    tcfg, model, batch = small_train
    m = copy.deepcopy(model).train()
    with pytest.raises(ValueError, match="Generator"):
        make_loss_fn(m, tcfg)(*prepare_batch(tcfg, *batch, device="cpu"), None)


def test_loss_drops_and_backbone_stays_frozen(small_train):
    tcfg, model, batch = small_train
    before = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("backbone.")}
    stepped, losses = _run(tcfg, model, batch, list(range(15)))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    after = stepped.state_dict()
    assert before and all(torch.equal(after[k], v) for k, v in before.items())


def test_label_params_match_jax_through_flax_path(slice_setup):
    """The port's groups equal the JAX groups of the same tensors, with port
    module names mapped to flax paths by `utils/jax_params.flax_path`."""
    from poet_tpu.engine.train import label_params as jlabel
    from poet_tpu_torch.engine.train import label_params
    from poet_tpu_torch.utils.jax_params import flax_path

    jcfg, tcfg, model, params, _, _ = slice_setup
    jl = {}
    for path, lab in jax.tree_util.tree_leaves_with_path(jlabel(params, jcfg)):
        keys = tuple(k.key for k in path)[1:]       # drop 'params'
        jl.setdefault(keys[:-1], set()).add(lab)
    got = label_params(model, tcfg)
    for name, lab in got.items():
        module = flax_path(name.rsplit(".", 1)[0])
        if name.endswith(("in_proj_weight", "in_proj_bias")):
            module = flax_path(name.rsplit(".", 1)[0]) + ("query",)
        elif ".out_proj." in name and "self_attn" in name and "decoder" in name:
            module = flax_path(name.rsplit(".", 2)[0]) + ("out",)
        assert jl[module] == {lab}, (name, module, jl.get(module))
    counts = {lab: list(got.values()).count(lab) for lab in set(got.values())}
    assert counts["linear_proj"] == 2 * (ENC + DEC) and counts["frozen"] > 50
