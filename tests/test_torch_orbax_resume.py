"""Resuming the port from `poet_tpu`'s orbax checkpoints, on the CPU.

* The paper-config `TrainState` (ResNet-50-FPN Mask R-CNN + the 6/6-layer
  transformer, f32): its shapes from `jax.eval_shape` (no ResNet-50 init),
  every leaf filled from a numpy seed (counts consistent with the step),
  written by `poet_tpu.engine.checkpoint.save_checkpoint`. The port's
  `load_resume(<dir>, model=...)` merged into a port model must equal
  `load_jax_params` of `poet_tpu`'s own `load_checkpoint` bit for bit, every
  parameter and buffer; `Optimizer.load_optax_state` must give optax's
  moments and counts in the port's layout bit for bit (AdamW, `--mu_bf16`,
  `--sgd`, and `--grad_accum_steps 2` with a non-zero `mini_step`), a Dense
  moment transposed and MHA's packed in_proj checked by hand beside the
  shared layout rules.
* The committed fixture `tests/data/orbax_resume/` (what `chip_smoke.py`'s
  phase 30 resumes on the card): `write_resume_fixture` writes it, one
  `poet_tpu` train step of the SMALL transformer (hidden 32, 1 + 1 layers)
  on the YOLOv4-CSP mini cfg of `tests/test_torch_yolov4.py` (`mini.cfg`
  beside it), gt mode, 128x128, SGD with momentum (its trace and counts
  non-zero; the card's resumed step is held to the CPU's at 1e-3 of lr,
  where AdamW's divide by the moments would carry the f32 rounding residue
  of near-zero gradients, such as the biases before a GroupNorm, to a
  sizeable share of lr), and `digests.json` holds each
  leaf's key path, dtype, shape and SHA-256. `poet_tpu`'s `load_checkpoint`
  of the committed directory must equal a fresh seeded build leaf for leaf
  (within RESTEP_RTOL: XLA's CPU reductions may split by thread count), and
  its digests the port's reader's and orbax's. To regenerate it, from the
  repo root:

      JAX_PLATFORMS=cpu python -c "from tests.test_torch_orbax_resume import \\
          write_resume_fixture as w; w('tests/data/orbax_resume')"
"""

import copy
import dataclasses
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "orbax_resume"
FIXTURE_CFG = "tests/data/orbax_resume/mini.cfg"      # repo-relative, as config.json holds it
FIXTURE_SEED = 3
# a fresh build of the fixture against the committed one: the init is exact,
# the train step's f32 sums may split by XLA's thread count
RESTEP_RTOL = 1e-6
VARIANTS = {"adamw": {}, "mu_bf16": {"mu_bf16": True}, "sgd": {"sgd": True},
            "accum2": {"grad_accum_steps": 2}}
STEPS_PER_EPOCH = 10


def _fill(shapes, seed, counts):
    """Every leaf of a ShapeDtypeStruct tree from a numpy seed: floats
    N(0, 1) in the leaf's dtype, integers from `counts` by leaf name."""
    rng = np.random.default_rng(seed)

    def one(path, s):
        if jnp.issubdtype(s.dtype, jnp.floating):
            return np.asarray(rng.standard_normal(s.shape, dtype=np.float32)).astype(s.dtype)
        name = getattr(path[-1], "name", getattr(path[-1], "key", ""))
        return np.full(s.shape, counts[name], s.dtype)

    return jax.tree_util.tree_map_with_path(one, shapes)


@pytest.fixture(scope="module")
def paper():
    """(JAX config, port config, the paper-config parameter shapes)."""
    from poet_tpu.config import PoETConfig
    from poet_tpu.models import build_model as jbuild
    from poet_tpu_torch.flagship import flagship_batch, flagship_config

    jcfg = PoETConfig()
    jcfg.backbone.name, jcfg.model.dtype = "maskrcnn", "float32"
    jcfg.model.enc_deform_impl = jcfg.model.dec_deform_impl = "sep"
    images, pad_mask, targets = flagship_batch(1, 64, 64)
    jm = jbuild(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), images, pad_mask, targets))
    return jcfg, flagship_config("float32"), shapes


def _paper_checkpoint(paper, variant, root):
    """The variant's filled TrainState written by poet_tpu's save_checkpoint;
    returns (path, JAX config, port config, step)."""
    from poet_tpu.engine.checkpoint import save_checkpoint
    from poet_tpu.engine.train import TrainState, make_optimizer

    jcfg, tcfg, shapes = copy.deepcopy(paper[0]), copy.deepcopy(paper[1]), paper[2]
    for cfg in (jcfg, tcfg):
        for k, v in VARIANTS[variant].items():
            setattr(cfg.optim, k, v)
    accum = jcfg.optim.grad_accum_steps
    updates, mini = 3, (1 if accum > 1 else 0)
    step = updates * accum + mini
    tx = make_optimizer(jcfg, shapes, STEPS_PER_EPOCH)
    opt_shapes = jax.eval_shape(tx.init, shapes)
    counts = {"count": updates, "gradient_step": updates, "mini_step": mini}
    state = TrainState(_fill(shapes, 1, counts), _fill(opt_shapes, 2, counts), np.int32(step))
    save_checkpoint(str(root), "checkpoint", state, 4, jcfg)
    return str(root / "checkpoint"), jcfg, tcfg, step


def _inner_states(opt_state, accum, clip):
    """multi_transform's inner states in optax's restored tree."""
    if accum > 1:
        opt_state = opt_state["inner_opt_state"]
    if clip:
        opt_state = opt_state[1]
    return opt_state["inner_states"]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_paper_checkpoint_resumes_bit_for_bit(paper, variant, tmp_path, capsys):
    from poet_tpu.engine.checkpoint import load_checkpoint as jax_load

    from poet_tpu_torch.engine.checkpoint import load_resume, merge_params
    from poet_tpu_torch.engine.train import make_optimizer
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.jax_params import jax_state_dict, load_jax_params

    path, jcfg, tcfg, step = _paper_checkpoint(paper, variant, tmp_path)
    want, want_start = jax_load(path)
    want = jax.tree_util.tree_map(np.asarray, want)

    ref = load_jax_params(build_model(tcfg), want["params"])
    model = build_model(tcfg)
    payload, start = load_resume(path, model=model, cfg=tcfg)
    assert start == want_start == 5 and payload["step"] == step
    assert "differs from the command line" not in capsys.readouterr().out
    missing, unexpected = merge_params(model, payload["model"])
    assert missing == [] and unexpected == []
    got_sd, ref_sd = model.state_dict(), ref.state_dict()
    assert list(got_sd) == list(ref_sd)
    for k, v in ref_sd.items():
        assert torch.equal(got_sd[k], v), k

    opt = make_optimizer(tcfg, model, steps_per_epoch=STEPS_PER_EPOCH)
    opt.load_optax_state(payload["optax"], payload["step"])
    o = tcfg.optim
    inner = _inner_states(want["opt_state"], o.grad_accum_steps, o.clip_max_norm > 0)
    assert opt.updates == 3 and opt.micro_step == (1 if o.grad_accum_steps > 1 else 0)
    state = opt.torch_opt.state
    assert set(opt.group_names) == {"main", "linear_proj"}
    for label, names in opt.group_names.items():
        st = inner[label]["inner_state"]
        if o.sgd:
            moments = {"momentum_buffer": jax_state_dict(model, st[1][0]["trace"])}
        else:
            moments = {"exp_avg": jax_state_dict(model, st[0]["mu"]),
                       "exp_avg_sq": jax_state_dict(model, st[0]["nu"])}
        for name in names:
            p = dict(model.named_parameters())[name]
            for key, tree in moments.items():
                got = state[p][key]
                want_t = torch.from_numpy(tree[name])
                if key == "exp_avg" and o.mu_bf16:
                    assert got.dtype == torch.bfloat16
                    want_t = want_t.to(torch.bfloat16)
                assert torch.equal(got, want_t), (name, key)
            if not o.sgd:
                assert float(state[p]["step"]) == 3
    # the layout rules by hand: a Dense moment is the kernel's transpose,
    # MHA's in_proj packs query, key and value
    mu = (inner["main"]["inner_state"][1][0]["trace"] if o.sgd
          else inner["main"]["inner_state"][0]["mu"])["params"]["transformer"]
    key = "momentum_buffer" if o.sgd else "exp_avg"
    named = dict(model.named_parameters())
    lin = state[named["transformer.encoder.layers.0.linear1.weight"]][key]
    k = np.asarray(mu["encoder_layer_0"]["linear1"]["kernel"], np.float32)
    assert torch.equal(lin.float(), torch.from_numpy(k.T.copy()))
    attn = mu["decoder_layer_0"]["self_attn"]
    C = attn["query"]["kernel"].shape[0]
    packed = np.concatenate([np.asarray(attn[p]["kernel"], np.float32).reshape(C, C).T
                             for p in ("query", "key", "value")])
    got = state[named["transformer.decoder.layers.0.self_attn.in_proj_weight"]][key]
    assert torch.equal(got.float(), torch.from_numpy(packed))
    if o.grad_accum_steps > 1:
        acc = jax_state_dict(model, want["opt_state"]["acc_grads"])
        assert [tuple(a.shape) for a in opt._acc] == [acc[n].shape for n in opt.clip_names]
        for a, n in zip(opt._acc, opt.clip_names):
            assert torch.equal(a, torch.from_numpy(acc[n])), n


def test_width_note_and_mismatched_optimizer(paper, tmp_path, capsys):
    """config.json's differing widths are printed, as a note; a tree that is
    not the one this configuration builds raises."""
    from poet_tpu_torch.engine.checkpoint import load_checkpoint
    from poet_tpu_torch.engine.train import make_optimizer
    from poet_tpu_torch.models import build_model

    path, _, tcfg, step = _paper_checkpoint(paper, "adamw", tmp_path)
    model = build_model(tcfg)
    other = copy.deepcopy(tcfg)
    other.model.num_queries = 7
    from poet_tpu_torch.engine.checkpoint import load_resume

    payload, _ = load_resume(path, model=model, cfg=other)
    assert f"num_queries {tcfg.model.num_queries} != 7" in capsys.readouterr().out
    with pytest.raises(ValueError, match="needs the model"):
        load_checkpoint(path)
    payload2, start = load_checkpoint(path, model)
    assert start == 5 and payload2["step"] == payload["step"] == step
    accum = copy.deepcopy(tcfg)
    accum.optim.grad_accum_steps = 2
    with pytest.raises(ValueError, match="MultiSteps"):
        make_optimizer(accum, model, STEPS_PER_EPOCH).load_optax_state(payload["optax"], step)
    with pytest.raises(ValueError, match="updates"):
        make_optimizer(tcfg, model, STEPS_PER_EPOCH).load_optax_state(payload["optax"],
                                                                        step + 1)


# ---------------------------------------------------------------- the fixture
def fixture_configs(cfg_path):
    """(JAX config, port config) of the fixture: `tests/test_torch_yolov4.py`'s
    mini YOLOv4-CSP cfg under the SMALL transformer of
    `tests/test_torch_cli.py`, gt mode, f32, dropout 0, SGD with momentum
    and the clip."""
    from tests.test_torch_yolov4 import _configs

    jcfg, tcfg = _configs(cfg_path)
    for cfg in (jcfg, tcfg):
        cfg.model.bbox_mode = "gt"
        cfg.model.enc_layers = cfg.model.dec_layers = 1
        cfg.model.hidden_dim, cfg.model.nheads, cfg.model.dim_feedforward = 32, 2, 64
        cfg.model.num_queries, cfg.model.n_classes = 4, 3
        cfg.optim.sgd = True
    jcfg.model.enc_deform_impl = jcfg.model.dec_deform_impl = "sep"
    return jcfg, tcfg


def fixture_batch(cfg, seed=FIXTURE_SEED):
    """The fixture's batch: `chip_smoke.orbax_batch` (phase 30 resumes on
    its own seed's)."""
    from chip_smoke import orbax_batch

    return orbax_batch(cfg, seed)


def _perturb(tree, seed):
    """The sampling-offset and attention kernels N(0, 0.02) instead of
    zero: at zero every encoder sampling point sits on a cell edge, where
    d_loc is one-sided and the card's and the CPU's roundings may pick
    different sides (`tests/test_torch_train_backbone.py:_perturb`)."""
    rng = np.random.default_rng(seed + 100)
    for layer in tree["transformer"].values():
        for attn in ("self_attn", "cross_attn"):
            for proj in ("sampling_offsets", "attention_weights"):
                sub = layer.get(attn, {}) if isinstance(layer, dict) else {}
                if proj in sub:
                    k = sub[proj]["kernel"]
                    sub[proj]["kernel"] = (0.02 * rng.normal(size=k.shape)).astype(np.float32)


def write_resume_fixture(out_dir, seed=0):
    """One poet_tpu train step of the fixture's model from a seeded init
    (the deformable attention's offset and attention kernels perturbed,
    `_perturb`),
    written with poet_tpu's save_checkpoint to OUT/checkpoint, the mini cfg
    to OUT/mini.cfg and the leaves' digests (as the port's reader reads
    them) to OUT/digests.json. Returns the checkpoint's path."""
    from poet_tpu.engine.checkpoint import save_checkpoint
    from poet_tpu.engine.train import TrainState, make_optimizer, make_train_step
    from poet_tpu.models import build_model as jbuild

    from poet_tpu_torch.utils.orbax_format import read_pytree, tree_digests
    from tests.test_torch_yolov4 import MINI_CFG

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "mini.cfg").write_text(MINI_CFG)
    jcfg, _ = fixture_configs(str(out / "mini.cfg"))
    images, pad_mask, targets = fixture_batch(jcfg)
    model = jbuild(jcfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), images, pad_mask, targets)
    params = jax.tree_util.tree_map(np.asarray, params)
    _perturb(params["params"], seed)
    tx = make_optimizer(jcfg, params, steps_per_epoch=STEPS_PER_EPOCH)
    state = TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    step = make_train_step(model, jcfg, tx, donate=False)
    state, _ = step(state, images, pad_mask, targets, jax.random.PRNGKey(seed + 1))
    saved = copy.deepcopy(jcfg)
    saved.backbone.cfg_path = FIXTURE_CFG
    if (out / "checkpoint").exists():
        shutil.rmtree(out / "checkpoint")
    save_checkpoint(str(out), "checkpoint", state, 0, saved)
    digests = tree_digests(read_pytree(str(out / "checkpoint")))
    (out / "digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    return str(out / "checkpoint")


def test_fixture_is_small_and_its_digests_hold():
    """The committed directory: under 2 MB, every leaf's digest equal to the
    port's reader's and to orbax's restore."""
    from poet_tpu.engine.checkpoint import load_checkpoint as jax_load

    from poet_tpu_torch.utils.orbax_format import read_pytree, tree_digests

    size = sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file())
    assert size <= 2 * 2**20, size
    want = json.loads((FIXTURE / "digests.json").read_text())
    assert tree_digests(read_pytree(str(FIXTURE / "checkpoint"))) == want
    restored, start = jax_load(str(FIXTURE / "checkpoint"))
    assert start == 1 and restored["step"] == 1
    arrays = jax.tree_util.tree_map(lambda x: np.asarray(x) if hasattr(x, "shape") else x,
                                    restored)
    assert tree_digests(arrays) == want


def test_fixture_equals_a_fresh_seeded_build(tmp_path):
    """poet_tpu's load_checkpoint of the committed directory against a
    fresh write_resume_fixture, leaf for leaf: the same tree, the same
    dtypes and shapes, the seeded init's parameters... after one step
    within RESTEP_RTOL of scale, the counts equal."""
    from poet_tpu.engine.checkpoint import load_checkpoint as jax_load

    fresh = write_resume_fixture(tmp_path / "fresh")
    (a, sa), (b, sb) = jax_load(str(FIXTURE / "checkpoint")), jax_load(fresh)
    assert sa == sb
    la, ta = jax.tree_util.tree_flatten_with_path(a, is_leaf=lambda x: x is None)
    lb, tb = jax.tree_util.tree_flatten_with_path(b, is_leaf=lambda x: x is None)
    assert ta == tb
    for (path, x), (_, y) in zip(la, lb):
        if x is None or isinstance(x, (int, float)):
            assert x == y, path
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        if not np.issubdtype(x.dtype, np.floating):
            assert np.array_equal(x, y), path
            continue
        scale = max(float(np.abs(y).max()), 1e-30) if y.size else 1.0
        np.testing.assert_allclose(x / scale, y / scale, rtol=0, atol=RESTEP_RTOL,
                                   err_msg=jax.tree_util.keystr(path))
    with open(os.path.join(fresh, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["backbone"]["cfg_path"] == FIXTURE_CFG


def test_fixture_resumes_into_the_port(tmp_path):
    """The port model and optimizer from the committed directory, with the
    config built from its config.json as chip_smoke.py's phase 30 builds
    it; one resumed port step on the CPU runs and moves the transformer."""
    from poet_tpu_torch.config import PoETConfig
    from poet_tpu_torch.engine.checkpoint import load_resume, merge_params
    from poet_tpu_torch.engine.train import (
        fetch_metrics, make_optimizer, make_train_step, prepare_batch,
    )
    from poet_tpu_torch.models import build_model

    cfg = PoETConfig.from_json((FIXTURE / "checkpoint" / "config.json").read_text())
    cfg.backbone.cfg_path = str(ROOT / cfg.backbone.cfg_path)
    _, tcfg = fixture_configs(str(FIXTURE / "mini.cfg"))
    for section in ("model", "optim"):
        got, want = dataclasses.asdict(getattr(cfg, section)), dataclasses.asdict(
            getattr(tcfg, section))
        differ = {k for k in want if got[k] != want[k]} - {"enc_deform_impl",
                                                           "dec_deform_impl"}
        assert not differ, (section, differ)
    model = build_model(cfg)
    payload, start = load_resume(str(FIXTURE / "checkpoint"), model=model, cfg=cfg)
    assert start == 1 and payload["step"] == 1
    assert merge_params(model, payload["model"]) == ([], [])
    opt = make_optimizer(cfg, model, steps_per_epoch=STEPS_PER_EPOCH)
    opt.load_optax_state(payload["optax"], payload["step"])
    assert opt.updates == 1
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, cfg, opt)
    m = fetch_metrics(step(*prepare_batch(cfg, *fixture_batch(cfg, seed=5), "cpu"),
                           torch.Generator().manual_seed(0)))
    assert np.isfinite(m["loss"])
    after = model.state_dict()
    assert not torch.equal(after["transformer.level_embed"], before["transformer.level_embed"])
    assert all(torch.equal(after[k], v) for k, v in before.items() if k.startswith("backbone."))
