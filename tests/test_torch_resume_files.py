"""The port's zoo-file readers against `poet_tpu`'s: `--resume` and
`--backbone_weights` on every kind of reference file that
`poet_tpu/utils/torch_import.py:load_state_dict_file` reads.

A small PoET (the full ResNet-50-FPN, 2 encoder / 2 decoder layers, hidden
64, 4 heads, FFN 128, f32, gt bbox mode) is seeded and its state dict put in
the reference's names (the Joiner's `backbone.0.`). That dict is written as
a `.npz`, as a bare `.pth`, and as a `.pth` under each of "model",
"state_dict" (with DDP's `module.` prefix) and "model_state_dict". Each file
goes through JAX's `load_resume` / `load_backbone_weights` and the port's;
JAX's tree is loaded into a port model with `load_jax_params`, and the two
port models' state dicts must be equal bit for bit. The port's own
checkpoint (it carries "config") behaves as before; a directory that is not
an orbax checkpoint raises.
"""

import argparse

import numpy as np
import pytest
import torch

import jax

from poet_tpu_torch.utils.jax_params import load_jax_params
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

ENC, DEC, HEADS = 2, 2, 4
KINDS = ("npz", "bare", "model", "state_dict", "model_state_dict")


def _config():
    from poet_tpu_torch.flagship import flagship_config

    cfg = flagship_config("float32")
    cfg.model.enc_layers, cfg.model.dec_layers = ENC, DEC
    cfg.model.hidden_dim, cfg.model.nheads, cfg.model.dim_feedforward = 64, HEADS, 128
    return cfg


def _model(seed=None):
    """The small PoET, seeded (`init_weights`) or, without a seed, every
    tensor zero (a model that a reader must fill)."""
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    model = build_model(_config())
    if seed is not None:
        return init_weights(model, seed=seed)
    with torch.no_grad():
        for v in model.state_dict().values():
            v.zero_()
    return model


def _write(path_base, sd, kind):
    """`sd` (name -> tensor) written as a zoo file of `kind`; returns its path."""
    if kind == "npz":
        path = f"{path_base}.npz"
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
        return path
    path = f"{path_base}_{kind}.pth"
    if kind == "bare":
        obj = sd
    elif kind == "state_dict":                      # a DDP-wrapped model's names
        obj = {"state_dict": {f"module.{k}": v for k, v in sd.items()}}
    else:
        obj = {kind: sd, "args": argparse.Namespace(lr=1e-4), "epoch": 49}
    torch.save(obj, path)
    return path


def _assert_same_state(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(seeded full model's state, the zoo files by kind, the detector's
    state, the detector files by kind)."""
    root = tmp_path_factory.mktemp("zoo")
    state = _model(seed=0).state_dict()
    zoo = {("backbone.0." + k[len("backbone."):] if k.startswith("backbone.") else k): v
           for k, v in state.items()}
    detector = {k[len("backbone."):]: v for k, v in _model(seed=1).state_dict().items()
                if k.startswith("backbone.")}
    return (state, {kind: _write(str(root / "poet_zoo"), zoo, kind) for kind in KINDS},
            detector, {kind: _write(str(root / "detector"), detector, kind) for kind in KINDS})


@pytest.mark.parametrize("kind", KINDS)
def test_resume_reads_zoo_file_as_jax_does(files, kind):
    from poet_tpu.engine.checkpoint import load_resume as jax_load_resume
    from poet_tpu_torch.engine.checkpoint import load_resume

    state, zoo, _, _ = files
    payload, start = load_resume(zoo[kind])
    assert start == 0 and set(payload) == {"model"}
    port = _model()
    port.load_state_dict(payload["model"])
    jax_payload, jax_start = jax_load_resume(zoo[kind], enc_layers=ENC, dec_layers=DEC,
                                             nheads=HEADS)
    assert jax_start == 0
    bridged = load_jax_params(_model(), jax_payload["params"])
    _assert_same_state(port.state_dict(), bridged.state_dict())
    _assert_same_state(port.state_dict(), state)


@pytest.mark.parametrize("kind", KINDS)
def test_backbone_weights_read_as_jax_does(files, kind):
    from poet_tpu.engine.checkpoint import load_resume as jax_load_resume
    from poet_tpu.utils.torch_import import load_backbone_weights as jax_load_backbone
    from poet_tpu_torch.cli import load_backbone_weights

    _, zoo, detector, detector_files = files
    cfg = _config()
    cfg.backbone.weights = detector_files[kind]
    port = _model()
    load_backbone_weights(port, cfg)
    # JAX's template: the small PoET's tree, every leaf zero
    tree = jax_load_resume(zoo["bare"], enc_layers=ENC, dec_layers=DEC,
                           nheads=HEADS)[0]["params"]
    zeros = jax.tree_util.tree_map(np.zeros_like, tree)
    merged, missing, unexpected = jax_load_backbone(zeros, detector_files[kind])
    assert missing == [] and unexpected == []
    bridged = load_jax_params(_model(), merged)
    _assert_same_state(port.state_dict(), bridged.state_dict())
    got = port.state_dict()
    for k, v in got.items():
        want = detector[k[len("backbone."):]] if k.startswith("backbone.") else 0 * v
        assert torch.equal(v, want), k


def test_port_checkpoint_resumes_as_before(files, tmp_path):
    """The port's own file (it carries "config"): parameters, optimizer
    state and epoch, in the port's names, unconverted."""
    from poet_tpu_torch.engine.checkpoint import load_checkpoint, load_resume, save_checkpoint
    from poet_tpu_torch.engine.train import make_optimizer

    cfg = _config()
    cfg.optim.sgd = True
    model = _model(seed=0)
    opt = make_optimizer(cfg, model, steps_per_epoch=10)
    path = save_checkpoint(str(tmp_path), "checkpoint.pth", model, opt, 3, 40, cfg)
    payload, start = load_resume(path)
    want, want_start = load_checkpoint(path)
    assert start == want_start == 4
    assert set(payload) == set(want) == {"model", "optimizer", "epoch", "step", "config"}
    assert payload["config"] == cfg.to_json()
    _assert_same_state(payload["model"], files[0])
    assert payload["optimizer"].keys() == want["optimizer"].keys()


def test_directory_still_raises(tmp_path):
    """--resume reads poet_tpu's orbax directories (tests/test_torch_orbax_*):
    a directory without _METADATA, or of zarr v3 arrays, still raises,
    naming what it lacks; --backbone_weights reads a file, never a
    directory."""
    import json

    from poet_tpu_torch.engine.checkpoint import load_resume, load_state_dict_file

    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="holds no _METADATA: it is not an orbax checkpoint"):
        load_resume(str(tmp_path / "orbax"), model=_model())
    with pytest.raises(ValueError, match="is a directory: a state-dict file"):
        load_state_dict_file(str(tmp_path / "orbax"))
    (tmp_path / "orbax" / "_METADATA").write_text(json.dumps(
        {"tree_metadata": {}, "use_ocdbt": True, "use_zarr3": True}))
    with pytest.raises(ValueError, match="zarr v3"):
        load_resume(str(tmp_path / "orbax"), model=_model())


def test_module_prefix_and_key_order(files, tmp_path):
    """The first of "model", "state_dict", "model_state_dict" that holds a
    dict wins, as in JAX's reader; `module.` is dropped under any key."""
    from poet_tpu.utils.torch_import import load_state_dict_file as jax_read
    from poet_tpu_torch.engine.checkpoint import load_state_dict_file

    detector = files[2]
    other = {k: v + 1 for k, v in detector.items()}
    path = str(tmp_path / "both.pth")
    torch.save({"model": "not a dict", "state_dict": {f"module.{k}": v
                                                      for k, v in detector.items()},
                "model_state_dict": other}, path)
    got = load_state_dict_file(path)
    want = jax_read(path)
    assert list(got) == list(want) == list(detector)
    for k, v in detector.items():
        assert torch.equal(got[k], v) and np.array_equal(want[k], v.numpy()), k
