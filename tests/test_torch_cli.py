"""The port's CLI (`python -m poet_tpu_torch.cli`) against `poet_tpu.cli`, on
the CPU (`--device cpu`), at a small width (hidden 32, 1 encoder / 1
decoder layer, 2 heads) on `tests/helpers.make_synthetic_dataset`:

* the option strings and `args_to_config`'s fields equal to JAX's (the
  export's platforms apart: 'cuda' for 'tpu'); the ignored flags warn in one
  line, a missing card raises (`--export_model`: tests/test_torch_export.py); over one process the data-parallel flags train what a run
  without them trains, and `--mesh_data 2` raises;
* checkpoints: a bit-exact round trip, two epochs straight equal to one, a
  resume and one more, a port checkpoint read by JAX's converter giving
  JAX's forward, the zoo remap, a directory without _METADATA and a zarr v3
  one refused, the NaN gate and the SIGTERM checkpoint;
* CLI against CLI: one reference-zoo `.pth` resumed by both: --eval metric
  JSONs within 1e-5, the BOP CSV rows equal, one train epoch's log.txt
  losses within 1e-4 relative; the same epoch with the model's options
  (`--aleatoric` with the three learned embeddings and `--mu_bf16`) and on
  detections (`--bbox_mode backbone`, the Mask R-CNN of
  `flagship.detector_state_dict`, on a copy of the dataset whose train
  targets are its own detections; without the clip, ROADMAP C2; 64
  proposals an image, ROADMAP C7), each from
  a zoo file of a port model with those options; every ported model and
  optimizer flag accepted (`--calibrate` too, held against JAX's train step
  in tests/test_torch_variants.py);
* --inference's results.json against `PoseServer` in detector mode on the
  same decoded images;
* poet_tpu's orbax `checkpoint` directory (the one its CLI wrote after the
  train epoch above) resumed by both CLIs for one more epoch: the epoch's
  log line within 1e-4 relative, the final parameters and AdamW moments
  within 1e-4 of scale (a moment's: its kind's largest); --eval from it: the metric files within 1e-5; the
  port's --inference and --export_model take it.
"""

import argparse
import csv
import json
import os
import signal

import numpy as np
import pytest
import torch

from tests.helpers import make_synthetic_dataset
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

SMALL = ["--n_classes", "3", "--batch_size", "4", "--eval_batch_size", "4",
         "--enc_layers", "1", "--dec_layers", "1", "--hidden_dim", "32", "--nheads", "2",
         "--dim_feedforward", "64", "--num_queries", "4", "--num_workers", "2",
         "--dropout", "0.0"]


def _port(argv):
    from poet_tpu_torch import cli

    return cli.run(argv + ["--device", "cpu"])


def _jax(argv):
    from poet_tpu.cli import args_to_config, get_args_parser, main

    args = argparse.ArgumentParser(parents=[get_args_parser()]).parse_args(argv)
    cfg = args_to_config(args)
    if cfg.runtime.inference:
        cfg.model.bbox_mode = "backbone"
    return main(cfg)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("data")))


# ---------------------------------------------------------------- flags
def _options(parser):
    return {s for a in parser._actions for s in a.option_strings}


def test_option_strings_match_jax():
    from poet_tpu.cli import get_args_parser as jparser

    from poet_tpu_torch.cli import get_args_parser

    assert _options(get_args_parser()) == _options(jparser())
    assert len(get_args_parser()._actions) == len(jparser()._actions) == 97


@pytest.mark.parametrize("argv", [
    [],
    ["--lr", "1e-3", "--lr_backbone_names", "a", "b", "--batch_size", "3", "--epochs", "7",
     "--sgd", "--grad_accum_steps", "2", "--backbone", "yolov4", "--backbone_cfg", "x.cfg",
     "--backbone_weights", "w.pth", "--backbone_conf_thresh", "0.3", "--post_nms_top_n", "500",
     "--yolo_box_decode", "darknet", "--encoder_min_stride", "16", "--position_embedding",
     "learned", "--bbox_mode", "jitter", "--rotation_representation", "quat", "--class_mode",
     "agnostic", "--enc_layers", "2", "--nheads", "4", "--no_aux_loss", "--set_cost_giou", "3",
     "--dataset", "lmo", "--dataset_path", "/d", "--train_set", "train_pbr", "--eval_set",
     "keyframes", "--jitter_probability", "0.2", "--rgb_augmentation", "--grayscale",
     "--num_workers", "8", "--cache_mode", "--decoded_cache_mb", "64", "--eval_interval", "2",
     "--models", "/m/", "--inference_path", "/i", "--save_interval", "3", "--output_dir", "/o",
     "--seed", "7", "--resume", "r.pth", "--start_epoch", "2", "--eval_bop", "--dtype",
     "bfloat16", "--enc_deform_impl", "pallas", "--dec_deform_impl", "sep",
     "--export_image_size", "96", "128"],
])
def test_args_to_config_matches_jax(argv):
    """Every field the two configs share gets the same value."""
    from poet_tpu.cli import args_to_config as jconv, get_args_parser as jparser

    from poet_tpu_torch.cli import args_to_config, get_args_parser

    jcfg = jconv(argparse.ArgumentParser(parents=[jparser()]).parse_args(argv))
    pcfg = args_to_config(argparse.ArgumentParser(parents=[get_args_parser()]).parse_args(argv))
    jd, pd = json.loads(jcfg.to_json()), json.loads(pcfg.to_json())
    shared = 0
    for section, fields in pd.items():
        for k, v in fields.items():
            if (section, k) == ("runtime", "export_platforms"):
                # the port's artifact serves the CPU and the card, JAX's the CPU and the TPU
                assert v == ["cpu", "cuda"] and jd[section][k] == ["cpu", "tpu"]
            elif k in jd.get(section, {}):
                assert v == jd[section][k], f"{section}.{k}"
                shared += 1
    assert shared >= 90
    assert pcfg.runtime.device == "cuda"


@pytest.fixture(scope="module")
def one_epoch(data, tmp_path_factory):
    """The parameters after one train epoch without the data-parallel flags."""
    out = str(tmp_path_factory.mktemp("one_epoch"))
    res = _port(["--dataset_path", data, "--output_dir", out, "--epochs", "1"] + SMALL)
    return {k: v.detach().clone() for k, v in res["model"].state_dict().items()}


def test_data_parallel_flags_in_one_process(data, one_epoch, tmp_path):
    """Over one process `--mesh_data 1` and `--zero_opt_state` (a no-op
    there, as JAX's `mesh.shape["data"] > 1` guard) train the epoch a run
    without them trains, bit for bit. Over several processes:
    tests/test_torch_ddp.py."""
    res = _port(["--dataset_path", data, "--output_dir", str(tmp_path), "--epochs", "1"]
                + SMALL + ["--mesh_data", "1", "--zero_opt_state"])
    assert type(res["optimizer"]).__name__ == "Optimizer"
    for k, v in res["model"].state_dict().items():
        assert torch.equal(v, one_epoch[k]), k


def test_mesh_data_needs_its_processes(data):
    """`--mesh_data 2` in one process raises and says how to start two."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        _port(["--dataset_path", data] + SMALL + ["--mesh_data", "2"])


@pytest.mark.parametrize("flags", [
    ["--aleatoric"], ["--aleatoric", "--calibrate"], ["--mu_bf16"],
    ["--query_embedding", "learned"], ["--reference_points", "learned"],
    ["--position_embedding", "learned"], ["--bbox_mode", "backbone"]])
def test_model_and_optimizer_flags_are_ported(flags):
    """The flags A.4 and A.5 ported: the model and optimizer they ask for."""
    from poet_tpu_torch.cli import parse_config
    from poet_tpu_torch.engine.train import make_optimizer
    from poet_tpu_torch.models import build_model

    cfg = parse_config(SMALL + flags + ["--device", "cpu"])
    model = build_model(cfg)
    opt = make_optimizer(cfg, model, steps_per_epoch=2)
    names = {n for n, _ in model.named_parameters()}
    if "--aleatoric" in flags:
        assert "translation_head_aleatoric.0.layers.2.weight" in names
    if "--calibrate" in flags:
        assert {n for n, p in model.named_parameters() if any(p is q for q in opt.params)} \
            == {n for n in names if "_head_aleatoric." in n}
    if "--mu_bf16" in flags:
        assert type(opt.torch_opt).__name__ == "AdamWMuBf16"
    for flag, name in (("--query_embedding", "query_embed.weight"),
                       ("--reference_points", "transformer.reference_points.weight"),
                       ("--position_embedding", "position_embedding.row_embed.weight")):
        assert (name in names) == (flag in flags), name
    if "--bbox_mode" in flags:
        assert type(model.backbone).__name__ == "MaskRCNNDetectorBackbone"


def test_ignored_flags_warn_in_one_line(capsys):
    from poet_tpu_torch.cli import parse_config

    parse_config(["--rng_impl", "rbg", "--xla_cache_dir", "/x", "--enc_remat", "on",
                  "--world_size", "4", "--distributed", "--export_platforms", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "ignored" in ln]
    assert len(lines) == 1
    for flag in ("--rng_impl", "--xla_cache_dir", "--enc_remat", "--world_size",
                 "--distributed"):
        assert flag in lines[0]
    assert "--export_platforms" not in lines[0]       # the export's platforms are read


def test_cuda_without_a_card_raises(data, monkeypatch):
    from poet_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.run(["--dataset_path", data] + SMALL)


def test_misc_helpers():
    from poet_tpu_torch.utils.misc import get_rank, get_sha, is_main_process, save_on_master

    assert get_sha().startswith("sha: ") and ", branch: " in get_sha()
    assert get_rank() == 0 and is_main_process()
    assert save_on_master(lambda x: x + 1, 1) == 2


def test_inference_forces_the_detector():
    from poet_tpu_torch.cli import parse_config

    assert parse_config(["--inference"]).model.bbox_mode == "backbone"


# ---------------------------------------------------------------- checkpoints
def _small_model(flags=()):
    from poet_tpu_torch.cli import parse_config
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    cfg = parse_config(SMALL + list(flags) + ["--device", "cpu"])
    return cfg, init_weights(build_model(cfg), seed=3)


def _assert_same_state(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_same_state(a[k], b[k])
        elif isinstance(a[k], (list, tuple)):
            assert len(a[k]) == len(b[k]), k
            for x, y in zip(a[k], b[k]):
                _assert_same_state({"_": x}, {"_": y})
        elif torch.is_tensor(a[k]):
            assert torch.equal(a[k].cpu(), b[k].cpu()), k
        else:
            assert a[k] == b[k], k


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    from poet_tpu_torch.engine.checkpoint import load_checkpoint, save_checkpoint
    from poet_tpu_torch.engine.train import Optimizer

    cfg, model = _small_model()
    cfg.optim.grad_accum_steps = 2
    opt = Optimizer(cfg, model, steps_per_epoch=4)
    for _ in range(3):                              # one update and a pending micro-step
        for p in opt.params:
            p.grad = torch.randn_like(p)
        opt.step()
    path = save_checkpoint(str(tmp_path), "checkpoint.pth", model, opt, 4, 3, cfg)
    payload, start = load_checkpoint(path)
    assert start == 5 and payload["step"] == 3
    assert type(cfg).from_json(payload["config"]) == cfg
    cfg2, fresh = _small_model()
    cfg2.optim.grad_accum_steps = 2
    fresh.load_state_dict(payload["model"])
    opt2 = Optimizer(cfg2, fresh, steps_per_epoch=4)
    opt2.load_state_dict(payload["optimizer"])
    _assert_same_state(fresh.state_dict(), model.state_dict())
    _assert_same_state(opt2.state_dict(), opt.state_dict())
    assert (opt2.updates, opt2.micro_step) == (1, 1)


def test_merge_params_reports(tmp_path):
    from poet_tpu_torch.engine.checkpoint import merge_params

    _, model = _small_model()
    sd = {k: v.clone() + 1 for k, v in model.state_dict().items()}
    sd.pop("transformer.level_embed")
    sd["input_proj.0.0.weight"] = torch.zeros(3, 3)
    sd["not.in.model"] = torch.zeros(1)
    missing, unexpected = merge_params(model, sd)
    assert "transformer.level_embed" in missing and unexpected == ["not.in.model"]
    assert any(m.startswith("input_proj.0.0.weight (shape") for m in missing)
    assert torch.equal(model.state_dict()["rotation_head.0.layers.0.bias"],
                       sd["rotation_head.0.layers.0.bias"])


def test_zoo_remap_and_orbax_refusal(tmp_path, monkeypatch):
    """The zoo remap through a file:// URL; a directory that is not an
    orbax checkpoint (no _METADATA), or one of zarr v3 arrays, raises naming
    what it lacks (poet_tpu's own directories resume: the orbax tests
    below)."""
    from poet_tpu_torch.engine.checkpoint import load_resume

    monkeypatch.setenv("HOME", str(tmp_path))          # fetch_checkpoint's cache

    sd = {"backbone.0.backbone.body.conv1.weight": torch.ones(2),
          "module.transformer.level_embed": torch.ones(3)}
    torch.save({"model": sd, "args": argparse.Namespace(lr=1e-4)}, tmp_path / "zoo.pth")
    payload, start = load_resume(f"file://{tmp_path / 'zoo.pth'}")
    assert start == 0 and set(payload["model"]) == {"backbone.backbone.body.conv1.weight",
                                                     "transformer.level_embed"}
    assert len(os.listdir(tmp_path / ".cache" / "poet_tpu_torch" / "checkpoints")) == 1
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="holds no _METADATA: it is not an orbax checkpoint"):
        load_resume(str(tmp_path / "orbax"))
    (tmp_path / "orbax" / "_METADATA").write_text(json.dumps(
        {"tree_metadata": {}, "use_ocdbt": True, "use_zarr3": True}))
    with pytest.raises(ValueError, match="zarr v3"):
        load_resume(str(tmp_path / "orbax"))


def _final_state(out):
    payload = torch.load(os.path.join(out, "checkpoint.pth"), weights_only=True)
    return payload["model"], payload["optimizer"]


def test_resume_equals_straight_training(data, tmp_path):
    """Two epochs straight == one epoch, a resume and one more, bit for bit
    (dropout 0, the same loader order, the optimizer's state restored)."""
    base = ["--dataset_path", data, "--eval_interval", "5", "--save_interval", "50"] + SMALL
    straight, resumed = str(tmp_path / "a"), str(tmp_path / "b")
    _port(base + ["--output_dir", straight, "--epochs", "2"])
    _port(base + ["--output_dir", resumed, "--epochs", "1"])
    _port(base + ["--output_dir", resumed, "--epochs", "2",
                  "--resume", os.path.join(resumed, "checkpoint.pth")])
    _assert_same_state(_final_state(resumed)[0], _final_state(straight)[0])
    _assert_same_state(_final_state(resumed)[1], _final_state(straight)[1])
    logs = [[json.loads(ln) for ln in open(os.path.join(d, "log.txt"))]
            for d in (straight, resumed)]
    assert logs[0] == logs[1] and [ln["epoch"] for ln in logs[0]] == [0, 1]


def test_port_checkpoint_through_jax_converter(tmp_path):
    """A port checkpoint read by `poet_tpu.utils.torch_import` gives JAX's
    forward within 1e-5."""
    import jax
    import jax.numpy as jnp

    from poet_tpu.config import PoETConfig as JConfig
    from poet_tpu.models import build_model as jbuild
    from poet_tpu.utils.torch_import import (
        convert_poet_checkpoint, convert_resnet_fpn, load_state_dict_file,
    )
    from poet_tpu_torch.engine.checkpoint import save_checkpoint
    from poet_tpu_torch.flagship import flagship_batch

    cfg, model = _small_model()
    path = save_checkpoint(str(tmp_path), "checkpoint.pth", model.eval(), None, 0, 0, cfg)
    sd = load_state_dict_file(path)
    tree = convert_poet_checkpoint(sd, enc_layers=1, dec_layers=1, nheads=2)
    tree["backbone"] = {"fpn_body": convert_resnet_fpn(sd, prefix="backbone.backbone.")}
    jcfg = JConfig()
    for k in ("enc_layers", "dec_layers", "hidden_dim", "nheads", "dim_feedforward",
              "num_queries", "n_classes"):
        setattr(jcfg.model, k, getattr(cfg.model, k))
    jcfg.model.enc_deform_impl = "sep"
    images, pad_mask, targets = flagship_batch(2, 64, 64, seed=1)
    targets = {k: targets[k][:, :4] if k != "n_boxes" else np.minimum(targets[k], 4)
               for k in ("boxes", "labels", "n_boxes")}
    targets["labels"] = np.where(targets["labels"] > 0, (targets["labels"] - 1) % 3 + 1, -1)
    jmodel = jbuild(jcfg)
    forward = jax.jit(lambda p, i, m, t: jmodel.apply(p, i, m, t, deterministic=True))
    want = forward({"params": tree}, jnp.asarray(images), jnp.asarray(pad_mask),
                   {k: jnp.asarray(v) for k, v in targets.items()})
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(pad_mask),
                    {k: torch.from_numpy(v) for k, v in targets.items()})
    for k in ("translations", "rotations"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)


def _nan_checkpoint(src, dst):
    payload = torch.load(src, weights_only=True)
    payload["model"]["transformer.encoder.layers.0.self_attn.sampling_offsets.bias"][0] = \
        float("nan")
    torch.save(payload, dst)


def test_nan_gate_and_sigterm_checkpoint(data, tmp_path, capsys, monkeypatch):
    """A NaN sampling offset makes the loss NaN (C1): training stops with
    exit 1 before the rolling checkpoint is overwritten. SIGTERM mid-epoch
    writes the rolling checkpoint at the last finished epoch and returns."""
    from poet_tpu_torch.engine import train as train_mod

    out = str(tmp_path / "out")
    base = ["--dataset_path", data, "--output_dir", out, "--eval_interval", "5"] + SMALL
    _port(base + ["--epochs", "1"])
    ckpt = os.path.join(out, "checkpoint.pth")
    before = open(ckpt, "rb").read()
    _nan_checkpoint(ckpt, tmp_path / "nan.pth")
    with pytest.raises(SystemExit) as exc:
        _port(base + ["--epochs", "3", "--resume", str(tmp_path / "nan.pth")])
    assert exc.value.code == 1
    printed = capsys.readouterr().out
    assert "Loss is nan, stopping training" in printed and "git:\n  sha: " in printed
    assert open(ckpt, "rb").read() == before

    real = train_mod.make_train_step

    def sigterm_after_first_step(*args, **kwargs):
        step = real(*args, **kwargs)

        def wrapped(*a, **k):
            metrics = step(*a, **k)
            os.kill(os.getpid(), signal.SIGTERM)
            return metrics
        return wrapped

    monkeypatch.setattr(train_mod, "make_train_step", sigterm_after_first_step)
    _port(base + ["--epochs", "3", "--resume", ckpt])
    payload = torch.load(ckpt, weights_only=True)
    assert payload["epoch"] == 0 and payload["step"] == 2 + 1     # epoch 1 preempted
    assert "preempted at epoch 1" in capsys.readouterr().out
    assert signal.getsignal(signal.SIGTERM) is not None


# ---------------------------------------------------------------- CLI against CLI
def _zoo(model, path):
    """A reference-zoo .pth of a port model: its detector under the Joiner's
    backbone.0., a learned position embedding under backbone.1."""
    sd = {}
    for k, v in model.state_dict().items():
        for port, zoo in (("backbone.", "backbone.0."), ("position_embedding.", "backbone.1.")):
            if k.startswith(port):
                k = zoo + k[len(port):]
                break
        sd[k] = v
    torch.save({"model": sd}, path)
    return path


TRAIN_EPOCH = ["--epochs", "1", "--eval_interval", "5", "--save_interval", "50"]
# the epochs of the model's options and of training on detections (without
# the clip: JAX's backbone-mode step puts the Mask R-CNN heads' gradients
# into the clip's norm, ROADMAP C2; 64 proposals an image: JAX's step
# differentiates through its RoIAlign, whose backward over torchvision's
# 1000 proposals took the file's peak to 41 GB of memory, ROADMAP C7)
VARIANT_EPOCHS = {
    "options": ["--aleatoric", "--query_embedding", "learned", "--reference_points", "learned",
                "--position_embedding", "learned", "--mu_bf16"],
    "detections": ["--bbox_mode", "backbone", "--clip_max_norm", "0", "--post_nms_top_n", "64"],
}


def _detection_targets(data, root, model):
    """A copy of the dataset whose train annotations are the detector's own
    detections of each image (class, box), with the original poses: the
    queries then match their targets."""
    import shutil

    from poet_tpu_torch.native import load_image_rgb_f32

    dst = str(root / "data_detections")
    shutil.copytree(data, dst)
    path = os.path.join(dst, "annotations", "train.json")
    ann = json.load(open(path))
    poses = [a["relative_pose"] for a in ann["annotations"]]
    out = []
    for img in ann["images"]:
        image = load_image_rgb_f32(os.path.join(dst, "train", img["file_name"]))[None]
        with torch.no_grad():
            dets = model.backbone(torch.from_numpy(image),
                                  torch.zeros(image.shape[:3], dtype=torch.bool))[2]
        for k in torch.nonzero(dets["valid"][0]).flatten().tolist():
            x1, y1, x2, y2 = dets["boxes"][0, k].tolist()
            out.append({"id": len(out), "image_id": img["id"],
                        "bbox": [x1, y1, x2 - x1, y2 - y1], "area": (x2 - x1) * (y2 - y1),
                        "iscrowd": 0, "category_id": int(dets["labels"][0, k]),
                        "relative_pose": poses[len(out) % len(poses)],
                        "intrinsics": ann["annotations"][0]["intrinsics"]})
    ann["annotations"] = out
    json.dump(ann, open(path, "w"))
    return dst, len(out)


def _both_clis(root, runs_of):
    """Run each (name, argv) of `runs_of` through JAX's CLI and the port's;
    the JAX runs share compiled programs through their CLI's cache flag."""
    import jax

    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_entry_size_bytes",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    runs = {}
    try:
        for name, run, extra_flags in (
                ("jax", _jax, ["--xla_cache_dir", str(root / "xla")]), ("port", _port, [])):
            for mode, argv in runs_of:
                out = str(root / name / mode)
                run(argv + ["--output_dir", out] + extra_flags)
                runs[name, mode] = out
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return runs


@pytest.fixture(scope="module")
def both(data, tmp_path_factory):
    """A reference-zoo .pth (the detector under backbone.0.) of a seeded port
    model, resumed by both CLIs for --eval, --eval_bop and one epoch."""
    root = tmp_path_factory.mktemp("cli")
    zoo = _zoo(_small_model()[1], str(root / "zoo.pth"))
    base = ["--dataset_path", data, "--resume", zoo] + SMALL
    return _both_clis(root, [("eval", base + ["--eval"]), ("bop", base + ["--eval_bop"]),
                             ("train", base + TRAIN_EPOCH)])


@pytest.fixture(scope="module")
def variant_epochs(data, tmp_path_factory):
    """One train epoch of each of VARIANT_EPOCHS through both CLIs, each
    resumed from a zoo file of a seeded port model with its flags. On
    detections: `flagship.detector_state_dict`'s well-conditioned Mask
    R-CNN, and the dataset's train targets its own detections."""
    from poet_tpu_torch.flagship import detector_state_dict

    root = tmp_path_factory.mktemp("cli_variants")
    runs_of, n_targets = [], None
    for name, flags in VARIANT_EPOCHS.items():
        _, model = _small_model(flags)
        dataset = data
        if name == "detections":
            model.backbone.load_state_dict({k: torch.from_numpy(v)
                                            for k, v in detector_state_dict(4).items()})
            dataset, n_targets = _detection_targets(data, root, model.eval())
        zoo = _zoo(model, str(root / f"{name}.pth"))
        runs_of.append((name, ["--dataset_path", dataset, "--resume", zoo] + SMALL + flags
                        + TRAIN_EPOCH))
    runs = _both_clis(root, runs_of)
    runs["n_detection_targets"] = n_targets
    return runs


def _leaves(obj, path=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, obj


@pytest.mark.parametrize("metric", ["add/add", "adi/adds", "adds/adds",
                                    "avg_t_error/avg_t_error", "avg_rot_error/avg_rot_error"])
def test_eval_metric_files_match_jax(both, metric):
    files = [os.path.join(both[k, "eval"], "eval_test_gt", metric + ".json")
             for k in ("jax", "port")]
    want, got = (dict(_leaves(json.load(open(f)))) for f in files)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float) and np.isnan(v):                  # a class with no pose
            assert np.isnan(got[k]), k
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            assert got[k] == pytest.approx(v, rel=1e-5, abs=1e-5), k
        else:
            assert got[k] == v, k


def test_bop_csv_matches_jax(both):
    rows = [list(csv.reader(open(os.path.join(both[k, "bop"], "bop_gt", "ycbv.csv"))))
            for k in ("jax", "port")]
    want, got = rows
    assert got[0] == want[0] and len(got) == len(want) > 1
    for g, w in zip(got[1:], want[1:]):
        assert g[:4] == w[:4]                                     # scene, image, object, score
        for col in (4, 5):                                        # R, t (mm)
            np.testing.assert_allclose(np.float64(g[col].split()), np.float64(w[col].split()),
                                       rtol=1e-5, atol=1e-5)


def _assert_epoch_logs_match(runs, mode):
    want, got = ([json.loads(ln) for ln in open(os.path.join(runs[k, mode], "log.txt"))]
                 for k in ("jax", "port"))
    assert len(got) == len(want) == 1 and got[0]["epoch"] == want[0]["epoch"] == 0
    losses = [k for k in want[0] if k.startswith("train_loss")]
    assert losses and set(losses) == {k for k in got[0] if k.startswith("train_loss")}
    for k in losses + ["train_lr"]:
        assert got[0][k] == pytest.approx(want[0][k], rel=1e-4), k
    return got[0]


def test_train_epoch_log_matches_jax(both):
    _assert_epoch_logs_match(both, "train")


@pytest.mark.parametrize("mode", list(VARIANT_EPOCHS))
def test_variant_epoch_log_matches_jax(variant_epochs, mode):
    """The epoch's losses within 1e-4 relative, as the default epoch's;
    each run's own checkpoint holds what its flags ask for."""
    got = _assert_epoch_logs_match(variant_epochs, mode)
    payload = torch.load(os.path.join(variant_epochs["port", mode], "checkpoint.pth"),
                         weights_only=True)
    states = payload["optimizer"]["torch"]["state"].values()
    if mode == "options":
        assert all(st["exp_avg"].dtype == torch.bfloat16 for st in states)
        assert "query_embed.weight" in payload["model"]
    if mode == "detections":
        assert variant_epochs["n_detection_targets"] >= 8
        assert got["train_loss"] > 0                  # detections matched the targets


# ---------------------------------------------------------------- inference
def test_inference_matches_pose_server(data, tmp_path):
    from poet_tpu_torch.cli import load_backbone_weights, parse_config
    from poet_tpu_torch.engine.serving import PoseServer
    from poet_tpu_torch.flagship import detector_state_dict
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.native import load_image_rgb_f32
    from poet_tpu_torch.utils.init import init_weights

    det = str(tmp_path / "detector.pth")
    torch.save({k: torch.from_numpy(v) for k, v in detector_state_dict(4).items()}, det)
    img_dir = tmp_path / "images"                  # two of the test PNGs, in numeric order
    img_dir.mkdir()
    for name in ("000002.png", "000000.png"):
        src = os.path.join(data, "test_all", "000001", "rgb", name)
        (img_dir / name).write_bytes(open(src, "rb").read())
    img_dir = str(img_dir)
    argv = ["--dataset_path", data, "--inference", "--inference_path", img_dir,
            "--inference_output", str(tmp_path / "inf"), "--backbone_weights", det] + SMALL
    results = _port(argv)
    with open(tmp_path / "inf" / "results.json") as f:
        rows = json.load(f)
    files = sorted(os.listdir(img_dir))
    assert len(rows) == len(files) == len(results)

    cfg = parse_config(argv + ["--device", "cpu"])
    model = init_weights(build_model(cfg), seed=cfg.runtime.seed)
    load_backbone_weights(model, cfg)
    server = None
    for i, name in enumerate(files):
        img = load_image_rgb_f32(os.path.join(img_dir, name))[None]
        if server is None:
            server = PoseServer(cfg, model, batch_size=1, image_size=img.shape[1:3],
                                device="cpu")
        out = server.infer(img)
        n = int(out["n_boxes"][0])
        row = rows[str(i)]
        assert len(row) == n
        for d in range(n):
            np.testing.assert_allclose(row[str(d)]["t"], out["translation"][0, d], atol=1e-6)
            np.testing.assert_allclose(row[str(d)]["rot"], out["rotation"][0, d], atol=1e-6)
            np.testing.assert_allclose(row[str(d)]["box"], out["boxes"][0, d], atol=1e-6)
            assert row[str(d)]["class"] == int(out["classes"][0, d])


# ---------------------------------------------------------------- orbax resume
ORBAX_EPOCH = ["--epochs", "2", "--eval_interval", "5", "--save_interval", "50"]
ORBAX_STATE_TOL = 1e-4


@pytest.fixture(scope="module")
def orbax_runs(both, data, tmp_path_factory):
    """poet_tpu's orbax checkpoint after `both`'s train epoch, resumed by
    both CLIs: one more epoch, and --eval."""
    root = tmp_path_factory.mktemp("orbax")
    ckpt = os.path.join(both["jax", "train"], "checkpoint")
    base = ["--dataset_path", data, "--resume", ckpt] + SMALL
    runs = _both_clis(root, [("train", base + ORBAX_EPOCH), ("eval", base + ["--eval"])])
    runs["checkpoint"] = ckpt
    return runs


def test_orbax_resumed_epoch_matches_jax(orbax_runs):
    """The resumed epoch's log line within 1e-4 relative; the final
    parameters and AdamW moments of the port (its checkpoint.pth) against
    poet_tpu's final orbax checkpoint through the layout rules, within
    ORBAX_STATE_TOL: of each parameter's scale (at least 1), of the largest
    moment of each kind."""
    from poet_tpu.engine.checkpoint import load_checkpoint as jax_load

    from poet_tpu_torch.engine.train import make_optimizer
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.jax_params import jax_state_dict

    want, got = ([json.loads(ln) for ln in open(os.path.join(orbax_runs[k, "train"],
                                                             "log.txt"))]
                 for k in ("jax", "port"))
    assert [ln["epoch"] for ln in got] == [ln["epoch"] for ln in want] == [1]
    losses = [k for k in want[0] if k.startswith("train_loss")]
    assert losses and set(losses) == {k for k in got[0] if k.startswith("train_loss")}
    for k in losses + ["train_lr"]:
        assert got[0][k] == pytest.approx(want[0][k], rel=1e-4), k

    final, start = jax_load(os.path.join(orbax_runs["jax", "train"], "checkpoint"))
    assert start == 2
    port = torch.load(os.path.join(orbax_runs["port", "train"], "checkpoint.pth"),
                      weights_only=True)
    assert port["step"] == int(final["step"]) and port["epoch"] == 1
    cfg, model = _small_model()
    jparams = jax_state_dict(model, final["params"])
    for name, v in port["model"].items():
        ref = torch.from_numpy(jparams[name])
        scale = max(float(ref.abs().max()), 1.0)
        assert float((v - ref).abs().max()) <= ORBAX_STATE_TOL * scale, name
    # the AdamW moments: the port's torch state by parameter index
    names = make_optimizer(cfg, model, steps_per_epoch=1).param_names
    inner = final["opt_state"][1]["inner_states"]
    assert port["optimizer"]["updates"] == int(inner["main"]["inner_state"][2]["count"])
    moments = {}
    for label in ("main", "linear_proj"):
        adam = inner[label]["inner_state"][0]
        for key, tree in (("exp_avg", adam["mu"]), ("exp_avg_sq", adam["nu"])):
            for n, arr in jax_state_dict(model, tree).items():
                if arr is not None:
                    moments[n, key] = arr
    # a moment's scale is its kind's largest: the gradient of a conv bias
    # before a GroupNorm is f32 rounding residue (~1e-14), of either sign
    scale = {key: max(float(np.abs(v).max()) for (_, k), v in moments.items() if k == key)
             for key in ("exp_avg", "exp_avg_sq")}
    for i, st in port["optimizer"]["torch"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            ref = torch.from_numpy(moments[names[i], key])
            assert float((st[key] - ref).abs().max()) <= ORBAX_STATE_TOL * scale[key], \
                (names[i], key)


def test_orbax_eval_matches_jax(orbax_runs):
    """--eval from poet_tpu's checkpoint directory: every metric file within
    1e-5, as from a zoo file."""
    for metric in ("add/add", "adi/adds", "adds/adds", "avg_t_error/avg_t_error",
                   "avg_rot_error/avg_rot_error"):
        files = [os.path.join(orbax_runs[k, "eval"], "eval_test_gt", metric + ".json")
                 for k in ("jax", "port")]
        want, got = (dict(_leaves(json.load(open(f)))) for f in files)
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, float) and np.isnan(v):
                assert np.isnan(got[k]), (metric, k)
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                assert got[k] == pytest.approx(v, rel=1e-5, abs=1e-5), (metric, k)


def test_orbax_inference_and_export_take_the_directory(orbax_runs, data, tmp_path):
    """--inference and --export_model from poet_tpu's checkpoint directory:
    one results.json row per image; the artifact's answers equal a live
    server's on the checkpoint's weights."""
    from poet_tpu_torch.engine.checkpoint import load_resume, merge_params
    from poet_tpu_torch.engine.serving import ExportedPoseServer, PoseServer

    ckpt = orbax_runs["checkpoint"]
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    src = os.path.join(data, "test_all", "000001", "rgb", "000000.png")
    (img_dir / "000000.png").write_bytes(open(src, "rb").read())
    rows = _port(["--dataset_path", data, "--inference", "--inference_path", str(img_dir),
                  "--inference_output", str(tmp_path / "inf"), "--resume", ckpt] + SMALL)
    assert len(rows) == 1 and (tmp_path / "inf" / "results.json").exists()
    path = _port(["--dataset_path", data, "--resume", ckpt, "--export_model",
                  str(tmp_path / "engine"), "--export_platforms", "cpu",
                  "--export_batch_size", "1", "--export_image_size", "64", "64"] + SMALL)
    assert os.path.exists(os.path.join(path, "module.pt2"))
    # the artifact serves what the checkpoint's weights serve live
    cfg, model = _small_model()
    payload, _ = load_resume(ckpt, model=model, cfg=cfg)
    assert merge_params(model, payload["model"]) == ([], [])
    images = np.random.default_rng(0).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    boxes = np.tile(np.asarray([[0.5, 0.5, 0.3, 0.3]], np.float32), (1, 4, 1))
    res = ExportedPoseServer(path, device="cpu").infer(images, boxes=boxes)
    live = PoseServer(cfg, model, batch_size=1, image_size=(64, 64), device="cpu")
    for k, v in live.infer(images, boxes=boxes).items():
        np.testing.assert_array_equal(res[k], v, err_msg=k)
