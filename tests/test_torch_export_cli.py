"""`python -m poet_tpu_torch.cli --export_model DIR` on the CPU, beside
`poet_tpu.cli`'s (`tests/test_cli_integration.py:test_cli_export_model`,
the same flags): the port's CLI writes the artifact of the model it
initializes and returns DIR; `ExportedPoseServer(DIR, device="cpu")` answers
what a live `PoseServer` of that model answers, bit for bit; the two
artifacts' metadata agree on every field JAX writes but the platforms'
names, and their answers have the same keys and shapes. `--export_platforms
tpu` raises: the port has no TPU.

Also tracker mode with the aleatoric heads against JAX's artifact
(`tests/test_torch_export.py`'s comparison, the variances included).
"""

import json
import os

import numpy as np
import pytest

from tests.helpers import make_synthetic_dataset
from tests.test_cli_integration import BASE
from tests.test_torch_export import check_tracker_artifact, tracker_run
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

FLAGS = ["--export_batch_size", "2", "--export_image_size", "48", "64"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("data")))


def _port(argv):
    from poet_tpu_torch import cli

    return cli.run(argv + ["--device", "cpu"])


def _jax(argv):
    import argparse

    from poet_tpu.cli import args_to_config, get_args_parser, main

    return main(args_to_config(argparse.ArgumentParser(parents=[get_args_parser()])
                               .parse_args(argv)))


def test_cli_export_model(data, tmp_path):
    from poet_tpu.engine.serving import ExportedPoseServer as JServer
    from poet_tpu_torch.cli import parse_config
    from poet_tpu_torch.engine.serving import ExportedPoseServer, PoseServer
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    argv = ["--dataset_path", data, "--output_dir", str(tmp_path / "out"), "--export_model",
            str(tmp_path / "engine")] + FLAGS + ["--export_platforms", "cpu"] + BASE
    ret = _port(argv)
    assert ret == str(tmp_path / "engine")
    assert os.path.exists(os.path.join(ret, "module.pt2"))
    jret = _jax(argv[:5] + [str(tmp_path / "jax_engine")] + argv[6:])
    jmeta = json.load(open(os.path.join(jret, "meta.json")))

    server = ExportedPoseServer(ret, device="cpu")
    assert server.meta == {**jmeta, "dtype": "float32", "aleatoric": False}
    images = np.random.default_rng(0).uniform(size=(2, 48, 64, 3)).astype(np.float32)
    boxes = np.tile(np.asarray([[0.5, 0.5, 0.3, 0.3]], np.float32), (2, 4, 1))
    res = server.infer(images, boxes=boxes)
    assert np.isfinite(res["translation"]).all() and res["translation"].shape == (2, 4, 3)
    want = JServer(jret).infer(images, boxes=boxes)
    assert {k: v.shape for k, v in res.items()} == {k: v.shape for k, v in want.items()}

    # the model the CLI initialized (seed 42 on the one data slot), served live
    cfg = parse_config(argv + ["--device", "cpu"])
    model = init_weights(build_model(cfg), seed=cfg.runtime.seed)
    live = PoseServer(cfg, model, batch_size=2, image_size=(48, 64), device="cpu")
    for k, v in live.infer(images, boxes=boxes).items():
        np.testing.assert_array_equal(res[k], v, err_msg=k)


def test_cli_export_platforms_tpu_raises(data, tmp_path):
    with pytest.raises(ValueError, match="no TPU"):
        _port(["--dataset_path", data, "--export_model", str(tmp_path / "engine")] + FLAGS
              + ["--export_platforms", "cpu", "tpu"] + BASE)
    assert not (tmp_path / "engine").exists()


def test_aleatoric_tracker_artifact_matches_jax_artifact(tmp_path):
    check_tracker_artifact(tracker_run(True, tmp_path))
