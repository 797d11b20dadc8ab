"""Tests that need the card (marker `card`; each skips without a CUDA
device). Run them there with

    python3 -m pytest --noconftest -m card tests/test_torch_card.py

(the card's machine has no JAX, which tests/conftest.py imports). This
file imports no JAX. chip_smoke.py phase 26 drives the same paths.

* the JPEG route the machine builds decodes the committed fixtures
  (tests/data/jpeg/) to their reference pixels: exactly on the libjpeg
  route, within `chip_smoke.JPEG_NVJPEG_MAX_DIFF` on the nvJPEG route (the
  card's machine has no libjpeg);
* the metric sync in a one-process NCCL group: the reduced tensor lives on
  the card (NCCL refuses CPU tensors), the values are kept.
"""

import os
import socket

import numpy as np
import pytest
import torch

from chip_smoke import JPEG_NVJPEG_MAX_DIFF

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")
NAMES = ["baseline_444_37x53", "baseline_420_37x53", "baseline_422_53x37",
         "baseline_420_120x160", "gray_37x53", "progressive_420_48x64", "restart_420_64x48"]

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): run on the card")


@pytest.mark.parametrize("name", NAMES)
def test_jpeg_route_decodes_the_fixtures(card, name):
    from poet_tpu_torch import native

    route = native.jpeg_route()
    assert route in ("libjpeg", "nvjpeg")
    with open(os.path.join(FIXTURES, name + ".png"), "rb") as f:
        want = native.decode_image(f.read()).astype(np.int16)
    with open(os.path.join(FIXTURES, name + ".jpg"), "rb") as f:
        blob = f.read()
    for channels in (3, 4):
        got = native.decode_image(blob, channels)
        assert got.shape == want.shape[:2] + (channels,)
        diff = np.abs(got[..., :3].astype(np.int16) - want).max()
        assert diff <= (0 if route == "libjpeg" else JPEG_NVJPEG_MAX_DIFF), (route, diff)
        if channels == 4:
            assert (got[..., 3] == 255).all()


def test_metric_sync_under_nccl(card, monkeypatch):
    import torch.distributed as dist

    from poet_tpu_torch.engine.metrics import SmoothedValue

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, device_id=torch.device("cuda", 0))
    try:
        seen = []
        reduce = dist.all_reduce
        monkeypatch.setattr(dist, "all_reduce", lambda t, *a, **k: (seen.append(t.device),
                                                                    reduce(t, *a, **k))[1])
        v = SmoothedValue()
        for x in (1.0, 2.5, 4.0):
            v.update(x, n=2)
        v.synchronize_between_processes()
        assert (v.count, v.total) == (6, 15.0)
        assert seen == [torch.device("cuda", 0)]
    finally:
        dist.destroy_process_group()
