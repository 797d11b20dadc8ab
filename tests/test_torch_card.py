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
  the card (NCCL refuses CPU tensors), the values are kept;
* the darknet epilogue kernel (`ops/darknet_epilogue_cuda.py`) against the
  plain composition on the same conv output, at every (H, W, C) that the
  shipped cfg's 109 BN convs after the stem produce at B=2 480x640, for
  mish, leaky and linear, on inputs spanning -30..30 (both sides of mish's
  clamp at 25): f32 within 2 ulp of the plain version; bf16 within 1 bf16
  ulp of the f32 composition of the same input (its scale and offset
  rounded to bf16, as FrozenBatchNorm rounds them); what the wrapper
  refuses; one launch a call, 109 a forward of the shipped body.
"""

import os
import socket

import numpy as np
import pytest
import torch

from chip_smoke import JPEG_NVJPEG_MAX_DIFF, YOLO_SHIPPED_CFG, epilogue_bn, epilogue_gap

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


@pytest.mark.parametrize("act", ["mish", "leaky", "linear"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_darknet_epilogue_against_the_plain_composition(card, dtype, act):
    from poet_tpu_torch.models.yolov4 import epilogue_convs, load_cfg_sections
    from poet_tpu_torch.ops.darknet_epilogue_cuda import DARKNET_EPILOGUE, darknet_epilogue

    convs = epilogue_convs([dict(s) for s in load_cfg_sections(YOLO_SHIPPED_CFG)])
    assert len(convs) == 109
    g = torch.Generator(device="cuda").manual_seed(11)
    for H, W, C in sorted({c[:3] for c in convs}):
        bn = epilogue_bn(g, C)
        x = (torch.rand((2, H, W, C), device="cuda", generator=g) * 60 - 30).to(dtype)
        n0 = DARKNET_EPILOGUE.launches
        got = darknet_epilogue(x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                               bn.eps, act)
        assert DARKNET_EPILOGUE.launches == n0 + 1
        assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous()
        ulps, _, pre = epilogue_gap(x, bn, act, got)
        assert (pre > 25).any() and (pre < -25).any()
        assert ulps <= (2 if dtype == torch.float32 else 1), (H, W, C, ulps)


def test_darknet_epilogue_refuses_what_the_kernel_does_not_take(card):
    from poet_tpu_torch.ops.darknet_epilogue_cuda import DARKNET_EPILOGUE

    g = torch.Generator(device="cuda").manual_seed(3)
    bn = epilogue_bn(g, 16)
    args = (bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps, "mish")
    x = torch.rand((2, 6, 10, 16), device="cuda", generator=g)
    n0 = DARKNET_EPILOGUE.launches
    with pytest.raises(ValueError, match="contiguous"):
        DARKNET_EPILOGUE(x.transpose(1, 2), *args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        DARKNET_EPILOGUE(x.cpu(), *[t.cpu() if torch.is_tensor(t) else t for t in args])
    bn12 = epilogue_bn(g, 12)
    with pytest.raises(ValueError, match="multiples of 8"):
        DARKNET_EPILOGUE(x[..., :12].contiguous(), bn12.weight, bn12.bias,
                         bn12.running_mean, bn12.running_var, bn12.eps, "mish")
    assert DARKNET_EPILOGUE.launches == n0
    DARKNET_EPILOGUE(x, *args)
    assert DARKNET_EPILOGUE.launches == n0 + 1


def test_shipped_body_takes_the_epilogue_109_times_a_forward(card):
    from poet_tpu_torch.models.yolov4 import DarknetBody, load_cfg_sections
    from poet_tpu_torch.ops.darknet_epilogue_cuda import DARKNET_EPILOGUE

    body = DarknetBody(load_cfg_sections(YOLO_SHIPPED_CFG), dtype=torch.bfloat16)
    body = body.cuda().to(memory_format=torch.channels_last).eval()
    images = torch.rand((1, 480, 640, 3), device="cuda")
    n0 = DARKNET_EPILOGUE.launches
    with torch.no_grad():
        heads, _, feats = body(images)
    torch.cuda.synchronize()
    assert DARKNET_EPILOGUE.launches == n0 + 109
    assert all(torch.isfinite(t.float()).all() for t in heads + feats)
