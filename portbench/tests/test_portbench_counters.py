"""The yardstick's counters, by hand: the deformable core's bytes at the
encoder and at the YOLO pyramid, a conv's and a linear's FLOPs, and a
roofline share that reads the same whatever route's kernels ran."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.lib import flops, readers  # noqa: E402
from portbench.lib.manifest import Config  # noqa: E402
from portbench.lib.trace import DeviceOp, Trace  # noqa: E402


def test_encoder_forward_bytes():
    # B=16 Q=S=1600 H=16 D=16 L=P=4 bf16: value 13.1 + locations 52.4 +
    # weights 26.2 + output 13.1 MB = 104.9 MB (PERF.md, kernel row 1b)
    nbytes, fl = flops.deform_call(16, 1600, 1600, 16, 16, 4, 4, 2)
    samples = 16 * 1600 * 16 * 4 * 4
    assert nbytes == 16 * 1600 * 256 * 2 + samples * 8 + samples * 4 + 16 * 1600 * 256 * 2
    assert nbytes == 104_857_600
    assert fl == 10 * samples * 16


def test_yolo_pyramid_adjoint_bytes():
    # B=16 Q=S=6380: reads value, locations, weights and the incoming
    # gradient, writes d_value, d_loc, d_attn: 784 MB (kernel row 4c)
    nbytes, _ = flops.deform_call(16, 6380, 6380, 16, 16, 4, 4, 2, adjoint=True)
    value = 16 * 6380 * 256 * 2
    samples = 16 * 6380 * 16 * 16
    assert nbytes == 2 * value + 2 * samples * 8 + 2 * samples * 4 + value
    assert round(nbytes / 1e6) == 784


def test_decoder_reads_only_what_its_corners_reach():
    nbytes, _ = flops.deform_call(16, 6380, 10, 16, 16, 4, 4, 2)
    samples = 16 * 10 * 16 * 16
    assert nbytes == samples * 4 * 16 * 2 + samples * 12 + 16 * 10 * 256 * 2


def test_conv_and_linear_flops_by_hand():
    # the YOLO entry conv: 3 -> 32 channels, 3x3, 480x640, per image
    assert flops.conv_flops(3, 32, 3, 480, 640) == 2 * 3 * 9 * 32 * 480 * 640 == 530_841_600
    # an encoder FFN's first linear at the YOLO pyramid
    assert flops.linear_flops(6380, 256, 1024) == 2 * 6380 * 256 * 1024


def test_model_flops_at_the_cells():
    yolo = Config("poet-yolov4csp-ycbv")
    body, feats = flops.darknet_flops(yolo.sections, 480, 640)
    assert [f[1:] for f in feats] == [(60, 80), (30, 40), (15, 20)]
    p = flops.poet_flops(yolo.model, feats)
    assert p["tokens"] == 6380
    assert flops.model_flops(yolo, 480, 640) == body + sum(
        p[k] for k in ("input_proj", "encoder", "decoder", "heads"))
    rcnn = Config("poet-rcnn-ycbv")
    _, feats = flops.resnet_fpn_flops(480, 640, rcnn.data["fpn_levels"])
    assert flops.poet_flops(rcnn.model, feats)["tokens"] == 1600


@pytest.mark.parametrize("names", [("ms_deform_attn_fwd_kernel",) * 2,
                                   ("ms_deform_attn_fwd_slab_kernel",) * 2,
                                   ("ms_deform_attn_v2_kernel", "ms_deform_attn_fwd_kernel"),
                                   ("ms_deform_attn_dense_fwd_kernel",) * 2])
def test_roofline_reads_the_same_whatever_route(names):
    """The bound comes from the calls' shapes, the time from every
    `ms_deform_attn_*` kernel: which route ran does not enter the count."""
    calls = [(16, 6380, 6380, 16, 16, 4, 4, 2, False), (16, 6380, 10, 16, 16, 4, 4, 2, False)]
    ops = [DeviceOp(n, 0.01 * i, 0.004, "kernel") for i, n in enumerate(names)]
    ops.append(DeviceOp("elementwise_kernel", 0.1, 0.5, "kernel"))
    run = {"trace": Trace(ops, {}, [], (0.0, 1.0)), "deform_calls": calls}
    bound = sum(flops.deform_bound_s(c) for c in calls)
    assert readers.deform_roofline_pct(run) == pytest.approx(100 * bound / 0.008)
