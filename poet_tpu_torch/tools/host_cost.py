"""Host cost of one launch through each on-path kernel entry, broken down.

    python3 poet_tpu_torch/tools/host_cost.py [--root DIR] [--calls 2000]

Every served path is host-bound (PERF.md §5): its thread spends more time
launching kernels than the card spends running them. This times, on the
host's clock (`tools/timing.py:host_us`, the device synchronised between
runs of calls outside the timed span), one call of each kernel entry a
model path reaches, at its path shape, bf16:

  * 1a, the forward's direct route: the decoder (B=16 Q=10 S=1600 H=16 D=16
    L=P=4), through `ms_deform_attn` and `torch.ops.poet_tpu_torch.ms_deform_attn`;
  * 1b, its slab route: the encoder (Q=1600), the same two ways;
  * 5b, RoIAlign's tiles route: B=16 x 1000 proposals, C=256, through
    `multiscale_roi_align` (the geometry's eager ops included) and
    `torch.ops.poet_tpu_torch.roi_align_blend`;
  * 7, the stem conv: YOLO L0 (B=16 480x640, C=3, F=32, 3x3), through
    `conv_stem` and `torch.ops.poet_tpu_torch.conv_stem`;
  * 8, the dense forward: the encoder, through `ms_deform_attn_dense` and
    `torch.ops.poet_tpu_torch.ms_deform_attn_dense`;

each also through its route's wrapper alone (the launch without the
operator's dispatch), and the launch helpers every wrapper shares, in the
earlier and current forms: the current stream's handle, the device
context, the level-size array, the output's allocation. `--root` times the package of another
checkout (a parent commit unpacked beside this one) with the same inputs.
The card's name and power limit come first, one JSON line per entry after.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)            # chip_smoke's shapes and inputs
    import chip_smoke as cs

    sys.path.insert(0, os.path.abspath(args.root))      # the package under test
    import torch

    from poet_tpu_torch import ops  # noqa: F401  (registers the operators)
    from poet_tpu_torch.ops import conv_stem_cuda as stem
    from poet_tpu_torch.ops import deform_attn_cuda as dac
    from poet_tpu_torch.ops import deform_attn_dense_cuda as dense
    from poet_tpu_torch.ops import roi_align_cuda as roi
    from poet_tpu_torch.ops.cuda_build import LIBRARIES, level_hw
    from poet_tpu_torch.ops.detection import roi_geometry
    timing = importlib.util.spec_from_file_location("host_cost_timing",
                                                    os.path.join(HERE, "timing.py"))
    host_us = importlib.util.module_from_spec(timing)
    timing.loader.exec_module(host_us)       # this checkout's timer, whatever --root
    host_us = host_us.host_us

    if not torch.cuda.is_available():
        print("host_cost: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    print(f"package: {os.path.dirname(dac.__file__)}", flush=True)
    for lib in LIBRARIES:
        if lib.source.stem in ("ms_deform_attn_fwd", "ms_deform_attn_dense", "roi_align_fwd",
                               "conv_stem_fwd"):
            lib.build()
    g = torch.Generator(device="cuda").manual_seed(19)
    calls = args.calls
    ops_ = torch.ops.poet_tpu_torch
    entries = {}

    def deform(Q, dense_route=False):
        value, locs, attn = cs.deform_inputs(g, 16, Q, 16, 16, cs.FLAGSHIP_LEVELS,
                                             lo=0.0, hi=1.0)
        v, shapes = value.bfloat16(), cs.FLAGSHIP_LEVELS
        flat = dac.flat_levels(shapes)
        if dense_route:
            return {"entry": lambda: dense.ms_deform_attn_dense(v, shapes, locs, attn),
                    "operator": lambda: ops_.ms_deform_attn_dense(v, flat, locs, attn),
                    "wrapper": lambda: dense.MS_DEFORM_ATTN_DENSE_FWD(v, shapes, locs, attn)}
        wrapper = dac.forward_kernel(v, locs)
        return {"entry": lambda: dac.ms_deform_attn(v, shapes, locs, attn),
                "operator": lambda: ops_.ms_deform_attn(v, flat, locs, attn, "merged"),
                "wrapper": lambda: wrapper(v, shapes, locs, attn)}

    entries["1a forward, direct route (decoder)"] = deform(10)
    entries["1b forward, slab route (encoder)"] = deform(1600)
    entries["8 dense forward (encoder)"] = deform(1600, dense_route=True)
    H, W = cs.FLAGSHIP_HW
    feats = [torch.randn((16, H // s, W // s, 256), generator=g, device="cuda").bfloat16()
             for s in cs.ROI_STRIDES]
    boxes = cs.roi_boxes(g, 16, 1000, H, W, "proposals")
    geo = roi_geometry([tuple(f.shape[1:3]) for f in feats], cs.ROI_STRIDES, boxes)
    rk = roi.roi_align_kernel(feats, 7, geo.ylo.shape[1] // 7)
    entries["5b RoIAlign, tiles route"] = {
        "entry": lambda: roi.multiscale_roi_align(feats, cs.ROI_STRIDES, boxes),
        "operator": lambda: ops_.roi_align_blend(feats, boxes, geo.level, geo.ylo, geo.yw,
                                                 geo.xlo, geo.xw, 7),
        "wrapper": lambda: rk.launch(feats, boxes, geo, 7)}
    x, w, b = cs.stem_inputs(g, 16, H, W, 3, 32, 3, 3, True)
    x, w = x.bfloat16(), w.bfloat16()            # the bias stays f32, as the path's
    pad = ((1, 1), (1, 1))
    entries["7 stem conv (YOLO L0)"] = {
        "entry": lambda: stem.conv_stem(x, w, b, stride=1, padding=pad, activation="mish"),
        "operator": lambda: ops_.conv_stem(x, w, b, 1, [1, 1, 1, 1], "mish", None),
        "wrapper": lambda: stem.CONV_STEM_FWD(x, w, b, stride=1, padding=pad,
                                              activation="mish")}
    with torch.inference_mode():
        for key, fns in entries.items():
            row = {"entry_name": key}
            for part, fn in fns.items():
                row[f"{part}_us"] = host_us(fn, calls, run=20)
            row["dispatch_us"] = row["operator_us"] - row["wrapper_us"]
            row["before_operator_us"] = row["entry_us"] - row["operator_us"]
            print(json.dumps(row), flush=True)
        t = x
        index = t.get_device()

        def old_context():
            with torch.cuda.device(t.device):
                pass

        def new_context():
            if torch._C._cuda_getDevice() != index:
                raise AssertionError("the tensor's device is not current")

        helpers = {
            "stream: torch.cuda.current_stream(device).cuda_stream (before)":
                lambda: torch.cuda.current_stream(t.device).cuda_stream,
            "stream: torch._C._cuda_getCurrentRawStream (after)":
                lambda: torch._C._cuda_getCurrentRawStream(index),
            "device: torch.cuda.device context (before)": old_context,
            "device: current-device test, no context (after)": new_context,
            "torch.empty((B, Q, H * D), dtype=, device=)": lambda: torch.empty(
                (16, 1600, 256), dtype=t.dtype, device=t.device),
            "level_hw (before: a new ctypes array a call; after: kept per pyramid)":
                lambda: level_hw(cs.FLAGSHIP_LEVELS),
            "is_current_stream_capturing": torch.cuda.is_current_stream_capturing,
        }
        print(json.dumps({name: host_us(fn, calls) for name, fn in helpers.items()}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
