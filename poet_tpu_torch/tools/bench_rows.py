"""Device time of every on-path deformable-attention kernel that includes the
shared point header, one row of PERF.md's kernel table each.

    python3 poet_tpu_torch/tools/bench_rows.py [--root DIR] [--rows 1a,1b,...]

Times the kernels of the package under `--root` (default: this checkout;
another checkout, such as a parent commit unpacked beside it, for parent,
change, change, parent in one call) by CUDA-graph replays
(`tools/timing.py:graph_ms`), bf16, at uniform random locations
(`chip_smoke.deform_inputs`, one seed, so every package gets the same
inputs), each at its row's shape (chip_smoke.py's geometries; H=16 D=16
L=P=4, B=16):

  1a  the forward's direct route            decoder (Q=10, S=1600)
  1b  the forward's slab route              encoder (Q=S=1600)
  2a  d_value's atomic scatter              encoder
  2b  d_value's slab route                  decoder
  3   d_loc / d_attn, direct route          decoder
  3b  d_loc / d_attn, slab route            encoder
  4a  the merged adjoint's atomic route     YOLO pyramid (Q=S=6380)
  4b  the merged adjoint's slab route       encoder
  4c  the merged adjoint's banded route     YOLO pyramid
  8   the dense forward                     encoder
  9   the dense adjoint, whole (with 9b)    encoder
  9b  the dense adjoint's d_loc blocks      encoder, on the staged slab
  11b the forward variants' base            encoder, on the TMA-staged slab

Run it as a script path: `-m` imports this checkout's package whatever
`--root` says. The card's name and power limit come first, then one JSON
line per row. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))

# row -> (geometry of chip_smoke.ROUTE_GEOMETRIES, wrapper, its module, call kind)
ROWS = {
    "1a": ("decoder", "MS_DEFORM_ATTN_FWD", "deform_attn_cuda", "forward"),
    "1b": ("encoder", "MS_DEFORM_ATTN_FWD_SLAB", "deform_attn_cuda", "forward"),
    "2a": ("encoder", "MS_DEFORM_ATTN_DVALUE", "deform_attn_cuda", "adjoint"),
    "2b": ("decoder", "MS_DEFORM_ATTN_DVALUE_SLAB", "deform_attn_cuda", "adjoint"),
    "3": ("decoder", "MS_DEFORM_ATTN_DLOC", "deform_attn_cuda", "adjoint"),
    "3b": ("encoder", "MS_DEFORM_ATTN_DLOC_SLAB", "deform_attn_cuda", "adjoint"),
    "4a": ("yolo pyramid", "MS_DEFORM_ATTN_MERGED", "deform_attn_cuda", "adjoint"),
    "4b": ("encoder", "MS_DEFORM_ATTN_MERGED_SLAB", "deform_attn_cuda", "adjoint"),
    "4c": ("yolo pyramid", "MS_DEFORM_ATTN_MERGED_BANDED", "deform_attn_cuda", "adjoint"),
    "8": ("encoder", "MS_DEFORM_ATTN_DENSE_FWD", "deform_attn_dense_cuda", "forward"),
    "9": ("encoder", "MS_DEFORM_ATTN_DENSE_BWD", "deform_attn_dense_cuda", "adjoint"),
    "9b": ("encoder", "MS_DEFORM_ATTN_DENSE_DLOC", "deform_attn_dense_cuda", "adjoint"),
    "11b": ("encoder", "MS_DEFORM_ATTN_VARIANT", "bench_v3_variants", "variant"),
}
SEED = 21


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--rows", default=",".join(ROWS))
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)            # chip_smoke's geometries and inputs
    sys.path.insert(0, os.path.abspath(args.root))      # the package under test
    import importlib

    import torch

    import chip_smoke as cs
    from poet_tpu_torch.tools.timing import graph_ms

    if not torch.cuda.is_available():
        print("bench_rows: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    modules = {name: importlib.import_module(f"poet_tpu_torch.ops.{name}")
               for name in ("deform_attn_cuda", "deform_attn_dense_cuda")}
    modules["deform_attn_cuda"].build_all()          # every source at once, in parallel
    modules["bench_v3_variants"] = importlib.import_module(
        "poet_tpu_torch.tools.bench_v3_variants")
    print(f"package: {os.path.dirname(os.path.dirname(modules['deform_attn_cuda'].__file__))}",
          flush=True)
    inputs = {}
    for row in args.rows.split(","):
        geometry, wrapper, module, kind = ROWS[row]
        if geometry not in inputs:
            _, B, Q, H, D, shapes, lo, hi, pad = next(x for x in cs.ROUTE_GEOMETRIES
                                                      if x[0] == geometry)
            g = torch.Generator(device=cs.DEVICE).manual_seed(SEED)
            value, locs, attn = cs.deform_inputs(g, B, Q, H, D, shapes, lo=lo, hi=hi, pad=pad)
            dout = torch.randn((B, Q, H * D), generator=g, device=cs.DEVICE)
            inputs[geometry] = (value.bfloat16(), shapes, locs, attn, dout.bfloat16())
        value, shapes, locs, attn, dout = inputs[geometry]
        kernel = getattr(modules[module], wrapper)
        if kind == "forward":
            call = (value, shapes, locs, attn)
        elif kind == "adjoint":
            call = (value, shapes, locs, attn, dout)
        else:
            call = (value, shapes, locs, attn, "base")
        with torch.inference_mode():
            ms = graph_ms(lambda: kernel(*call))
        print(json.dumps({"row": row, "kernel": wrapper, "shape": geometry,
                          "B": value.shape[0], "Q": locs.shape[1], "S": value.shape[1],
                          "dtype": "bfloat16", "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
