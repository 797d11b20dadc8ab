"""Device time of the merged adjoint's routes where its f32 d_value slab does
not fit one block: the banded route (each band's value rows staged or not)
against the atomic route and the plain adjoint.

    python3 poet_tpu_torch/tools/bench_banded.py [--root DIR] [--check]
        [--cases yolo,yolo_decoder,encoder] [--dtypes bfloat16,float32]

Times the merged adjoint of the package under `--root` (default: this
checkout; another checkout, such as a parent commit unpacked beside it, for
an A/B in one process each) by CUDA-graph replays
(`tools/timing.py:graph_ms`) on chip_smoke.py phase 18's geometries: the
YOLO pyramid at B=16 as its encoder (Q=S=6380) and its decoder (Q=10), and
the flagship encoder (B=16, Q=S=1600; its slab and atomic routes, and the
banded route in one band), H=16, D=16, L=P=4, each at uniform random
locations and at a model's (`chip_smoke.grid_locations`, the last two
queries the -1 / -10 dummies). Every route the package has is timed: the
atomic route (`MS_DEFORM_ATTN_MERGED`, its zeroed buffer and cast
included), the slab route where its slab fits, and, where the package has
it, the banded route staged and unstaged; the plain adjoint per host call
beside them. `--check` holds each route against the plain adjoint first
(phase 18's tolerances). The card's name and power limit come first, one
JSON line per case after. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))

CASES = {"yolo": ("yolo pyramid", 6380), "yolo_decoder": ("yolo pyramid", 10),
         "encoder": ("encoder", 1600)}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--cases", default="yolo,yolo_decoder,encoder")
    ap.add_argument("--dtypes", default="bfloat16,float32")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)            # chip_smoke's geometries and inputs
    import chip_smoke as cs

    sys.path.insert(0, os.path.abspath(args.root))      # the package under test
    import torch

    from poet_tpu_torch.ops import deform_attn_cuda as dac
    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch_backward as plain_bwd
    from poet_tpu_torch.tools.timing import cuda_ms, graph_ms

    if not torch.cuda.is_available():
        print("bench_banded: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    print(f"package: {os.path.dirname(dac.__file__)}", flush=True)
    dac.BWD_LIB.build()
    g = torch.Generator(device=cs.DEVICE).manual_seed(18)
    for case in args.cases.split(","):
        geometry, Q = CASES[case]
        _, B, _, H, D, shapes, lo, hi, pad = next(x for x in cs.ROUTE_GEOMETRIES
                                                  if x[0] == geometry)
        value, uniform, attn = cs.deform_inputs(g, B, Q, H, D, shapes, lo=lo, hi=hi, pad=pad)
        grid = cs.model_locations(g, B, Q, H, shapes)
        grid[:, -2:] = torch.tensor([-1.0, -10.0], device=cs.DEVICE)[:, None, None, None, None]
        dout = torch.randn((B, Q, H * D), generator=g, device=cs.DEVICE)
        S, L, P = value.shape[1], len(shapes), uniform.shape[4]
        for dtype in args.dtypes.split(","):
            dt = getattr(torch, dtype)
            v, do = value.to(dt), dout.to(dt)
            routes = {"atomic": dac.MS_DEFORM_ATTN_MERGED}
            if dac.merged_slab_bytes(S, D, dt, False) <= dac.SMEM_OPTIN_MAX:
                routes["slab"] = dac.MS_DEFORM_ATTN_MERGED_SLAB
            if hasattr(dac, "MS_DEFORM_ATTN_MERGED_BANDED"):
                for stage in (True, False):
                    routes[cs.banded_name(stage)] = (
                        lambda st: lambda *a: dac.MS_DEFORM_ATTN_MERGED_BANDED(*a, stage=st))(
                            stage)
            for where, locs in (("uniform", uniform), ("grid", grid)):
                call = (v, shapes, locs, attn, do)
                rec = {"case": case, "locations": where, "dtype": dtype, "B": B, "Q": Q, "S": S,
                       "rule": dac.plan_merged(S, D, dt, Q, L, P)._asdict()}
                if args.check:
                    ref = plain_bwd(v.float(), shapes, locs, attn, do.float())
                    mask = cs.off_edges(locs, shapes)
                    for route, kernel in routes.items():
                        rec[f"{route}_err"] = cs.adjoint_checks(
                            f"{case} {where} {route}", kernel(*call), ref, value, locs, Q,
                            S - pad, pad, mask, dt == torch.bfloat16)
                for route, kernel in routes.items():
                    rec[f"{route}_ms"] = graph_ms(lambda: kernel(*call))
                rec["plain_ms"] = cuda_ms(lambda: plain_bwd(*call), iters=3, warmup=1)
                got = dac.merged_adjoint(*call)
                rec["bound_ms"] = cs.merged_bound(v, locs, attn, do, got, shapes)[0]
                print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
