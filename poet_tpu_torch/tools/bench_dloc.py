"""Device time of the pair's d_loc / d_attn gather, on each of its routes.

    python3 poet_tpu_torch/tools/bench_dloc.py [--root DIR] [--check]

Times the gather of the package under `--root` (default: this checkout;
another checkout, such as a parent commit unpacked beside it, for an A/B in
one process each) by CUDA-graph replays (`tools/timing.py:graph_ms`): the
direct route (`MS_DEFORM_ATTN_DLOC`) and, where the package has it, the slab
route (`MS_DEFORM_ATTN_DLOC_SLAB`) with the route its rule takes, on
chip_smoke.py phase 6's flagship encoder (B=16, Q=S=1600) and decoder (B=16,
Q=10), H=16, D=16, L=P=4, in f32 and bf16, each at phase 6's uniform random
locations and at a model's (`chip_smoke.model_locations`), and at the
encoder with every point at one location (the slab route's shared loads
then broadcast: no bank conflicts, the floor its conflicts are read
against). `--check` holds
each route against the plain adjoint first (phase 6's tolerance). The card's
name and power limit come first, one JSON line per case after. Needs one
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))

CASES = ("encoder", "decoder")


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)            # chip_smoke's geometries and inputs
    sys.path.insert(0, os.path.abspath(args.root))      # the package under test
    import torch

    import chip_smoke as cs
    from poet_tpu_torch.ops import deform_attn_cuda as dac
    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch_backward as plain_bwd
    from poet_tpu_torch.tools.timing import graph_ms

    if not torch.cuda.is_available():
        print("bench_dloc: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    print(f"package: {os.path.dirname(dac.__file__)}", flush=True)
    dac.BWD_LIB.build()
    routes = {"direct": dac.MS_DEFORM_ATTN_DLOC}
    if hasattr(dac, "MS_DEFORM_ATTN_DLOC_SLAB"):
        routes["slab"] = dac.MS_DEFORM_ATTN_DLOC_SLAB
    g = torch.Generator(device=cs.DEVICE).manual_seed(6)
    for name in CASES:
        _, B, Q, H, D, shapes, lo, hi, pad = next(x for x in cs.ADJ_GEOMETRIES if x[0] == name)
        value, uniform, attn = cs.deform_inputs(g, B, Q, H, D, shapes, lo=lo, hi=hi, pad=pad)
        model = cs.model_locations(g, B, Q, H, shapes)
        model[:, -2:] = torch.tensor([-1.0, -10.0], device=cs.DEVICE)[:, None, None, None,
                                                                     None]   # the dummies
        dout = torch.randn((B, Q, H * D), generator=g, device=cs.DEVICE)
        kinds = [("uniform", uniform), ("model", model)]
        if name == "encoder":
            one = torch.full_like(uniform, 0.37)             # one cell of every level
            one[:, -2:] = model[:, -2:]
            kinds.append(("one point", one))
        for where, locs in kinds:
            for dt in (torch.float32, torch.bfloat16):
                v, do = value.to(dt), dout.to(dt)
                call = (v, shapes, locs, attn, do)
                rec = {"case": name, "locations": where, "dtype": str(dt).replace("torch.", ""),
                       "B": B, "Q": Q}
                if hasattr(dac, "plan_dloc"):
                    rec["rule"] = dac.plan_dloc(value.shape[1], D, dt, Q, len(shapes),
                                                locs.shape[4]).route
                if args.check:
                    ref = plain_bwd(v.float(), shapes, locs, attn, do.float())[1:]
                    mask = cs.off_edges(locs, shapes)
                    for route, kernel in routes.items():
                        got = kernel(*call)
                        rec[f"{route}_err"] = {k: cs.adjoint_err(a, b, m)[0] for k, a, b, m in
                                               zip(("d_loc", "d_attn"), got, ref, (mask, None))}
                        rec[f"{route}_ok"] = not any(
                            cs.adjoint_err(a, b, m)[1]
                            for a, b, m in zip(got, ref, (mask, None)))
                for route, kernel in routes.items():
                    rec[f"{route}_ms"] = graph_ms(lambda: kernel(*call))
                rec["bound_ms"] = cs.deform_bound(locs, shapes, D, v, locs, attn, do, locs,
                                                  attn)[0]
                print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
