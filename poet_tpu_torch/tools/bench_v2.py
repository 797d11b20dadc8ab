"""Device time of the v2 forward beside kernel 1's two routes, for an A/B
of two checkouts in one call.

    python3 poet_tpu_torch/tools/bench_v2.py [--root DIR] [--dtypes bfloat16,float32]
        [--ctas 1,2,4,8] [--split [--repeats N]]

Times `MS_DEFORM_ATTN_V2` of the package under `--root` (default: this
checkout; another checkout, such as a parent commit unpacked beside it, for
parent, change, change, parent in one call) and kernel 1's direct and slab
routes (`ops/deform_attn_cuda.py`, the function v2 computes) on chip_smoke.py
phase 21's timed geometries: the flagship encoder (B=16 Q=S=1600) and
decoder (Q=10), and the YOLO pyramid at B=16 (Q=S=6380; kernel 1's slab
route where its slab fits), H=16, D=16, L=P=4, uniform random locations;
device ms from CUDA events over back-to-back launches (`cuda_ms`, as phase
21) and from CUDA-graph replays (`graph_ms`). `--ctas` also times this
checkout's v2 with each one-band plan forced to that many CTAs a (b, h)
(one cluster, multicast where more than one; graph replays): the sweep
behind `plan_v2`'s choice. `--split` times, instead, multicast over a
cluster of n > 1 CTAs a (b, h) against the same CTAs in clusters of one,
each staging its own slab by TMA (graph replays, `--repeats` times, the
order swapped each time; both checked against the plain version): the
encoder and the YOLO pyramid at B = 1, 2, 3, 4, 8 (B H under the card's
132 SMs) with the n the planner picks for one band and each n of `--ctas`,
and the YOLO pyramid in f32 at several bands (B=16 too) with the planner's
clusters. The card's name and power limit come first, one
JSON line per case after. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
CASES = (("encoder", 1600, "FLAGSHIP_LEVELS"), ("decoder", 10, "FLAGSHIP_LEVELS"),
         ("yolo pyramid", 6380, "YOLO_LEVELS"))
# --split: (case, B, Q, levels, dtype)
SPLIT_CASES = tuple((name, B, Q, levels, dtype) for B in (1, 2, 3, 4, 8)
                    for name, Q, levels in (CASES[0], CASES[2])
                    for dtype in ("bfloat16", "float32")) + (
    ("yolo pyramid", 16, 6380, "YOLO_LEVELS", "float32"),)


def one_band_plan(plan, n: int, Q: int, max_threads: int):
    """A one-band plan forced to n CTAs a (b, h), in one cluster, each CTA
    taking its queries in passes of up to `max_threads`."""
    q_per_cta = -(-Q // n)
    passes = -(-q_per_cta * plan.slices // max_threads)
    threads = -(-(-(-q_per_cta // passes)) * plan.slices // 32) * 32
    return dataclasses.replace(plan, cluster=n, clusters=1, q_per_cta=q_per_cta, threads=threads)


def split(cs, torch, v2, graph_ms, g, ctas, repeats) -> None:
    """The `--split` rows: each multicast plan against its CTAs in clusters
    of one, `repeats` times, the order of the two swapped each time; with
    `ctas`, each one-band case also forced to each of those CTA counts."""
    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch as plain

    K = v2.MS_DEFORM_ATTN_V2
    for rep in range(repeats):
        for name, B, Q, levels, dtype in SPLIT_CASES:
            shapes = getattr(cs, levels)
            value, locs, attn = cs.deform_inputs(g, B, Q, 16, 16, shapes, lo=0.0, hi=1.0)
            v = value.to(getattr(torch, dtype))
            plan = K.plan(v, shapes, locs)
            if plan.n_bands > 1:
                plans = [plan] if plan.cluster > 1 else []
            else:
                plans = [one_band_plan(plan, n, Q, v2.MAX_THREADS)
                         for n in sorted({plan.cluster, *ctas}) if n > 1]
            ref = plain(v.float(), shapes, locs, attn)
            for mc in plans:
                alone = dataclasses.replace(mc, cluster=1, clusters=mc.cluster * mc.clusters)
                row = {"case": name, "dtype": dtype, "B": B, "Q": Q, "repeat": rep,
                       "n_bands": mc.n_bands, "ctas_per_bh": mc.cluster * mc.clusters,
                       "planned": mc.cluster * mc.clusters == plan.cluster * plan.clusters}
                pair = (("multicast", mc), ("clusters_of_one", alone))
                for key, p in pair if rep % 2 == 0 else pair[::-1]:
                    K.plan = lambda *a, p=p, **kw: p
                    try:
                        err = (K(v, shapes, locs, attn).float() - ref).abs().max().item()
                        row[f"{key}_graph_ms"] = graph_ms(lambda: K(v, shapes, locs, attn))
                        row[f"{key}_max_abs_err"] = err
                    finally:
                        del K.plan              # back to the class's plan
                print(json.dumps(row), flush=True)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--dtypes", default="bfloat16,float32")
    ap.add_argument("--ctas", default="")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--repeats", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)            # chip_smoke's geometries and inputs
    import chip_smoke as cs

    sys.path.insert(0, os.path.abspath(args.root))      # the package under test
    import torch

    from poet_tpu_torch.ops import deform_attn_cuda as dac
    from poet_tpu_torch.ops import deform_attn_v2_cuda as v2
    from poet_tpu_torch.tools.timing import cuda_ms, graph_ms

    if not torch.cuda.is_available():
        print("bench_v2: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    print(f"package: {os.path.dirname(v2.__file__)}", flush=True)
    v2.V2_LIB.build()
    dac.FWD_LIB.build()
    g = torch.Generator(device="cuda").manual_seed(21)
    with torch.inference_mode():
        if args.split:
            split(cs, torch, v2, graph_ms, g,
                  [int(x) for x in args.ctas.split(",") if x], args.repeats)
            return 0
        for name, Q, levels in CASES:
            shapes = getattr(cs, levels)
            value, locs, attn = cs.deform_inputs(g, 16, Q, 16, 16, shapes, lo=0.0, hi=1.0)
            for dtype in args.dtypes.split(","):
                v = value.to(getattr(torch, dtype))
                S, D = v.shape[1], v.shape[3]
                routes = {"v2": v2.MS_DEFORM_ATTN_V2, "kernel1_direct": dac.MS_DEFORM_ATTN_FWD}
                if S * D * v.element_size() <= dac.SMEM_OPTIN_MAX:
                    routes["kernel1_slab"] = dac.MS_DEFORM_ATTN_FWD_SLAB
                row = {"case": name, "dtype": dtype, "B": 16, "Q": Q}
                for route, k in routes.items():
                    row[f"{route}_ms"] = cuda_ms(lambda: k(v, shapes, locs, attn))
                    row[f"{route}_graph_ms"] = graph_ms(lambda: k(v, shapes, locs, attn))
                K = v2.MS_DEFORM_ATTN_V2
                plan = K.plan(v, shapes, locs) if args.ctas else None
                for n in [int(x) for x in args.ctas.split(",") if x] if plan else ():
                    if plan.n_bands > 1:
                        break
                    forced = one_band_plan(plan, n, Q, v2.MAX_THREADS)
                    K.plan = lambda *a, forced=forced, **kw: forced
                    try:
                        row[f"v2_{n}_ctas_graph_ms"] = graph_ms(lambda: K(v, shapes, locs, attn))
                    finally:
                        del K.plan              # back to the class's plan
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
