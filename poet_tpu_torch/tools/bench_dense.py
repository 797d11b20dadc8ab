"""Device time of the dense one-hot deformable-attention kernels ('pallas').

    python3 poet_tpu_torch/tools/bench_dense.py [--root DIR] [--check] [--ptxas]

Times `MS_DEFORM_ATTN_DENSE_FWD` and `MS_DEFORM_ATTN_DENSE_BWD` of the
package under `--root` (default: this checkout; another checkout, such as
a parent commit unpacked beside it, for an A/B in one process each), by
CUDA-graph replays (`tools/timing.py:graph_ms`), on chip_smoke.py phase
19's geometries: the flagship encoder (B=16, Q=S=1600) and decoder (B=16,
Q=10), H=16, D=16, L=P=4, and the forward at the YOLO pyramid (B=2,
Q=S=6380), in f32 and bf16, each at phase 19's uniform random locations
and at a model's (`chip_smoke.grid_locations`; the decoder takes 10 of its
queries: `chip_smoke.model_locations`). Where the package has them it also
times the adjoint's two kinds of block alone, and its d_loc / d_attn blocks
on the route its rule does not take (`stage`: the value slab staged in
shared memory, in a launch of their own, or read from device memory in the
d_value blocks' launch), alone and in the whole adjoint.
`--check` holds the
kernels against the plain versions first (f32 and bf16 tolerances of
chip_smoke.py, the adjoint bit-identical over two runs); `--ptxas` prints
the dense library's register and shared-memory lines. The card's name and
power limit come first, one JSON line per case after. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))

CASES = ("encoder", "decoder", "yolo pyramid")


def _inputs(cs, g, name, uniform):
    """(value f32, locs, attn, dout f32, shapes) of phase 19's geometry
    `name`, at its uniform locations or at a model's."""
    import torch

    geo = next(x for x in cs.DENSE_GEOMETRIES if x[0] == name)
    _, B, Q, H, D, shapes, lo, hi, pad = geo
    value, locs, attn = cs.deform_inputs(g, B, Q, H, D, shapes, lo=lo, hi=hi, pad=pad)
    if not uniform:
        locs = cs.model_locations(g, B, Q, H, shapes)
    dout = torch.randn((B, Q, H * D), generator=g, device=cs.DEVICE)
    return value, locs, attn, dout, shapes


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, REPO)            # chip_smoke's geometries and inputs
    sys.path.insert(0, root)            # the package under test
    import torch

    import chip_smoke as cs
    from poet_tpu_torch.ops import deform_attn_dense_cuda as dense
    from poet_tpu_torch.tools.timing import graph_ms

    if not torch.cuda.is_available():
        print("bench_dense: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    print(f"package: {os.path.dirname(dense.__file__)}", flush=True)
    DF, DB = dense.MS_DEFORM_ATTN_DENSE_FWD, dense.MS_DEFORM_ATTN_DENSE_BWD
    dense.DENSE_LIB.build()
    if args.ptxas:
        for line in dense.DENSE_LIB.build_log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print("ptxas", line.strip())
    parts = "part" in inspect.signature(DB.__call__).parameters
    stages = "stage" in inspect.signature(DB.__call__).parameters
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch as plain
    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch_backward as plain_bwd

    g = torch.Generator(device=cs.DEVICE).manual_seed(19)
    for name in CASES:
        for uniform in (True, False):
            value, locs, attn, dout, shapes = _inputs(cs, g, name, uniform)
            for dt in (torch.float32, torch.bfloat16):
                v, do = value.to(dt), dout.to(dt)
                args_ = (v, shapes, locs, attn)
                rec = {"case": name, "locations": "uniform" if uniform else "model",
                       "dtype": str(dt).replace("torch.", ""), "B": v.shape[0],
                       "Q": locs.shape[1]}
                if args.check:
                    with torch.inference_mode():
                        ref = plain(v.float(), shapes, locs, attn)
                        out = DF(*args_)
                    err = (out.float() - ref).abs()
                    tol = (cs.BF16_ATOL + cs.BF16_RTOL * ref.abs() if dt == torch.bfloat16
                           else cs.F32_ATOL)
                    rec["fwd_ok"] = bool((err <= tol).all())
                    rec["fwd_err"] = err.max().item()
                    if name != "yolo pyramid":
                        got, again = DB(*args_, do), DB(*args_, do)
                        rec["bwd_bit_identical"] = all(torch.equal(a, b)
                                                       for a, b in zip(got, again))
                        want = plain_bwd(v.float(), shapes, locs, attn, do.float())
                        rec["bwd_err_rel"] = {
                            k: ((a.float() - b).abs().max() / b.abs().max()).item()
                            for k, a, b in zip(("d_value", "d_loc", "d_attn"), got, want)}
                with torch.inference_mode():
                    rec["fwd_ms"] = graph_ms(lambda: DF(*args_))
                if name != "yolo pyramid":
                    rec["bwd_ms"] = graph_ms(lambda: DB(*args_, do))
                    if parts:
                        rec["bwd_d_value_ms"] = graph_ms(lambda: DB(*args_, do, part="d_value"))
                        rec["bwd_d_loc_ms"] = graph_ms(lambda: DB(*args_, do, part="d_loc"))
                    if stages:
                        S, D = v.shape[1], v.shape[3]
                        L, P = locs.shape[3], locs.shape[4]
                        rule = dense.plan_dloc(S, D, dt, locs.shape[1], L, P).stage
                        rec["d_loc_rule"] = "slab" if rule else "direct"
                        other = "direct" if rule else "slab"
                        rec[f"bwd_{other}_ms"] = graph_ms(lambda: DB(*args_, do, stage=not rule))
                        rec[f"bwd_d_loc_{other}_ms"] = graph_ms(
                            lambda: DB(*args_, do, part="d_loc", stage=not rule))
                print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
