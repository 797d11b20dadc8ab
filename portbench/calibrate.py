#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, in one
process on the card:

    python3 portbench/calibrate.py --workload NAME --seeds 1,2,... \
        [--control-seeds 7,8,9] [--faults half,...] [--fault-seeds 4,5,6] [--seconds 3]

For each of --seeds: the program's readings, as a benchmark run takes them
(weights and requests from the seed, warm-up, a short window at the cell's
load, the sampled answers against the reference). For each of
--control-seeds: the control's, the reference itself in the precision below
the configuration's (fp8 operands for bf16) put in the program's place,
answering the same sampled requests (training: following the same first
steps). For each of --fault-seeds: the program with each of --faults
planted (`portbench/lib/faults.py`; training's "half": half of each batch's
rows left out, the mean taken over the rest). For each of
--unchanged-seeds (training): a step that leaves the state unchanged,
worked out without a run. One JSON line a seed;
the limits go in `portbench/limits/<workload>.json` with the readings in
PERF.md.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CONTROL_PRECISION = {"bfloat16": "fp8"}


def unchanged_readings(conf, traffic, seed: int, device) -> dict:
    """The fault 'a step that returns its state unchanged', without a run:
    the program's first gradient and every change are then 0, and the
    losses those of the initial weights."""
    import torch

    from portbench.lib import checks, train, weights

    state = weights.make_weights(conf, seed, device)
    m = conf.model
    batches = train.make_batches(traffic, m["n_classes"], m["num_queries"], seed, device,
                                 conf, state)
    ref = checks.reference_training(conf, traffic, state, batches, device)
    first = checks.reference_training(conf, traffic, state, batches, device, steps=1)
    losses = [first["loss"][0]] * len(ref["loss"])
    prog = {"loss": losses, "grad": {k: 0.0 for k in ref["grad"]},
            "grad_vec": {k: torch.zeros_like(v) for k, v in ref["grad_vec"].items()},
            "change": {k: 0.0 for k in ref["change"]}}
    return checks.train_readings(prog, ref)


def program_readings(conf, traffic, seed: int, seconds: float, device, fault=None) -> dict:
    from portbench.lib import driver, faults

    args = SimpleNamespace(seed=seed, seconds=seconds, trace=0)
    serving = traffic["kind"] == "serve"
    with faults.planted(fault if serving or fault != "half" else None, serving):
        run = driver.run_cell(conf, traffic, args, device, time.perf_counter(),
                              "half" if fault == "half" and not serving else None)
    return dict(run["checks"], memory_peak_bytes=run["device"]["memory_peak_bytes"],
                images_per_s=run["images"] / run["window_s"],
                **({"leaves": run["leaf_report"]} if "leaf_report" in run else {}))


def control_readings(conf, traffic, seed: int, device) -> dict:
    import numpy as np

    from portbench.lib import checks, serve, weights

    state = weights.make_weights(conf, seed, device)
    precision = CONTROL_PRECISION[conf.model["dtype"]]
    if traffic["kind"] == "train":
        from portbench.lib import train

        m = conf.model
        batches = train.make_batches(traffic, m["n_classes"], m["num_queries"], seed, device,
                                     conf, state)
        ctrl = checks.reference_training(conf, traffic, state, batches, device, precision)
        ref = checks.reference_training(conf, traffic, state, batches, device)
        return dict(checks.train_readings(ctrl, ref), leaves=checks.leaf_report(ctrl, ref))
    t = dict(traffic, num_queries=conf.model["num_queries"], n_classes=conf.model["n_classes"])
    req = serve.Requests(t, seed, device)
    rng = np.random.default_rng([int(seed), 11])
    per = []
    for p in sorted(rng.permutation(len(req.pool))[:t["check_requests"]]):
        images = req.images(int(p))
        inputs = req.tracker_inputs(None) if t["mode"] == "tracker" else None
        ans = checks.control_answers(conf, state, images, device, precision, inputs)
        ref = checks.reference_answers(conf, state, images, ans, device)
        per.append(checks.readings(ans, ref, t["image_hw"]))
    return checks.worst(per)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="half",
                    help="faults of portbench/lib/faults.py run on each of --fault-seeds")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--unchanged-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch

    from portbench.lib import manifest

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda")
    cell = manifest.workload(args.workload)
    conf = manifest.Config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    kinds = [("program", args.seeds), ("control", args.control_seeds)]
    kinds += [(f, args.fault_seeds) for f in filter(None, args.faults.split(","))]
    kinds += [("unchanged", args.unchanged_seeds)]
    for kind, seeds in kinds:
        for s in filter(None, seeds.split(",")):
            t0 = time.perf_counter()
            if kind == "control":
                read = control_readings(conf, traffic, int(s), device)
            elif kind == "unchanged":
                read = unchanged_readings(conf, traffic, int(s), device)
            else:
                read = program_readings(conf, traffic, int(s), args.seconds, device,
                                        None if kind == "program" else kind)
            print(json.dumps({"kind": kind, "seed": int(s), "readings": read,
                              "seconds": round(time.perf_counter() - t0, 3)}), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
