#!/usr/bin/env python3
"""The benchmark of poet_tpu_torch, one cell a run:

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

NAME is a `workloads` entry of BENCHMARK.json: a configuration
(`portbench/configs/<config>.json`) under a traffic mix
(`portbench/traffic/<traffic>.json`). The run makes the weights and the
requests from the seed on the card, builds the program's model and serves
(or trains) with it: the set-up, warm-up included, is `setup_s`; then it
measures for S seconds. With --trace 0 it reports the cell's end-to-end
metrics, with --trace 1 its per-layer metrics from a `torch.profiler` trace
of the window, each metric read by `portbench/metrics/<metric>.py`. After
the window it checks a sample of the answers against the plain reference
(`portbench/lib/checks.py`, limits in `portbench/limits/<workload>.json`)
and prints one JSON line last on standard output, the numbers compared last
on standard error. It needs `chips` CUDA devices and exits 3 without them.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# one process, few threads: the serving loop is one host thread launching
# work; idle OpenMP workers spinning beside it only add noise
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

FORBIDDEN = ("jax", "jaxlib", "flax", "poet_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (`poet_tpu_torch` is the program, not `poet_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device_check: bool = True) -> int:
    args = parse(argv)
    from portbench.lib import manifest

    bench = manifest.manifest()
    cell = manifest.workload(args.workload, bench)
    conf = manifest.Config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    limits = manifest.limits(args.workload)
    metrics = manifest.metrics_of(args.workload, bool(args.trace), bench)
    readers = {m["name"]: manifest.metric_reader(m["name"]) for m in metrics}

    import torch

    torch.set_num_threads(1)
    if device_check and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda" if device_check else os.environ.get("PORTBENCH_DEVICE", "cuda"))

    from portbench.lib import driver

    run = driver.run_cell(conf, traffic, args, device, T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 4

    from portbench.lib import checks

    correct = checks.judge(run["checks"], limits)
    values = {}
    for m in metrics:
        v = readers[m["name"]](run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": run["attempted"],
        "failed": run["failed"],
        "metrics": values,
        "device": run["device"],
    }
    if args.trace and run.get("breakdown"):
        result["breakdown"] = run["breakdown"]
    result["checks"] = {k: {"value": run["checks"].get(k), "limit": lim}
                        for k, lim in limits.items()}
    print("setup phases (s): " + json.dumps(run["setup_phases"]), file=sys.stderr)
    print("readings: " + json.dumps(run["checks"]), file=sys.stderr)
    for k, lim in limits.items():
        print(f"check {k} = {run['checks'].get(k)!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    del run
    gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
