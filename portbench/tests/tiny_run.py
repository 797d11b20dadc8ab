"""A benchmark run for the tests, the harness's look for a card skipped:

    python portbench/tests/tiny_run.py [--fault NAME] [--card] [--held] -- <run.py's arguments>

On the CPU it shrinks the cell's traffic (batch 2, small pools, a short
warm-up); with --card it runs the cell as it is, on the card. --fault plants
one of `portbench/lib/faults.py`'s faults under the timed path. --held adds
the cells of held_cells.json (kept out of BENCHMARK.json until their
timings repeat; PERF.md says why) to the manifest.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HELD = Path(__file__).with_name("held_cells.json")
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fault", default=None)
    ap.add_argument("--card", action="store_true")
    ap.add_argument("--held", action="store_true",
                    help="add held_cells.json's cells, kept out of BENCHMARK.json, to the manifest")
    ap.add_argument("rest", nargs=argparse.REMAINDER)
    a = ap.parse_args()
    import torch

    if not a.card:
        torch.set_num_threads(4)
    from portbench import run
    from portbench.lib import driver, faults, manifest

    traffic = manifest.traffic

    def small(name):
        t = dict(traffic(name), batch=2, pool=2)
        if t["kind"] == "serve":
            t.update(warmup_requests=1, check_requests=1)
        else:
            t.update(image_hw=[256, 320])
        return t

    if not a.card:
        manifest.traffic = small
    if a.held:
        bench = manifest.manifest()
        extra = json.loads(HELD.read_text())
        manifest.manifest = lambda: {k: v + extra.get(k, []) if isinstance(v, list) else v
                                     for k, v in bench.items()}
    if a.fault == "half":
        run_cell = driver.run_cell

        def train_half(conf, t, args, device, t_start, fault=None):
            return run_cell(conf, t, args, device, t_start,
                            "half" if t["kind"] == "train" else None)

        driver.run_cell = train_half
    os.environ["PORTBENCH_DEVICE"] = "cuda" if a.card else "cpu"
    rest = a.rest[1:] if a.rest[:1] == ["--"] else a.rest
    serving = manifest.traffic(manifest.workload(run.parse(rest).workload)["traffic"])["kind"] \
        == "serve"
    with faults.planted(a.fault, serving):
        return run.main(rest, device_check=False)


if __name__ == "__main__":
    sys.exit(main())
