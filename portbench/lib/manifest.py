"""Everything the harness finds by name: the manifest (`BENCHMARK.json` at
the root of the checkout), a configuration (`portbench/configs/<name>.json`),
a traffic mix (`portbench/traffic/<name>.json`), a cell's correctness limits
(`portbench/limits/<workload>.json`) and a metric's reader
(`portbench/metrics/<metric>.py`). Adding one of them is adding a file."""

from __future__ import annotations

import importlib.util
import json
from functools import cached_property
from pathlib import Path
from typing import Dict

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def workload(name: str, bench: dict = None) -> dict:
    bench = bench or manifest()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(name: str, trace: bool, bench: dict = None) -> list:
    """The metrics a run of workload `name` reports: its end-to-end metrics
    with --trace 0, its per-layer metrics with --trace 1."""
    bench = bench or manifest()
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def read_json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} (the {kind} file of {name!r})")
    with open(path) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    return read_json("traffic", name)


def limits(workload_name: str) -> Dict[str, float]:
    return read_json("limits", workload_name)


def metric_reader(name: str):
    """`portbench/metrics/<name>.py`'s `read(run)`: the metric's value from
    the run record, or None where the run has nothing to read."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"{path} (the reader of metric {name!r})")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Config:
    """A configuration file: `model` (PoET's settings), `backbone`
    ('darknet' with its cfg file beside it, or 'resnet50_fpn'), the keys the
    program's config takes (`program`), `weights` (conditioning) and the
    bookkeeping keys (`source`, `assumed`, `reduced`)."""

    def __init__(self, name: str):
        self.name = name
        self.data = read_json("configs", name)
        self.model = self.data["model"]
        self.backbone = self.data["backbone"]
        self.weights = self.data.get("weights", {})

    @cached_property
    def darknet_cfg(self) -> Path:
        return BENCH / "configs" / self.data["darknet_cfg"]

    @cached_property
    def sections(self):
        from portbench.reference.darknet import parse_cfg
        return parse_cfg(self.darknet_cfg.read_text())

    @cached_property
    def backbone_channels(self):
        if self.backbone == "darknet":
            from portbench.reference.darknet import walk
            w = walk(self.sections)
            return tuple(w[li - 2][0] for li, s in enumerate(self.sections[1:])
                         if s["type"] == "yolo")
        return (256,) * len(self.data["fpn_levels"])

    @cached_property
    def backbone_shapes(self) -> Dict[str, tuple]:
        if self.backbone == "darknet":
            from portbench.reference.darknet import param_shapes
            return param_shapes(self.sections)
        from portbench.reference.resnet_fpn import param_shapes
        return param_shapes(self.data["fpn_levels"])

    @cached_property
    def poet_shapes(self) -> Dict[str, tuple]:
        from portbench.reference.poet import param_shapes
        return param_shapes(self.model, self.backbone_channels)

    def shapes(self) -> Dict[str, tuple]:
        return {**self.backbone_shapes, **self.poet_shapes}
