"""The manifest and the files it names: every configuration, traffic mix,
cell limit and metric reader is found by name, and the manifest keeps to
the benchmark's contract."""

from __future__ import annotations

import json
import re
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.lib import manifest  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
              "workloads": {"name", "config", "traffic", "chips", "why"},
              "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
              "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}


def test_manifest_keys_and_names():
    bench = manifest.manifest()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and 1 <= bench["run_seconds"] <= 51
    names = []
    for group, keys in ENTRY_KEYS.items():
        for e in bench[group]:
            assert set(e) <= keys and set(e) >= keys - {"workloads"}, (group, e)
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            reports = manifest.metrics_of(w, False, bench)
            assert m["moves"] in {r["name"] for r in reports}, (m["name"], w)


@pytest.mark.parametrize("cell", [w["name"] for w in manifest.manifest()["workloads"]])
def test_cell_files_found_by_name(cell):
    bench = manifest.manifest()
    w = manifest.workload(cell, bench)
    assert w["chips"] == 1
    conf = manifest.Config(w["config"])
    assert conf.shapes()
    t = manifest.traffic(w["traffic"])
    assert t["kind"] in ("serve", "train")
    limits = manifest.limits(cell)
    assert limits and all(v > 0 for v in limits.values())
    for trace in (False, True):
        ms = manifest.metrics_of(cell, trace, bench)
        assert ms
        for m in ms:
            assert callable(manifest.metric_reader(m["name"]))
    assert {"setup_s"} < {m["name"] for m in manifest.metrics_of(cell, False, bench)}


def test_config_files_state_their_cuts():
    for c in manifest.manifest()["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]
        assert "assumed" in data and data["source"]


def test_adding_a_cell_edits_no_file(tmp_path):
    """A configuration, a traffic mix, a cell and a metric added as files and
    manifest entries resolve without an edit to any file already there."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    pb = tmp_path / "portbench"
    conf = json.loads((pb / "configs" / "poet-rcnn-ycbv.json").read_text())
    conf["name"] = "dummy-config"
    (pb / "configs" / "dummy-config.json").write_text(json.dumps(conf))
    traffic = json.loads((pb / "traffic" / "track-b16.json").read_text())
    traffic["batch"] = 2
    (pb / "traffic" / "dummy-traffic.json").write_text(json.dumps(traffic))
    (pb / "limits" / "dummy-cell.json").write_text(json.dumps({"pose_R_med": 1.0}))
    (pb / "metrics" / "dummy_metric.py").write_text("def read(run):\n    return None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy-config", "source": "x", "reduced": [],
                             "file": "portbench/configs/dummy-config.json", "why": "x"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy-config",
                               "traffic": "dummy-traffic", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "dummy_metric", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "serving",
                               "moves": "setup_s", "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data, p
    import subprocess
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from portbench.lib import manifest as m;"
            "w = m.workload('dummy-cell'); c = m.Config(w['config']); assert c.shapes();"
            "t = m.traffic(w['traffic']); assert t['batch'] == 2; assert m.limits('dummy-cell');"
            "ms = [x['name'] for x in m.metrics_of('dummy-cell', True)];"
            "assert 'dummy_metric' in ms; m.metric_reader('dummy_metric'); print('ok')")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, cwd=tmp_path)
    assert out.stdout.strip() == "ok", out.stderr


def test_reference_imports_nothing_of_the_program():
    import ast
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            for mod in mods:
                assert mod.split(".")[0] not in ("poet_tpu_torch", "poet_tpu", "jax", "jaxlib",
                                                  "flax"), (path.name, mod)
