"""The program-span readers' arithmetic (`portbench/lib/program_spans.py`) on
a synthetic run record: spans clipped to the window, the device's idle time
intersected with a span's, division by the run's requests or steps, the
idle split by innermost span adding up to the window's idle time, and
nothing read from a program without the recorder."""

from __future__ import annotations

import importlib
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.lib import manifest, program_spans, readers  # noqa: E402
from portbench.lib.trace import DeviceOp, Trace  # noqa: E402

NS = 1_000_000_000


def _span(name, start, end, parent=None, **counts):
    return {"name": name, "start_ns": int(start * NS), "end_ns": int(end * NS),
            "parent": parent, "unit": 0, "counts": counts}


def _run(spans, units=2, kind="requests"):
    # window 10..20 s; the device busy 10-12, 13-15 and 16-19.5 s
    ops = [DeviceOp("k", 10.0, 2.0, "kernel"), DeviceOp("k", 13.0, 1.0, "kernel"),
           DeviceOp("k", 13.5, 1.5, "kernel"), DeviceOp("k", 16.0, 3.5, "kernel")]
    return {kind: [None] * units, "program_spans": spans,
            "trace": Trace(ops, {}, [], (10.0, 20.0))}


SPANS = [
    _span("serve.request", 9.0, 12.5),                    # 0: clipped to 10..12.5
    _span("serve.upload", 9.0, 10.5, parent=0, bytes=8),
    _span("nms.fixed_point", 11.5, 12.5, parent=0, iterations=3),
    _span("serve.request", 12.5, 16.5),                   # 3
    _span("nms.fixed_point", 14.5, 16.5, parent=3, iterations=4),
    _span("serve.fetch", 19.0, 21.0),                     # clipped to 19..20
    _span("nms.fixed_point", 20.5, 21.0, iterations=50),  # outside the window
]


def test_host_ms_clips_to_the_window_and_divides_by_units():
    run = _run(SPANS)
    assert program_spans.host_ms(run, "serve.request") == pytest.approx(1e3 * (2.5 + 4.0) / 2)
    assert program_spans.host_ms(run, "serve.upload") == pytest.approx(1e3 * 0.5 / 2)
    assert program_spans.host_ms(run, "serve.fetch") == pytest.approx(1e3 * 1.0 / 2)
    assert program_spans.host_ms(_run(SPANS, units=4, kind="steps"), "nms.fixed_point") \
        == pytest.approx(1e3 * (1.0 + 2.0) / 4)
    assert program_spans.host_ms(run, "train.pin") is None


def test_counts_of_spans_starting_in_the_window():
    assert program_spans.count(_run(SPANS), "nms.fixed_point", "iterations") == 3.5
    assert program_spans.count(_run(SPANS), "serve.upload", "bytes") is None


def test_idle_intersection():
    run = _run(SPANS)
    # idle: 12-13, 15-16, 19.5-20
    assert program_spans.idle_intervals(run) == [(12.0, 13.0), (15.0, 16.0), (19.5, 20.0)]
    # nms 11.5-12.5 and 14.5-16.5: idle 12-12.5 and 15-16
    assert program_spans.idle_ms(run, "nms.fixed_point") == pytest.approx(1e3 * 1.5 / 2)
    assert program_spans.idle_ms(run, "serve.fetch") == pytest.approx(1e3 * 0.5 / 2)
    assert program_spans.idle_ms(run, "serve.upload") == 0.0


def test_idle_split_adds_up_to_the_idle_time():
    run = _run(SPANS)
    split = program_spans.idle_split(run)
    # request 0 owns 10.5-11.5 (busy); request 3 owns 12.5-14.5: idle 12.5-13
    assert split == pytest.approx({"serve.request": 0.5, "serve.upload": 0.0,
                                   "nms.fixed_point": 1.5, "serve.fetch": 0.5,
                                   "outside": 0.0})
    total = 100.0 - readers.idle_pct(run)
    assert sum(split.values()) == pytest.approx(10.0 * (1.0 - total / 100.0))


def test_interval_helpers():
    assert program_spans.union([(3, 4), (1, 2), (1.5, 3)]) == [(1, 4)]
    assert program_spans.subtract([(0, 10)], [(1, 2), (4, 5), (9, 12)]) == \
        [(0, 1), (2, 4), (5, 9)]
    assert program_spans.subtract([(0, 2), (3, 6)], [(1, 4)]) == [(0, 1), (4, 6)]
    assert program_spans.intersect([(0, 2), (3, 6)], [(1, 4), (5, 7)]) == \
        [(1, 2), (3, 4), (5, 6)]


def test_nothing_without_the_recorder_or_the_trace():
    run = _run(None)
    assert program_spans.host_ms(run, "serve.upload") is None
    assert program_spans.idle_ms(run, "nms.fixed_point") is None
    assert program_spans.count(run, "nms.fixed_point", "iterations") is None
    assert program_spans.idle_split(run) is None
    assert program_spans.records({"requests": [None]}) is None


def test_records_read_the_recorder_once():
    tracing = importlib.import_module("poet_tpu_torch.utils.tracing")
    run = _run(None)
    del run["program_spans"]
    tracing.clear()
    assert program_spans.records(run) == [] and run["program_spans"] == []


@pytest.mark.parametrize("metric", [m["name"] for m in manifest.manifest()["per_layer"]
                                    if m["source"] in ("program_span", "program_counter")
                                    and m["name"] not in ("host_ms.detect", "host_ms.train",
                                                          "decode_nms_ms.detect")])
def test_each_metric_reads_its_span(metric):
    """Every reader of the program's spans gives a number on a run that
    holds its span, and nothing on one without the recorder."""
    name = {"upload_host_ms": "serve.upload", "nms_host_ms": "nms.fixed_point",
            "nms_iters": "nms.fixed_point", "idle_nms_ms": "nms.fixed_point",
            "idle_body_ms": "backbone.body", "match_host_ms": "train.match",
            "pin_host_ms": "train.pin", "step_host_ms": "train.step",
            "idle_pin_ms": "train.pin", "idle_match_ms": "train.match"}[metric.split(".")[0]]
    read = manifest.metric_reader(metric)
    value = read(_run([_span(name, 11.0, 13.5, iterations=2)]))
    assert isinstance(value, float) and value > 0
    assert read(_run(None)) is None
