"""The program's own spans in a traced run: what `poet_tpu_torch/utils/
tracing.py` recorded while the run's profiler was on (`recorded()`, read
once after the run), clipped to the trace's window and laid over the
device's idle time, per request or step as `readers.py` divides.

A span's idle time is the window's device-idle intervals (the complement
of `Trace.busy_intervals()`) intersected with the span's intervals. A
program without the recorder (an older commit) has nothing to read: every
reader returns None and the harness leaves the metric out."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

Interval = Tuple[float, float]


def records(run) -> Optional[List[dict]]:
    """The program's span records of a traced run (cached in the run
    record), or None without a trace or without the recorder."""
    if run.get("trace") is None:
        return None
    if "program_spans" not in run:
        try:
            from poet_tpu_torch.utils import tracing
        except ImportError:
            run["program_spans"] = None
        else:
            run["program_spans"] = tracing.recorded()
    return run["program_spans"]


def _units(run) -> int:
    return len(run.get("requests") or run.get("steps") or [])


def clipped(run, name: Optional[str] = None) -> Optional[List[Tuple[dict, Interval]]]:
    """(record, (start s, end s) clipped to the window) of each closed span
    of `name` (every span if None) that overlaps the window."""
    recs = records(run)
    if recs is None:
        return None
    w0, w1 = run["trace"].window
    out = []
    for r in recs:
        if r["end_ns"] is None or (name is not None and r["name"] != name):
            continue
        s, e = max(r["start_ns"] * 1e-9, w0), min(r["end_ns"] * 1e-9, w1)
        if e > s:
            out.append((r, (s, e)))
    return out


def union(intervals: List[Interval]) -> List[Interval]:
    merged: List[Interval] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(e, merged[-1][1]))
        else:
            merged.append((s, e))
    return merged


def intersect(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """The intersection of two interval sets (each merged first)."""
    a, b = union(a), union(b)
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """a less b."""
    a, b = union(a), union(b)
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if e > s:
            out.append((s, e))
    return out


def length(intervals: List[Interval]) -> float:
    return sum(e - s for s, e in union(intervals))


def idle_intervals(run) -> List[Interval]:
    """The window's intervals with nothing on the device (cached in the run
    record)."""
    if "program_idle" not in run:
        tr = run["trace"]
        run["program_idle"] = subtract([tr.window], tr.busy_intervals())
    return run["program_idle"]


def host_ms(run, name: str) -> Optional[float]:
    """Host ms a request or step inside the spans of `name`."""
    spans, n = clipped(run, name), _units(run)
    if not spans or not n:
        return None
    return 1e3 * length([iv for _, iv in spans]) / n


def count(run, name: str, key: str) -> Optional[float]:
    """The sum of count `key` over the spans of `name` that start in the
    window, a request or step."""
    recs, n = records(run), _units(run)
    if not recs or not n:
        return None
    w0, w1 = run["trace"].window
    vals = [r["counts"].get(key, 0) for r in recs
            if r["name"] == name and w0 <= r["start_ns"] * 1e-9 <= w1]
    return sum(vals) / n if vals else None


def idle_ms(run, name: str) -> Optional[float]:
    """Device-idle ms a request or step while the host is inside a span of
    `name`."""
    spans, n = clipped(run, name), _units(run)
    if not spans or not n:
        return None
    return 1e3 * length(intersect(idle_intervals(run), [iv for _, iv in spans])) / n


def idle_split(run) -> Optional[Dict[str, float]]:
    """The window's device-idle seconds split by the innermost program span
    open on the host ("outside" where none is): each span owns its interval
    less its children's. The parts add up to the window's idle time (spans
    of one thread nest, so the owned pieces do not overlap)."""
    spans = clipped(run)
    if spans is None:
        return None
    index = {id(r): i for i, r in enumerate(run["program_spans"])}
    children: Dict[int, List[Interval]] = {}
    for r, iv in spans:
        if r["parent"] is not None:
            children.setdefault(r["parent"], []).append(iv)
    pieces = sorted((s, e, r["name"]) for r, iv in spans
                    for s, e in subtract([iv], children.get(index[id(r)], [])))
    idle = idle_intervals(run)
    out: Dict[str, float] = {r["name"]: 0.0 for r, _ in spans}
    i = j = 0
    while i < len(pieces) and j < len(idle):
        s, e = max(pieces[i][0], idle[j][0]), min(pieces[i][1], idle[j][1])
        if e > s:
            out[pieces[i][2]] += e - s
        if pieces[i][1] < idle[j][1]:
            i += 1
        else:
            j += 1
    out["outside"] = length(subtract(idle, [iv for _, iv in spans]))
    return out
