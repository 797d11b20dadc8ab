"""What the metric readers (`portbench/metrics/<name>.py`) compute, from a
run record (`portbench/lib/driver.py`). Each returns None where the run has
nothing to read: the harness then leaves the metric out of the line."""

from __future__ import annotations

import numpy as np

from portbench.lib.flops import PEAK_BF16, deform_bound_s
from portbench.lib.trace import DEFORM_KERNEL


def _units(run):
    """(the trace, the number of requests or steps of the window)."""
    n = len(run.get("requests") or run.get("steps") or [])
    return run.get("trace"), n


def images_per_s(run):
    if not run.get("images") or run["window_s"] <= 0:
        return None
    return run["images"] / run["window_s"]


def latency_p95_ms(run):
    """95th percentile of due -> answered on the host, every request."""
    if not run.get("requests"):
        return None
    lat = [done - due for _, due, _, done in run["requests"]]
    return float(np.percentile(np.asarray(lat) * 1e3, 95))


def host_ms(run):
    """Mean host ms of the enqueue calls (`infer_async`; a step's
    `prepare_batch` and call)."""
    h = run.get("host_s")
    return 1e3 * sum(h) / len(h) if h else None


def upload_ms(run):
    tr, n = _units(run)
    if tr is None or not n:
        return None
    s = tr.device_s(kind="gpu_memcpy", pattern="HtoD")
    return 1e3 * s / n if s > 0 else None


def span_device_ms(run, span):
    tr, n = _units(run)
    if tr is None or not n or span not in tr.ranges:
        return None
    s = tr.device_s(span=span)
    return 1e3 * s / n if s > 0 else None


def span_host_ms(run, span):
    d = run.get("spans_host", {}).get(span)
    return 1e3 * sum(d) / len(d) if d else None


def deform_roofline_pct(run):
    tr = run.get("trace")
    if tr is None or not run.get("deform_calls"):
        return None
    t = tr.device_s(pattern=DEFORM_KERNEL.pattern)
    if t <= 0:
        return None
    return 100.0 * sum(deform_bound_s(c) for c in run["deform_calls"]) / t


def idle_pct(run):
    tr = run.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def mfu_pct(run):
    tr = run.get("trace")
    if tr is None or tr.window_s <= 0 or not run["images"]:
        return None
    return 100.0 * run["flops_per_image"] * run["images"] / (tr.window_s * PEAK_BF16)


def train_transformer_ms(run):
    """Device ms a step of the transformer's forward and of the backward
    (the step's work from the end of the model's forward to the end of its
    call, less the optimizer's multi-tensor kernels: the transformer's
    backward and the small backward of the input projections and heads)."""
    tr, n = _units(run)
    if tr is None or not n or "transformer" not in tr.ranges:
        return None
    s = (tr.device_s(span="transformer") + tr.device_s(span="backward")
         - tr.device_s(span="backward", pattern=OPTIMIZER_KERNEL))
    return 1e3 * s / n if s > 0 else None


OPTIMIZER_KERNEL = "multi_tensor_apply"


def optimizer_ms(run):
    """Device ms a step of the clip's and AdamW's multi-tensor kernels."""
    tr, n = _units(run)
    if tr is None or not n:
        return None
    s = tr.device_s(pattern=OPTIMIZER_KERNEL)
    return 1e3 * s / n if s > 0 else None
