"""The device trace of a run: `torch.profiler` (CUPTI) over the measured
window, reduced to what the per-layer readers take.

Only the card's activity is traced (CUPTI: kernels, copies, sets and the
runtime calls that launched them); recording every host operator as well
doubled a YOLO request's host time. Ranges: the harness notes the wall
clock (`time.time_ns`, the profiler's clock) at a module's forward
pre-hook and hook, on the module paths the configuration names, and around
each request's enqueue and fetch. A device operation belongs to a span when
the runtime call that launched it (the event with the same correlation id)
lies inside one of the span's ranges: that is the profiler's launch
correlation, which holds while the host runs ahead of the card.

The kernel classes are `poet_tpu_torch/tools/profile_train.py:
KERNEL_CLASSES`, copied so that the yardstick does not move with the
program; the busy time is the union of device intervals, as its
`device_time_by_class` takes it.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# first match wins; the pattern is searched in the device operation's name
KERNEL_CLASSES: Tuple[Tuple[str, str], ...] = (
    ("forward kernel (direct)", r"ms_deform_attn_fwd_kernel"),
    ("forward kernel (slab)", r"ms_deform_attn_fwd_slab_kernel"),
    ("d_value kernel", r"ms_deform_attn_dvalue_kernel"),
    ("d_value kernel (slab)", r"ms_deform_attn_dvalue_slab_kernel"),
    ("d_loc/d_attn kernel", r"ms_deform_attn_dloc_kernel"),
    ("d_loc/d_attn kernel (slab)", r"ms_deform_attn_dloc_slab_kernel<[^,]*GatherRule"),
    ("merged adjoint kernel (atomic)", r"ms_deform_attn_merged_kernel"),
    ("merged adjoint kernel (slab)", r"ms_deform_attn_merged_slab_kernel"),
    ("merged adjoint kernel (banded)", r"ms_deform_attn_merged_banded_kernel"),
    ("dense forward kernel", r"ms_deform_attn_dense_fwd_kernel"),
    ("dense adjoint kernel", r"ms_deform_attn_dense_bwd_kernel"),
    ("dense adjoint kernel (d_loc slab)", r"ms_deform_attn_dloc_slab_kernel<[^,]*OneHotRule"),
    ("v2 forward kernel", r"ms_deform_attn_v2_kernel"),
    ("RoIAlign kernel", r"roi_align_fwd_kernel"),
    ("RoIAlign kernel (tiles)", r"roi_align_tiles_kernel"),
    ("stem kernel", r"conv_stem_fwd_kernel"),
    ("memcpy / memset", r"^Mem(cpy|set)"),
    ("conv (cuDNN)", r"cudnn|conv|fprop|dgrad|wgrad"),
    ("GEMM", r"gemm|xmma|nvjet|cublas"),
    ("multi-tensor (clip, AdamW)", r"multi_tensor_apply"),
    ("LayerNorm / GroupNorm", r"layer_norm|LayerNorm|GammaBeta|group_norm|GroupNorm"),
    ("reductions", r"reduce_kernel"),
    ("elementwise", r"elementwise|fill|where|index|cat|copy"),
)
DEFORM_KERNEL = re.compile(r"ms_deform_attn_\w*kernel")
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_class(name: str) -> str:
    for cls, pattern in KERNEL_CLASSES:
        if re.search(pattern, name):
            return cls
    return "other"


@dataclass
class DeviceOp:
    name: str
    start: float            # seconds on the profiler's clock
    dur: float              # seconds
    kind: str               # kernel | gpu_memcpy | gpu_memset
    launch: Optional[float] = None     # when the host launched it
    spans: Tuple[str, ...] = ()


@dataclass
class Trace:
    ops: List[DeviceOp]
    ranges: Dict[str, List[Tuple[float, float]]]     # span -> sorted (start, end)
    host_ops: List[Tuple[float, float, str]] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[Tuple[float, float]] = []
        for s, e in sorted((o.start, o.start + o.dur) for o in self.ops):
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1] = (merged[-1][0], e)
            else:
                merged.append((s, e))
        return merged

    def busy_s(self) -> float:
        """Seconds of the window with an operation on the device."""
        w0, w1 = self.window
        return sum(min(e, w1) - max(s, w0) for s, e in self.busy_intervals() if e > w0 and s < w1)

    def device_s(self, span: Optional[str] = None, pattern: Optional[str] = None,
                 kind: Optional[str] = None) -> float:
        """Device seconds of the operations launched inside `span` (any if
        None) whose name matches `pattern` and whose activity is `kind`."""
        rx = re.compile(pattern) if pattern else None
        return sum(o.dur for o in self.ops
                   if (span is None or span in o.spans) and (kind is None or o.kind == kind)
                   and (rx is None or rx.search(o.name)))

    def by_class(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for o in self.ops:
            c = kernel_class(o.name)
            out[c] = out.get(c, 0.0) + o.dur
        return out

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The longest gaps with nothing on the device in the window, each
        named by what the host was doing at its middle: the shortest harness
        span open there (the runtime call open there, if any, after it)."""
        busy = [(max(s, self.window[0]), min(e, self.window[1])) for s, e in
                self.busy_intervals() if e > self.window[0] and s < self.window[1]]
        edges = [(self.window[0], self.window[0])] + busy + [(self.window[1], self.window[1])]
        gaps = [(edges[i][1], edges[i + 1][0]) for i in range(len(edges) - 1)
                if edges[i + 1][0] > edges[i][1]]
        gaps.sort(key=lambda g: g[0] - g[1])
        starts = [h[0] for h in self.host_ops]
        out = []
        for s, e in gaps[:top]:
            mid = 0.5 * (s + e)
            best = ("window", float("inf"))
            for name, rs in self.ranges.items():
                i = bisect.bisect_right(rs, (mid, float("inf"))) - 1
                if name != "window" and i >= 0 and rs[i][0] <= mid <= rs[i][1] \
                        and rs[i][1] - rs[i][0] < best[1]:
                    best = (name, rs[i][1] - rs[i][0])
            label = best[0]
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and self.host_ops[i][1] >= mid:
                label += ": " + self.host_ops[i][2]
            out.append((label, e - s))
        return out


RUNTIME = re.compile(r"^(cuda|cu)[A-Z]")


def _activity(e) -> str:
    """kernel | gpu_memcpy | gpu_memset | cuda_runtime | other, from the
    event's own field where the torch build has it, else from its name and
    device (a runtime call may carry the CUDA device type too)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if RUNTIME.match(name):
        return "cuda_runtime"
    if e.device_type().name == "CUDA":
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    return "other"


def collect(prof, ranges: Dict[str, List[Tuple[int, int]]]) -> Trace:
    """Read the profiler's events: device operations with the host time of
    the call that launched them; `ranges` are the harness's spans, {name:
    [(start ns, end ns)]} on the wall clock ("window" the measured one)."""
    launches: Dict[int, float] = {}
    raw_ops, host_ops = [], []
    for e in prof.profiler.kineto_results.events():
        kind = _activity(e)
        if kind in DEVICE_ACTIVITIES:
            raw_ops.append(e)
        elif kind in ("cuda_runtime", "cuda_driver"):
            start = e.start_ns() * 1e-9
            launches[e.correlation_id()] = start
            host_ops.append((start, e.end_ns() * 1e-9, e.name()))
    spans = {k: sorted((s * 1e-9, t * 1e-9) for s, t in v) for k, v in ranges.items() if v}
    ops = []
    for e in raw_ops:
        launch = launches.get(e.correlation_id()) or launches.get(e.linked_correlation_id())
        in_spans = []
        if launch is not None:
            for name, rs in spans.items():
                i = bisect.bisect_right(rs, (launch, float("inf"))) - 1
                if i >= 0 and rs[i][0] <= launch <= rs[i][1]:
                    in_spans.append(name)
        ops.append(DeviceOp(e.name(), e.start_ns() * 1e-9, e.duration_ns() * 1e-9,
                            _activity(e), launch, tuple(in_spans)))
    host_ops.sort()
    if "window" in spans:
        window = spans["window"][0]
    else:
        times = [o.start for o in ops] + [o.start + o.dur for o in ops] + [0.0]
        window = (min(times), max(times))
    return Trace(ops, spans, host_ops, window)
