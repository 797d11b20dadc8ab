"""Console metric logging: smoothed meters + periodic status lines.
Counterpart of `poet_tpu/engine/metrics.py`.

Parity target: the reference's util/misc.py:66-285 (SmoothedValue /
MetricLogger). The cross-process sum goes through `torch.distributed` when a
process group with more than one rank is initialized (a no-op otherwise).
The peak-memory field is `torch.cuda.max_memory_allocated` on a CUDA device,
as the reference prints it, and is left out otherwise, as JAX's
`_device_peak_mem_mb` leaves it out where the backend reports none.
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Iterable

import numpy as np


def _device_peak_mem_mb(device=None):
    """Peak CUDA memory allocated by this process in MB on `device` (None:
    the current CUDA device), or None when `device` is not a CUDA device or
    there is no card."""
    import torch

    if not torch.cuda.is_available() or (device is not None
                                         and torch.device(device).type != "cuda"):
        return None
    return torch.cuda.max_memory_allocated(device) / (1024 * 1024)


class SmoothedValue:
    """Windowed median/avg meter. Parity: util/misc.py:66-125."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    def synchronize_between_processes(self):
        """Sum count/total across processes (only with a process group of
        more than one rank)."""
        import torch
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            return
        t = torch.tensor([self.count, self.total], dtype=torch.float64)
        dist.all_reduce(t)
        self.count = int(t[0].item())
        self.total = float(t[1].item())

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


class MetricLogger:
    """Parity: util/misc.py:198-285 (ETA, iter/data time, smoothed meters).
    `device`: where the peak memory is read (a CUDA device; None: the current
    one when there is a card)."""

    def __init__(self, delimiter: str = "  ", device=None):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.device = device

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def synchronize_between_processes(self):
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def __str__(self):
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        i = 0
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)  # type: ignore[arg-type]
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total is not None and i == total - 1):
                mem = _device_peak_mem_mb(self.device)
                mem_s = f" max mem: {mem:.0f}MB" if mem is not None else ""
                if total:
                    eta = str(datetime.timedelta(seconds=int(iter_time.global_avg * (total - i))))
                    print(f"{header} [{i}/{total}] eta: {eta} {self} "
                          f"time: {iter_time} data: {data_time}{mem_s}")
                else:
                    print(f"{header} [{i}] {self} time: {iter_time} "
                          f"data: {data_time}{mem_s}")
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        print(f"{header} Total time: {datetime.timedelta(seconds=int(total_time))} "
              f"({total_time / max(i, 1):.4f} s / it)")
