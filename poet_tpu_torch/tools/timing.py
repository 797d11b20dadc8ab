"""Device timing for the probe tools (one CUDA device).

`cuda_ms` times a run of calls between two CUDA events: what a caller pays
per call, host launch overhead included where it exceeds the device work.
`graph_ms` captures the calls into a CUDA graph and times its replays: the
device time per call without the host's launch overhead (the calls must not
synchronize with the host). A kernel wrapper counts no call made while a
stream captures, since nothing launches then; `graph_ms` adds the launches
its replays make to the count of the wrapper it is given. `host_us` times
the host's side of a call alone: what a launch costs the caller's thread.
"""

from __future__ import annotations

import time

import torch


def _events_ms(run, count: int) -> float:
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / count


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """ms per call of `fn`, launched back to back."""
    for _ in range(warmup):
        fn()

    def run():
        for _ in range(iters):
            fn()
    return _events_ms(run, iters)


def graph_ms(fn, iters: int = 20, replays: int = 5, counted=None) -> float:
    """ms per call of `fn` on the device: `iters` calls captured in one CUDA
    graph, replayed `replays` times after one untimed replay. `counted`: the
    kernel wrapper `fn` calls once, whose `launches` gain the replays'."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()

    def run():
        for _ in range(replays):
            graph.replay()
    ms = _events_ms(run, iters * replays)
    if counted is not None:
        counted.launches += iters * (replays + 1)
    return ms


def host_us(fn, calls: int = 10000, run: int = 50, warmup: int = 100) -> float:
    """Mean host microseconds per call of `fn` (time.perf_counter_ns):
    `calls` calls in runs of `run`, each run timed alone, the device
    synchronised between runs outside the timed span so that the launch
    queue never fills and the host never waits for the card."""
    for _ in range(warmup):
        fn()
    total = 0
    for _ in range(max(1, calls // run)):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(run):
            fn()
        total += time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return total / (max(1, calls // run) * run) / 1e3
