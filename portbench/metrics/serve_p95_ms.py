"""95th percentile over every request of the window of the ms from when it
was due to the end of the fetch that brings its poses to the host."""

from portbench.lib import readers


def read(run):
    return readers.latency_p95_ms(run)
