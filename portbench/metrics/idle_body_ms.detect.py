"""Device-idle ms a request while the host is inside `backbone.body`,
launching the darknet body's kernels; traced run."""

from portbench.lib import program_spans


def read(run):
    return program_spans.idle_ms(run, "backbone.body")
