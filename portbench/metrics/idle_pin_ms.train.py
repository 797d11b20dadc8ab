"""Device-idle ms a step while the host is inside `train.pin`; traced run."""

from portbench.lib import program_spans


def read(run):
    return program_spans.idle_ms(run, "train.pin")
