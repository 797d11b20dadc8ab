"""Host ms a step inside the program's `train.step` span: the step's call,
the launches of its forward, backward and optimizer; traced run."""

from portbench.lib import program_spans


def read(run):
    return program_spans.host_ms(run, "train.step")
