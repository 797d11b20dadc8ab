"""Host ms a step inside the program's `train.pin` span: page-locking the
batch's arrays before their copies; traced run."""

from portbench.lib import program_spans


def read(run):
    return program_spans.host_ms(run, "train.pin")
