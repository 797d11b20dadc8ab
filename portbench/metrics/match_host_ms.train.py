"""Host ms a step inside the program's `train.match` span: the host's match
of the batch's queries to its targets in `prepare_batch`; traced run."""

from portbench.lib import program_spans


def read(run):
    return program_spans.host_ms(run, "train.match")
