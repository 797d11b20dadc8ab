"""Mean host ms a step of prepare_batch (the host match and pinned upload)
and the step's call (its enqueue), traced run."""

from portbench.lib import readers


def read(run):
    return readers.host_ms(run)
