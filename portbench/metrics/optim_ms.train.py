"""Device ms a step of the gradient clip's and AdamW's multi-tensor kernels."""

from portbench.lib import readers


def read(run):
    return readers.optimizer_ms(run)
