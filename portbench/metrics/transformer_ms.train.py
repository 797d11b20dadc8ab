"""Device ms a step of the transformer's forward and of the backward (see
portbench/lib/readers.py:train_transformer_ms), from the trace."""

from portbench.lib import readers


def read(run):
    return readers.train_transformer_ms(run)
