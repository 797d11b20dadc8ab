"""Device ms a request of the operations launched inside the backbone's
forward (the configuration's `backbone` span), from the trace."""

from portbench.lib import readers


def read(run):
    return readers.span_device_ms(run, "backbone")
