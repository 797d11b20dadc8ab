"""Device ms a request of the operations launched inside the pose
transformer's forward (the `transformer` span), from the trace."""

from portbench.lib import readers


def read(run):
    return readers.span_device_ms(run, "transformer")
