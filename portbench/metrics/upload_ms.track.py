"""Device ms of host-to-device copies a request, from the trace."""

from portbench.lib import readers


def read(run):
    return readers.upload_ms(run)
