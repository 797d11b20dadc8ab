"""Share (%) of the traced window with no kernel, copy or set on the device."""

from portbench.lib import readers


def read(run):
    return readers.idle_pct(run)
