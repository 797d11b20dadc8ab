"""Images of every step whose metrics reached the host in the window over
the window's seconds; the window closes with the last step enqueued in it."""

from portbench.lib import readers


def read(run):
    return readers.images_per_s(run)
