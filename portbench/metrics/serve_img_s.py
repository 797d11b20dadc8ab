"""Images of every request answered in the window over the window's seconds;
the window closes when the last request sent in it is answered."""

from portbench.lib import readers


def read(run):
    return readers.images_per_s(run)
