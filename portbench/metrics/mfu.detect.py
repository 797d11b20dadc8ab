"""The model's FLOPs for every image of the traced window (from the
configuration's shapes) over its seconds and the bf16 dense peak (%)."""

from portbench.lib import readers


def read(run):
    return readers.mfu_pct(run)
