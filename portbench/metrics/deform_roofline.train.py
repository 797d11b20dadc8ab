"""Share (%) of the deformable core's roofline: the least time of every
forward and adjoint call of the window by its shapes, over the device time
of the ms_deform_attn_* kernels, whatever route ran (portbench/lib/flops.py)."""

from portbench.lib import readers


def read(run):
    return readers.deform_roofline_pct(run)
