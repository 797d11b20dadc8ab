"""Device-idle ms a request while the host is inside an `nms.fixed_point`
span: the card waiting on the NMS loop's reads and launches; traced run."""

from portbench.lib import program_spans


def read(run):
    return program_spans.idle_ms(run, "nms.fixed_point")
