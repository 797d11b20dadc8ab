"""Host ms a request inside the program's `nms.fixed_point` spans: the NMS
fixed points' loops, one wait for the card an iteration; traced run."""

from portbench.lib import program_spans


def read(run):
    return program_spans.host_ms(run, "nms.fixed_point")
