"""NMS fixed-point iterations a request (the `iterations` count of the
program's `nms.fixed_point` spans; each is one wait for the card); traced
run."""

from portbench.lib import program_spans


def read(run):
    return program_spans.count(run, "nms.fixed_point", "iterations")
