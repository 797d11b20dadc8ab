"""Host ms a request from the end of the darknet body to the end of the
detector: YOLO's decode, top-k and NMS, the waits for the NMS loop's
per-iteration bool included (the `detect` span)."""

from portbench.lib import readers


def read(run):
    return readers.span_host_ms(run, "detect")
