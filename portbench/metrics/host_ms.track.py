"""Mean host ms inside PoseServer.infer_async a request (its enqueue; in
detector mode the NMS loops' host reads too), traced run."""

from portbench.lib import readers


def read(run):
    return readers.host_ms(run)
