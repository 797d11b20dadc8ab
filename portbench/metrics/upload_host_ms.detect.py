"""Host ms a request inside the program's `serve.upload` span: PoseServer
copying the request's images to the card from pageable memory, the host's
side of `upload_ms.detect`; traced run."""

from portbench.lib import program_spans


def read(run):
    return program_spans.host_ms(run, "serve.upload")
