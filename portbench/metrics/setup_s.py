"""Process start to the first timed request or step: imports, the kernels'
build (first run in a checkout), weights on the card, warm-up."""


def read(run):
    return run["setup_s"]
