"""setup_s: seconds from the process's start to the first timed request or
step: imports, the kernels' build or load, weights, traffic, warm-up."""


def read(run):
    return run.setup_s
