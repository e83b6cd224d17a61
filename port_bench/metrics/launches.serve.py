"""launches.serve: device operations (kernels, copies, memsets) a request
queues: those launched inside the program's 'serve::request' spans, over
their count in the traced sub-window (harness/spans.py)."""

from port_bench.harness import spans


def read(run):
    return spans.per_request(run, "serve::request", "launches")
