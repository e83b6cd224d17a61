"""detect_launches.serve: device operations (kernels, copies, memsets) the
detector queues a request: those launched inside the program's
'stage::detect' spans, over the traced 'serve::request' spans
(harness/spans.py)."""

from port_bench.harness import spans


def read(run):
    return spans.per_request(run, "stage::detect", "launches")
