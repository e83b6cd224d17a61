"""flow_glue_ms.serve: device ms per request of the flow stage's own work
outside the port's kernels (the pyramid's blur and resizes, the upsampling,
the encoding): the operations launched inside 'stage::flow' spans and
inside no 'kernel::' span, over the traced 'serve::request' spans
(harness/spans.py)."""

from port_bench.harness import spans


def read(run):
    flow = spans.per_request(run, "stage::flow", "device_s")
    if flow is None:
        return None
    return 1e3 * (flow - spans.per_request(run, "stage::flow", "kernel_s"))
