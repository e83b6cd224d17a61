"""k1_ms.serve: device ms per request of K1, the fused flow level: the
kernels launched inside the program's 'kernel::flow_level' spans (every
stream's), over the traced sub-window's 'serve::request' spans
(harness/spans.py)."""

from port_bench.harness import spans


def read(run):
    v = spans.per_request(run, "kernel::flow_level", "device_s")
    return None if v is None else 1e3 * v
