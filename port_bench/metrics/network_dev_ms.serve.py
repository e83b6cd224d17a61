"""network_dev_ms.serve: device ms per request of the network (every
stream's): the operations launched inside the program's 'stage::network'
spans, over the traced 'serve::request' spans (harness/spans.py). Beside
network_s.serve, which the StageTimer reads synchronised on the host."""

from port_bench.harness import spans


def read(run):
    v = spans.per_request(run, "stage::network", "device_s")
    return None if v is None else 1e3 * v
