"""detect_dev_ms.serve: device ms per request of the detector: the
operations launched inside the program's 'stage::detect' spans, over the
traced 'serve::request' spans (harness/spans.py). Beside detect_s.serve,
which the StageTimer reads synchronised on the host."""

from port_bench.harness import spans


def read(run):
    v = spans.per_request(run, "stage::detect", "device_s")
    return None if v is None else 1e3 * v
