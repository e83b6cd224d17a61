"""upload_ms.serve: device ms per request of the copies of the request's
frames to the device (every stream's): the operations launched inside the
program's 'stage::upload' spans, over the traced 'serve::request' spans
(harness/spans.py)."""

from port_bench.harness import spans


def read(run):
    v = spans.per_request(run, "stage::upload", "device_s")
    return None if v is None else 1e3 * v
