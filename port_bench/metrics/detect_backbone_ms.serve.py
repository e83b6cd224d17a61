"""detect_backbone_ms.serve: device ms per request of the detector's
ResNet + FPN: the operations launched inside the program's
'stage::detect_backbone' spans (detect/densepose.DensePoseRCNN.forward),
over the traced 'serve::request' spans (harness/spans.py); None where the
program opens no such span."""

from port_bench.harness import spans


def read(run):
    v = spans.per_request(run, "stage::detect_backbone", "device_s")
    return None if v is None else 1e3 * v
