"""detect_roofline.serve: % of the detector's device time that its counted
bf16 FLOPs need at the chip's bf16 peak: a request's detector FLOPs
(counts/densepose_flops.py on each frame the detector sees, the mean over a
cycle of the mix, which the model plug-in notes as 'detect_flop') over its
device seconds a request (detect_dev_ms.serve)."""

from port_bench.harness import spans


def read(run):
    dev_s = spans.per_request(run, "stage::detect", "device_s")
    flop = run.notes.get("detect_flop")
    if not dev_s or not flop:
        return None
    return 100.0 * flop / run.peaks["bf16_flop_per_s"] / dev_s
