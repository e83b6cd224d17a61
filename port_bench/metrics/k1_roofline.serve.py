"""k1_roofline.serve: % of K1's device time that the flow's counted float32
operations need at the chip's float32 peak: a request's operations as
flow_roofline.serve counts them (counts/flow_ops.py: the distinct moving
frame pairs, 7 outers x 30 sweeps on every level; the mean over the traced
run's cycle of the mix, ``stage_work``, which is each request's own where
the mix has one length), over K1's device seconds a request (k1_ms.serve)."""

from port_bench.harness import spans


def read(run):
    k1_s = spans.per_request(run, "kernel::flow_level", "device_s")
    if not k1_s or not run.stage_work:
        return None
    need = sum(w[1] for w in run.stage_work) / len(run.stage_work) / run.peaks["f32_op_per_s"]
    return 100.0 * need / k1_s if need > 0 else None
