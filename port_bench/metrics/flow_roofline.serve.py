"""flow_roofline.serve: % of the flow stage's time that the flow's counted
float32 operations need at the chip's float32 peak (counts/flow_ops.py: the
distinct moving frame pairs of each request, 7 outers x 30 sweeps on every
level; counts/peaks.json). The operations bound the flow: its bytes need a
hundredth of the time."""


def read(run):
    if not run.stages or not run.stage_work:
        return None
    need = sum(w[1] for w in run.stage_work) / run.peaks["f32_op_per_s"]
    spent = sum(s.get("flow", 0.0) for s in run.stages)
    return 100.0 * need / spent if spent > 0 and need > 0 else None
