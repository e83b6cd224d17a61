"""fwd_ms.train: device ms per step of the kernels launched under the
train step's 'train::forward' range (trace.py's phase attribution)."""


def read(run):
    t = run.timeline
    if t is None or not run.trace_steps or "forward" not in t.phases:
        return None
    return 1e3 * t.phases["forward"] / run.trace_steps
