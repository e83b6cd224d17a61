"""bwd_ms.train: device ms per step of the kernels launched by autograd's
engine or under 'train::backward' (the backward and remat's recompute)."""


def read(run):
    t = run.timeline
    if t is None or not run.trace_steps or "backward" not in t.phases:
        return None
    return 1e3 * t.phases["backward"] / run.trace_steps
