"""idle_share: % of the traced sub-window in which no operation ran on the
device (the union of the trace's kernel, copy and memset intervals)."""


def read(run):
    t = run.timeline
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
