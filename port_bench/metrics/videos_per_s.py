"""videos_per_s: videos served in the window over the window's seconds (one
closed-loop client; the window ends with a whole cycle of the mix)."""


def read(run):
    if not run.done:
        return None
    return run.done / run.window_s
