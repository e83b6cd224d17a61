"""train_clips_per_s: clips trained in the window over the window's seconds,
the window ending on a synchronise."""


def read(run):
    if not run.done or not run.clips_per_step:
        return None
    return run.done * run.clips_per_step / run.window_s
