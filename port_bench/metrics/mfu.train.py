"""mfu.train: % of the bf16 peak that the window's steps reach, counting 3 x
the forward FLOPs of each step's batch (counts/flops.py; the recompute of
remat is not counted)."""


def read(run):
    if not run.work or not run.done:
        return None
    need = sum(f for f, _ in run.work) / run.peaks["bf16_flop_per_s"]
    return 100.0 * need / run.window_s
