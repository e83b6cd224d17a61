"""detect_max_s.serve: the largest 'detect' stage of one request, in
seconds, from the program's StageTimer (synchronised at the stage's ends)
in the traced run's pass of one cycle of the mix: a stall of the detector
alone in one request, which the mean (``detect_s.serve``) spreads over the
cycle."""


def read(run):
    times = [s["detect"] for s in run.stages if "detect" in s]
    return max(times) if times else None
