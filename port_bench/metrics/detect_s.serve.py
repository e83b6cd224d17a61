"""detect_s.serve: seconds of the 'detect' stage per request, from the
program's StageTimer (synchronised at the stage's ends) in the traced run's
pass of one cycle of the mix."""


def read(run):
    if not run.stages:
        return None
    return sum(s.get("detect", 0.0) for s in run.stages) / len(run.stages)
