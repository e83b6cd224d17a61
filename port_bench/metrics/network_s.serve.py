"""network_s.serve: seconds of the 'network' stage per request, summed over the
streams, from the program's StageTimer (synchronised at the stage's ends) in
the traced run's pass of one cycle of the mix."""


def read(run):
    if not run.stages:
        return None
    return sum(s.get("network", 0.0) for s in run.stages) / len(run.stages)
