"""request_p90_s: the 90th percentile of every window request's seconds, from
the call to its probabilities on the host (statistics.quantiles, inclusive)."""

import statistics


def read(run):
    if len(run.latencies) < 10:
        return None
    return statistics.quantiles(run.latencies, n=10, method="inclusive")[8]
