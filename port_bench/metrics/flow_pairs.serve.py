"""flow_pairs.serve: frame pairs the flow solves a request, every stream's:
the program's count 'flow.pairs' (utils/profiling.COUNTS, added while the
profiler records, so over the traced sub-window) over the trace's
'serve::request' spans (harness/spans.py)."""

from port_bench.harness import spans


def read(run):
    counts, n = spans.counts(), spans.requests(run)
    if not counts or "flow.pairs" not in counts or not n:
        return None
    return counts["flow.pairs"] / n
