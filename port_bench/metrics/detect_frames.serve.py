"""detect_frames.serve: frames the detector runs on a request: the
program's count 'detect.frames' (pipeline/online.DensePoseOnlineDetector,
utils/profiling.COUNTS, added while the profiler records, so over the traced
sub-window) over the trace's 'serve::request' spans (harness/spans.py);
None where the program keeps no such count."""

from port_bench.harness import spans


def read(run):
    counts, n = spans.counts(), spans.requests(run)
    if not counts or "detect.frames" not in counts or not n:
        return None
    return counts["detect.frames"] / n
