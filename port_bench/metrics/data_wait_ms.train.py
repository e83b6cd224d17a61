"""data_wait_ms.train: host ms per train step that the step waits for its
batch: the program's 'data::wait' spans (data/pipeline.prefetch_to_device's
consumer) over the traced steps (harness/spans.py)."""

from port_bench.harness import spans


def read(run):
    s = spans.of(run)
    if not s or "data::wait" not in s or not run.trace_steps:
        return None
    return 1e3 * s["data::wait"]["host_s"] / run.trace_steps
