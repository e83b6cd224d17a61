"""mfu.serve: % of the window that the window's counted work needs at the
chip's peaks: each request's network FLOPs (counts/flops.py, every clip of
every stream) at the bf16 peak, plus its flow's operations
(counts/flow_ops.py) at the float32 peak."""


def read(run):
    if not run.work or not run.done:
        return None
    need = sum(f / run.peaks["bf16_flop_per_s"] + o / run.peaks["f32_op_per_s"]
               for f, o in run.work)
    return 100.0 * need / run.window_s
