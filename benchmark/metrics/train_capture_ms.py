"""Host ms a training job spent capturing its two epoch programs as CUDA
graphs: the self time of the program's `train.capture` span, per
`train.job` span of the traced jobs."""

from benchmark.metrics._spans import self_ms_per


def read(ctx):
    return self_ms_per(ctx.trace, ("train.capture",), "train.job")
