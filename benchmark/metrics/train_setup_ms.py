"""Host ms a training job spent setting up: the self time of the program's
`train.setup` spans (the windows to the device, the optimizer, a restore,
the best snapshot and the epoch programs' pinned staging, graph pool and
fixed buffers), per `train.job` span of the traced jobs."""

from benchmark.metrics._spans import self_ms_per


def read(ctx):
    return self_ms_per(ctx.trace, ("train.setup",), "train.job")
