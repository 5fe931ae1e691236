"""Host ms a training job spent issuing its first epoch, which runs eagerly
as the epoch programs' warm-up: the self time of the program's
`train.eager_epoch` span, per `train.job` span of the traced jobs."""

from benchmark.metrics._spans import self_ms_per


def read(ctx):
    return self_ms_per(ctx.trace, ("train.eager_epoch",), "train.job")
