"""Device-idle ms a training job in which the card waited on the job's host
work: the idle time under the program's `train` spans, each instant given
to the innermost span, less that under `train.sums` (the host blocked on
the card), per `train.job` span of the traced jobs."""

from benchmark.metrics._spans import idle_ms_per


def read(ctx):
    return idle_ms_per(ctx.trace, "train", ("train.sums",), "train.job")
