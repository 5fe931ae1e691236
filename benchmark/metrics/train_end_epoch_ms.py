"""Host ms a training job spent between an epoch's sums and the next
launch, summed over the job's epochs: the self time of the program's
`train.end_epoch` spans (histories, the best snapshot's clones, the
progress line, a checkpoint), per `train.job` span of the traced jobs."""

from benchmark.metrics._spans import self_ms_per


def read(ctx):
    return self_ms_per(ctx.trace, ("train.end_epoch",), "train.job")
