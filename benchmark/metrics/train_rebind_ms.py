"""Host ms a training job spent rebinding captured epoch programs that an
earlier job of the same shapes left it (its initial weights, Adam's reset
and its windows into the graphs' tensors): the self time of the program's
`train.rebind` span, per `train.job` span of the traced jobs.  A job that
captures its own programs records none."""

from benchmark.metrics._spans import self_ms_per


def read(ctx):
    return self_ms_per(ctx.trace, ("train.rebind",), "train.job")
