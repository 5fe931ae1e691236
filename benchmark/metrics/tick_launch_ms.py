"""Host ms a tick spent launching its two replays (the MFCC program's and
the tick program's, with their event records): the self time of the
program's `tick.launch` spans, the staging nested in them left out, per
`tick` span of the traced ticks."""

from benchmark.metrics._spans import self_ms_per


def read(ctx):
    return self_ms_per(ctx.trace, ("tick.launch",), "tick")
