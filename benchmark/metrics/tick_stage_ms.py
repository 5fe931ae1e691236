"""Host ms a tick spent staging it: the self time of the program's
`tick.snapshot` (the four ring snapshots), `tick.mfcc_stage` (the mic's
floored wave into the MFCC program's staging) and `tick.stage` (the ring
snapshots stacked into the tick program's pinned staging), per `tick`
span of the traced ticks."""

from benchmark.metrics._spans import self_ms_per


def read(ctx):
    return self_ms_per(ctx.trace, ("tick.snapshot", "tick.mfcc_stage",
                                   "tick.stage"), "tick")
