"""Host ms a tick spent collecting its scores once the card had them: the
self time of the program's `tick.collect` spans (the scores copied out of
pinned memory, the latency noted, `on_tick` called), the wait for the card
(`tick.wait`) left out, per `tick` span of the traced ticks."""

from benchmark.metrics._spans import self_ms_per


def read(ctx):
    return self_ms_per(ctx.trace, ("tick.collect",), "tick")
