"""Device-idle ms a tick in which the card waited on the tick's own host
work: the idle time under the program's `tick` spans and their children,
each instant given to the innermost span, less that under `tick.wait`
(the host blocked on the card); the caller's `run.hook` is no part of it.
Per `tick` span of the traced ticks."""

from benchmark.metrics._spans import idle_ms_per


def read(ctx):
    return idle_ms_per(ctx.trace, "tick", ("tick.wait",), "tick")
