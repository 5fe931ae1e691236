"""Device milliseconds a tick: the card's busy time over the traced ticks
(every kernel and copy, their union), per tick."""


def read(ctx):
    n = ctx.units.get("ticks")
    if not n or ctx.trace.busy_s <= 0:
        return None
    return 1e3 * ctx.trace.busy_s / n
