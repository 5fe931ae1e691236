"""The share of the traced window in which the card ran nothing: one minus
the device's busy time (the union of its kernels, copies and sets) over
the window's length, both from the same trace of passes."""


def read(ctx):
    if not ctx.units.get("passes") or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
