"""Host milliseconds a tick: the timed window's mean tick (the host's
interval from the hook's return to the scores' arrival, read by CUDA
events on the idle stream) less the device's busy time a tick in the
traced ticks: what the host adds, staging, launches, the wait for the
scores."""


def read(ctx):
    n = ctx.units.get("ticks")
    if not n or ctx.trace.busy_s <= 0:
        return None
    return ctx.window["tick_mean_ms"] - 1e3 * ctx.trace.busy_s / n
