"""The trainer's validation pass, device milliseconds an epoch: the median
over the timed window's captured epochs of `TrainResult.eval_ms`."""

import statistics


def read(ctx):
    ms = ctx.window.get("eval_ms")
    return statistics.median(ms) if ms else None
