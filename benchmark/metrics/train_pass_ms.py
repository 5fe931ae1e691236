"""The trainer's train pass, device milliseconds an epoch: the median over
the timed window's captured epochs of `TrainResult.train_ms` (the
program's CUDA events between its epoch replays)."""

import statistics


def read(ctx):
    ms = ctx.window.get("train_ms")
    return statistics.median(ms) if ms else None
