"""The FC kernel's roofline share over the traced ticks: each tick's three
module passes at the tick's batch (encoder on x, decoder, encoder on
x_hat), bound from shapes, over the device time of the `fc_` kernels."""

from benchmark.harness import counts
from benchmark.metrics._kernels import FC, share


def read(ctx):
    n = ctx.units.get("ticks")
    if not n:
        return None
    least = n * counts.rapp_fc_cost(ctx.config, ctx.window["batch"])[2]
    return share(ctx.trace, FC, least)
