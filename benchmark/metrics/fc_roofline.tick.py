"""The FC kernel's roofline share over the traced ticks: each tick's module
passes at the tick's batch, three with NAP (encoder on x, decoder, encoder
on x_hat) and two with BASE (encoder, decoder), bound from shapes in the
cell's compute type, over the device time of the `fc_` kernels."""

from benchmark.harness import counts
from benchmark.metrics._kernels import FC, share


def read(ctx):
    n = ctx.units.get("ticks")
    if not n:
        return None
    w = ctx.window
    cost = counts.rapp_fc_cost if w["nap"] else counts.forward_fc_cost
    dtype = counts.compute_dtype(ctx.config, ctx.traffic)
    return share(ctx.trace, FC, n * cost(ctx.config, w["batch"], dtype)[2])
