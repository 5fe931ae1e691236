"""The NAP kernel's roofline share over the traced ticks: one score of the
tick's batch a tick, bound from shapes in the cell's compute type, over
the device time of the `nap_` kernels."""

from benchmark.harness import counts
from benchmark.metrics._kernels import NAP, share


def read(ctx):
    n = ctx.units.get("ticks")
    if not n:
        return None
    w = ctx.window
    dtype = counts.compute_dtype(ctx.config, ctx.traffic)
    return share(ctx.trace, NAP, n * counts.nap_cost(w["batch"], w["k"],
                                                      w["j"], dtype)[2])
