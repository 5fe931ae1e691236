"""The FC kernel's roofline share over the traced passes of the test set:
each chunk's three module passes (encoder on x, decoder, encoder on x_hat)
at its rows, bound from shapes, over the device time of the `fc_`
kernels."""

from benchmark.harness import counts
from benchmark.metrics._kernels import FC, share


def read(ctx):
    n = ctx.units.get("passes")
    if not n:
        return None
    least = n * sum(counts.rapp_fc_cost(ctx.config, rows)[2]
                    for rows in ctx.window["chunk_rows"])
    return share(ctx.trace, FC, least)
