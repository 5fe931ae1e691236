"""The NAP kernel's roofline share over the traced passes of the test set:
one score of each chunk's rows, bound from shapes, over the device time of
the `nap_` kernels."""

from benchmark.harness import counts
from benchmark.metrics._kernels import NAP, share


def read(ctx):
    n = ctx.units.get("passes")
    if not n:
        return None
    w = ctx.window
    least = n * sum(counts.nap_cost(rows, w["k"], w["j"])[2]
                    for rows in w["chunk_rows"])
    return share(ctx.trace, NAP, least)
