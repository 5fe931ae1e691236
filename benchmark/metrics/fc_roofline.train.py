"""The FC kernel's roofline share over the traced training job: the
validation pass of every epoch runs the eval-mode forward (encoder,
decoder) through the kernel, in the trainer's batches; bound from shapes,
over the device time of the `fc_` kernels."""

from benchmark.harness import counts
from benchmark.metrics._kernels import FC, share


def read(ctx):
    jobs = ctx.units.get("jobs")
    if not jobs:
        return None
    rows, batch = ctx.window["valid_rows"], ctx.window["batch"]
    per_epoch = sum(counts.forward_fc_cost(ctx.config, min(batch, rows - a))[2]
                    for a in range(0, rows, batch))
    return share(ctx.trace, FC, jobs * int(ctx.config["n_epochs"])
                 * per_epoch)
