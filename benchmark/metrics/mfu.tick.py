"""The model's share of the card's peak in the cell's compute type over
the timed window: model FLOPs counted from shapes
(`benchmark/harness/counts.py`: NAP scoring three module passes and the
NAP product, BASE scoring two module passes) over the window's seconds and
the type's peak, 67 TFLOP/s for fp32 and 989 for bf16."""

from benchmark.harness import counts


def read(ctx):
    w = ctx.window
    if not w.get("window_s"):
        return None
    dtype = counts.compute_dtype(ctx.config, ctx.traffic)
    return 100.0 * w["model_flops"] / (w["window_s"]
                                       * counts.PEAK_OPS[dtype])
