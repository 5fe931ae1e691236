"""The model's share of the card's fp32 peak over the timed window: model
FLOPs counted from shapes (`benchmark/harness/counts.py`: NAP scoring
three module passes and the NAP product, BASE scoring two module passes,
training 6 a parameter and window plus the validation forward) over the
window's seconds and 67 TFLOP/s."""

from benchmark.harness import counts


def read(ctx):
    w = ctx.window
    if not w.get("window_s"):
        return None
    return 100.0 * w["model_flops"] / (w["window_s"]
                                       * counts.PEAK_OPS["float32"])
