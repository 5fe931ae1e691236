"""The kernels' names as the card's trace shows them (the port's hand
written CUDA kernels, `csrc/fused_mlp.cu` and `csrc/nap_score.cu`), and the
roofline share the kernel metrics report: the least time their launches
could take, from shapes, over the time the trace shows them running."""

import re

FC = re.compile(r"fc_(module|simt|wgmma)_kernel").search
NAP = re.compile(r"nap_(center|simt|wgmma|reduce|small)_kernel").search


def share(trace, matches, least_s):
    """The roofline share in %, or None where the trace shows no launch of
    the kernel (a share of nothing is not 0)."""
    seconds, hits = trace.kernel_seconds(matches)
    if hits == 0 or seconds <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / seconds
