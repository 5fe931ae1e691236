"""Device milliseconds of a full chunk of the test set in the timed
window: the median of CUDA events recorded around each full-size chunk's
`score_nap_windows_with_loss`."""


def read(ctx):
    return ctx.window.get("chunk_ms_full")
