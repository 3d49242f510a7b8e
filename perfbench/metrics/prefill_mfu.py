"""prefill_mfu (%): the model FLOPs of every prefill call of the window
(``counts.prefill_flops``: products over the active parameters and
attention over the visible pairs) over the window and the card's bf16
peak."""


def read(ctx):
    w = ctx.window
    if "calls" not in w:
        return None
    return 100.0 * w["flops"] / (w["window_s"] * ctx.counts.BF16_FLOPS)
