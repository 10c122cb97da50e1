"""Share of the card's product peak that the eval batches' forward work
reaches over the traced window."""


def read(ctx):
    if ctx.kind != "eval":
        return None
    return 100.0 * ctx.flops_per_image * ctx.images / ctx.trace.window_s / ctx.peak
