"""Share of the card's product peak (the configuration's compute dtype) that
a train step's work reaches over the traced window: 3 x the reference's
forward FLOPs an image x the images trained, over the window, over the
peak."""


def read(ctx):
    if ctx.kind != "train":
        return None
    return 100.0 * 3.0 * ctx.flops_per_image * ctx.images / ctx.trace.window_s / ctx.peak
