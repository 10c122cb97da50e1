"""Share of the traced train window in which nothing ran on the card."""


def read(ctx):
    if ctx.kind != "train":
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
