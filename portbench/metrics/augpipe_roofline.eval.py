"""The eval input stage's share of its roofline: reading the rows' wire
bytes and writing the float32 planes, no rounds."""

import bounds


def read(ctx):
    if ctx.kind != "eval":
        return None
    grid = ctx.cfg["model"]["dct_blocks"]
    bound = sum(bounds.augpipe_bound_s(b, ctx.batch, grid, 0) for b in ctx.read_bytes)
    return ctx.share(bound, "pb.pipeline")
