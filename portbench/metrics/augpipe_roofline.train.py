"""The train input stage's share of its roofline: for each traced step the
least time of reading its rows' wire bytes and writing the float32 planes,
with the rounds' arithmetic (``bounds.augpipe_bound_s``), over the device
time of the kernels launched inside the benchmark's pipeline span."""

import bounds


def read(ctx):
    if ctx.kind != "train":
        return None
    m, t = ctx.cfg["model"], ctx.cfg["train"]
    bound = sum(bounds.augpipe_bound_s(b, ctx.batch, m["dct_blocks"], t["num_ops"])
                for b in ctx.read_bytes)
    return ctx.share(bound, "pb.pipeline")
