"""The ViT attention calls' share of their roofline in the traced train
steps: the least time of every call's forward and backward (``bounds.
attention_bound_s`` at the configuration's shapes and compute dtype) over the
device time of the kernels launched inside the benchmark's attention spans,
forward and backward."""

import bounds


def read(ctx):
    m = ctx.cfg["model"]
    if ctx.kind != "train" or m["arch"] == "swinv2":
        return None
    dtype = ctx.cfg["compute_dtype"]
    per_step = sum(bounds.attention_bound_s(*call, dtype, False)
                   + bounds.attention_bound_s(*call, dtype, True)
                   for call in bounds.vit_attention_calls(m, ctx.batch))
    return ctx.share(ctx.steps * per_step, "pb.attn.fwd", "pb.attn.bwd")
