"""The ViT attention calls' share of their roofline in the traced eval
batches: forward only."""

import bounds


def read(ctx):
    m = ctx.cfg["model"]
    if ctx.kind != "eval" or m["arch"] == "swinv2":
        return None
    dtype = ctx.cfg["compute_dtype"]
    per_batch = sum(bounds.attention_bound_s(*call, dtype, False)
                    for call in bounds.vit_attention_calls(m, ctx.batch))
    return ctx.share(ctx.steps * per_batch, "pb.attn.fwd")
