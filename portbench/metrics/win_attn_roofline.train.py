"""SwinV2's window attention calls' share of their roofline in the traced
train steps: the least time of every call's forward and backward
(``bounds.window_bound_s``, float32 operands as the port computes them)
over the device time of the kernels launched inside the benchmark's
attention spans."""

import bounds


def read(ctx):
    m = ctx.cfg["model"]
    if ctx.kind != "train" or m["arch"] != "swinv2":
        return None
    per_step = sum(bounds.window_bound_s(*call, False) + bounds.window_bound_s(*call, True)
                   for call in bounds.window_attention_calls(m, ctx.batch))
    return ctx.share(ctx.steps * per_step, "pb.attn.fwd", "pb.attn.bwd")
