"""Device time a traced SwinV2 train step spends in window attention: the
kernels launched inside the benchmark's attention spans (``pb.attn.fwd``
around each call, ``pb.attn.bwd`` around its backward), in ms a step.  The
same calls as ``win_attn_roofline.train``'s, as a time: a change that moves
the calls' shapes moves the roofline's bound with them, not this."""


def read(ctx):
    if ctx.kind != "train" or ctx.cfg["model"]["arch"] != "swinv2":
        return None
    dev = ctx.device_s("pb.attn.fwd", "pb.attn.bwd")
    return None if dev <= 0 else 1000.0 * dev / ctx.steps
