"""Device time a train step spends in the port's collectives (the flat
gradient all-reduce and mixup's ring): the kernels launched inside the
benchmark's exchange spans over the traced steps, in ms a step, on the rank
that spends least there.  A collective's kernel on a rank that arrives
early also waits for the last rank; the last rank waits least, so the
minimum over the ranks is the exchange itself.  Nothing to read on one
chip."""

OVER_RANKS = "min"


def read(ctx):
    if ctx.kind != "train" or ctx.chips == 1:
        return None
    dev = ctx.device_s("pb.exchange")
    return None if dev <= 0 else 1000.0 * dev / ctx.steps
