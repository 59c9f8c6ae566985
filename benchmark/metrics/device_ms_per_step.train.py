"""Kernel time on the device per traced training step, summed over the
step's kernels (forward, backward and Adam), in milliseconds."""


def read(ctx):
    t = ctx.trace
    if t is None or t.items == 0 or not t.kernels():
        return None
    return sum(dur for _, _, _, dur in t.kernels()) * 1e-3 / t.items
