"""Kernel launches on the device per traced pass (a count; it repeats)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.items == 0 or not t.kernels():
        return None
    return len(t.kernels()) / t.items
