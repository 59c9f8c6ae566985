"""Share of the traced passes in which no operation ran on the device."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
