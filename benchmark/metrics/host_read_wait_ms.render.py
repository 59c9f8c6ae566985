"""Device idle a traced pass while ``render.render`` reads the film's
sample counts to the host (``terra.render.resume_read``) or writes a
unit's inputs from the host (``terra.unit.inputs``), in milliseconds."""
from benchmark import spans

NAMES = ("terra.render.resume_read", "terra.unit.inputs")


def read(ctx):
    return spans.idle_ms_per_item(ctx, lambda name: name in NAMES)
