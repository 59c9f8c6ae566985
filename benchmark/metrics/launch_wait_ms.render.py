"""Device idle a traced pass while the host launches a unit's graphs
(``terra.unit.replay.<stage>`` spans), in milliseconds."""
from benchmark import spans


def read(ctx):
    return spans.idle_ms_per_item(ctx, lambda name: name.startswith("terra.unit.replay."))
