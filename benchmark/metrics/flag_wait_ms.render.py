"""Device idle a traced pass while the host reads the persistent loop's
all-finished flag (``graphs.drive``'s ``terra.unit.flag_read`` spans), in
milliseconds."""
from benchmark import spans


def read(ctx):
    return spans.idle_ms_per_item(ctx, lambda name: name == "terra.unit.flag_read")
