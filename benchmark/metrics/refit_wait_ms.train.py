"""Device idle a traced training step while the host refits the tree's
boxes (``lbvh.refit_``'s ``terra.bvh.refit`` spans), in milliseconds."""
from benchmark import spans


def read(ctx):
    return spans.idle_ms_per_item(ctx, lambda name: name == "terra.bvh.refit")
