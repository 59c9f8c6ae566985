"""The BVH4 traversal kernel's share of its roofline over the traced
passes: the least time its launches need (``roofline.bvh4_launch``: bytes
over the card's bandwidth, or operations over its f32 rate) over their
device time."""
from benchmark import roofline


def read(ctx):
    t, f = ctx.trace, ctx.facts
    if t is None or ctx.peaks is None or "num_wide" not in f:
        return None
    least = busy = 0.0
    for name, _, _, dur in t.kernels():
        inst = roofline.bvh4_instance(name)
        if inst is None:
            continue
        has_tmax, _, bf16 = inst
        work = roofline.bvh4_launch(f["rays_per_launch"], has_tmax, f["num_wide"], f["leaf_rows"],
                                    bf16)
        least += roofline.least_seconds(work, ctx.peaks)
        busy += dur * 1e-6
    if busy <= 0:
        return None
    return 100.0 * least / busy
