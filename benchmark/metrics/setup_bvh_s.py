"""Seconds the process spent building BVHs (``scene.commit``'s
``terra.scene.bvh_build`` spans), less any kernel build run inside them
(the native builder's first compile)."""
from benchmark import spans


def read(ctx):
    return spans.setup_seconds("terra.scene.bvh_build", less="terra.kernel.build")
