"""Seconds the process spent warming up and capturing launch units
(``terra.unit.capture`` spans), less any kernel build run inside them."""
from benchmark import spans


def read(ctx):
    return spans.setup_seconds("terra.unit.capture", less="terra.kernel.build")
