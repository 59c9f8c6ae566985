"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
SXM part, dense rates, at the full 700 W power limit). A roofline share is
stated against these, with the card's power limit beside it."""
from __future__ import annotations

PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12, "tf32_flops_per_s": 495e12,
             "bf16_flops_per_s": 989e12, "memory_bytes": 80e9},
}


def for_device(name: str):
    """The peaks of the card called ``name``, or None for an unknown card
    (a roofline reader then reports nothing)."""
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    return None
