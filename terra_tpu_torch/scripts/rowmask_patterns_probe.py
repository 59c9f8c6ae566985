"""Pattern probes for the row-masked dense leaf test, on the card.

The port of ``scripts/rowmask_patterns_probe.py``: the same four probes,
inputs, expectations and printed lines, on the kernels of
``csrc/pattern_probes.cu``. Rows 0-7 of a (16, 128) f32 arange are staged
into shared memory by bulk copies (probes 1 and 3: each warp its own row
on its own mbarrier), then:

  1: per-row stores, the row's bit (of 0b10100110) selecting 2 x[r] or 0;
  2: (8,1) column x (1,128) row tile math, min over the column -> row r;
  3: row-activity bits (any lane > 700) from each row's warp vote, selecting
     the row's value;
  4: three mask planes stored into shared scratch in a loop, then a drain
     that adds each plane's rows that have a lane below 1e9.

    python -m terra_tpu_torch.scripts.rowmask_patterns_probe N [--device cpu]

runs probe N on the card (``--device cpu``: the plain PyTorch version) and
exits 1 if it fails. Each function returns the (8, 128) output and whether
it equals the expectation.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import probes

ROWS, W = probes.ROWS, probes.W


def _report(label, out, expect):
    ok = bool(np.array_equal(out.cpu().numpy(), expect))
    print(f"{label}:", "OK" if ok else "FAIL")
    return out, ok


def probe1(device="cuda"):
    """Row stores: out[r] = 2 x[r] under bit r of a scalar."""
    x = probes.make_input("rowmask/probe1", device)  # arange (16, 128) f32
    out = probes.run("rowmask/probe1", x)
    expect = np.zeros((ROWS, W), np.float32)
    for r in range(ROWS):
        if (0b10100110 >> r) & 1:
            expect[r] = x[r].cpu().numpy() * 2.0
    return _report("probe1 row-store", out, expect)


def probe2(device="cuda"):
    """Tile (8,1) x (1,128) -> (8,128), min over the column -> row r."""
    x = probes.make_input("rowmask/probe2", device)  # arange (16, 128) f32
    out = probes.run("rowmask/probe2", x)
    xa = x.cpu().numpy()[:8]
    expect = np.zeros((ROWS, W), np.float32)
    for r in range(ROWS):
        expect[r] = (xa[:, r:r + 1] * xa[r][None, :] + xa[:, r:r + 1]).min(axis=0)
    return _report("probe2 tri-sublane tile", out, expect)


def probe3(device="cuda"):
    """Row-activity bits from warp votes drive row stores."""
    x = probes.make_input("rowmask/probe3", device)  # arange (16, 128) f32
    out = probes.run("rowmask/probe3", x)
    expect = (x.cpu().numpy()[:8] > 700.0).any(axis=1, keepdims=True) * np.ones((1, W),
                                                                               np.float32)
    return _report("probe3 rowbits", out, expect.astype(np.float32))


def probe4(device="cuda"):
    """Mask planes stored in a loop, then a drain with per-row gating."""
    x = probes.make_input("rowmask/probe4", device)  # arange (16, 128) f32
    out = probes.run("rowmask/probe4", x)
    xa = x.cpu().numpy()[:8]
    expect = np.zeros((ROWS, W), np.float32)
    for slot in range(3):
        m = np.where(xa > 600.0 + 100.0 * slot, xa, 1e9).astype(np.float32)
        hitrows = (m < 1e9).any(axis=1)
        for r in range(ROWS):
            if hitrows[r]:
                expect[r] += m[r]
    return _report("probe4 mask round-trip", out, expect)


PROBES = {1: probe1, 2: probe2, 3: probe3, 4: probe4}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("probe", type=int, choices=sorted(PROBES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return 0 if PROBES[args.probe](args.device)[1] else 1


if __name__ == "__main__":
    sys.exit(main())
