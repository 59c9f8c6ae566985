"""Pattern probes for the paged traversal kernel, on the card.

The port of ``scripts/paged_patterns_probe.py``: the same four probes,
inputs, expectations and printed lines, on the paged-pattern kernel of
``csrc/pattern_probes.cu``. Each runs three iterations of a loop over
the pages of a (16, 128) f32 input (rows 4i..4i+3); inside the loop the
kernel keeps a ring of page buffers filled by bulk copies, one mbarrier
each, waits on page i's barrier and then adds

  1: the min of row 1 (a warp reduction);
  2: the scalar scr[1, 3];
  3: the min of row 2 of a row-index input (replicated rows);
  4: pattern 3's value as a link, pushed onto an 8-entry shared stack when
     it exceeds 4 and read back.

    python -m terra_tpu_torch.scripts.paged_patterns_probe N [--device cpu]

runs probe N on the card (``--device cpu``: the plain PyTorch version) and
exits 1 if it fails. Each function returns the (8, 128) output and whether
it equals the expectation everywhere.
"""
from __future__ import annotations

import argparse
import sys

from .. import probes


def _report(label, out, expect):
    got = float(out[0, 0])
    ok = bool((out == float(expect)).all())
    print(f"{label}: got {got} expect {expect}", "OK" if ok else "FAIL")
    return out, ok


def probe1(device="cuda"):
    x = probes.make_input("paged/probe1", device)  # arange (16, 128) f32
    out = probes.run("paged/probe1", x)
    expect = sum(float(x[i * 4 + 1].min()) for i in range(3))
    return _report("probe1 vector-row", out, expect)


def probe2(device="cuda"):
    x = probes.make_input("paged/probe2", device)  # arange (16, 128) f32
    out = probes.run("paged/probe2", x)
    expect = sum(float(x[i * 4 + 1, 3]) for i in range(3))
    return _report("probe2 scalar-elem", out, expect)


def probe3(device="cuda"):
    x = probes.make_input("paged/probe3", device)  # row index in every lane
    out = probes.run("paged/probe3", x)
    expect = sum(float(x[i * 4 + 2, 0]) for i in range(3))
    return _report("probe3 replicated-reduce", out, expect)


def probe4(device="cuda"):
    x = probes.make_input("paged/probe4", device)  # row index in every lane
    out = probes.run("paged/probe4", x)
    expect = sum(int(x[i * 4 + 2, 0]) if x[i * 4 + 2, 0] > 4 else 0 for i in range(3))
    return _report("probe4 scalar-push", out, expect)


PROBES = {1: probe1, 2: probe2, 3: probe3, 4: probe4}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("probe", type=int, choices=sorted(PROBES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return 0 if PROBES[args.probe](args.device)[1] else 1


if __name__ == "__main__":
    sys.exit(main())
