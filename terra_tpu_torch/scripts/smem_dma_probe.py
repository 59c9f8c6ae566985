"""Probe: does a bulk async copy into shared memory work on this card?

The port of ``scripts/smem_dma_probe.py``: the same three probes, with the
same inputs, expectations and printed lines, on the kernels of
``csrc/pattern_probes.cu`` (TMA bulk copy global -> shared completed on an
mbarrier) instead of Mosaic's HBM -> SMEM DMA:

  (a) rows of an f32 array copied into shared scratch, then read as scalars;
  (b) i32 rows copied in, and a loop whose trip count is read from them;
  (c) a copy started and waited inside a loop, four times.

    python -m terra_tpu_torch.scripts.smem_dma_probe [--device cpu]

runs all three on the card (``--device cpu``: the plain PyTorch versions)
and exits 1 if any fails. Each function returns the (8, 128) output and
whether it equals the expectation everywhere.
"""
from __future__ import annotations

import argparse
import sys

from .. import probes


def probe_hbm_to_smem(device="cuda"):
    x = probes.make_input("smem_dma/hbm_to_smem", device)  # arange (64, 128) f32
    out = probes.run("smem_dma/hbm_to_smem", x)
    expect = float(x[2, 0] + x[3, 1] + x[2, 127])
    got = float(out[0, 0])
    ok = bool((out == expect).all())
    print(f"hbm->smem f32: got {got} expect {expect}", "OK" if ok else "FAIL")
    return out, ok


def probe_hbm_to_smem_i32_loop(device="cuda"):
    x = probes.make_input("smem_dma/hbm_to_smem_i32_loop", device)  # arange i32, x[0, 0] = 5
    out = probes.run("smem_dma/hbm_to_smem_i32_loop", x)
    xs = x.cpu().numpy()
    expect = sum(int(xs[i % 4, i]) for i in range(5))
    got = int(out[0, 0])
    ok = bool((out == expect).all())
    print(f"hbm->smem i32 + data-dep loop: got {got} expect {expect}", "OK" if ok else "FAIL")
    return out, ok


def probe_smem_dma_in_while(device="cuda"):
    """(d) the paged-kernel pattern: a copy started and waited inside a loop."""
    x = probes.make_input("smem_dma/smem_dma_in_while", device)  # arange (8, 128) f32
    out = probes.run("smem_dma/smem_dma_in_while", x)
    expect = float(sum(float(x[i, 0]) for i in range(4)))
    got = float(out[0, 0])
    ok = bool((out == expect).all())
    print(f"smem dma in while: got {got} expect {expect}", "OK" if ok else "FAIL")
    return out, ok


PROBES = (probe_hbm_to_smem, probe_hbm_to_smem_i32_loop, probe_smem_dma_in_while)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ok = True
    for fn in PROBES:
        try:
            ok &= fn(args.device)[1]
        except Exception as e:  # noqa: BLE001 -- report every probe, as the reference does
            print(f"{fn.__name__}: EXCEPTION {type(e).__name__}: {e}")
            ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
