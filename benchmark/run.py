"""Run one benchmark cell once and print its result as the last line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Needs a CUDA device (as many as the cell
asks for); without one it exits 2 and prints no result. Kernel builds and
the Triton cache stay in fixed directories inside the checkout.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from . import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = os.path.join(harness.CACHE_DIR, "triton")
    os.environ["USE_FLAX"] = "0"
    bench = harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}; cells: {sorted(cells)}", file=sys.stderr)
        return 2
    import torch

    need = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"{args.workload} needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import terra_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program under test is not in this checkout: {e}", file=sys.stderr)
        return 3
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark drives the PyTorch port only",
              file=sys.stderr)
        return 4
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
