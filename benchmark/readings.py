"""The readings the correctness limits are set from, on the card: for each
seed, one run of the cell at its own size (set-up, window, the program's
state freed) and its numbers against the plain reference (the lower
readings), then the control's numbers on the same inputs, the reference
in TF32 put in the program's place (the upper readings), and for a
training cell the faults planted in the reference in the program's place.
One JSON line per seed. The benchmark's own runs do not run this.

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,3 --seconds 20 [--control]
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    import torch

    from . import harness

    ap = argparse.ArgumentParser(prog="python3 -m benchmark.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx, traffic, _ = harness.prepare(args.workload, seed)
        st = traffic.setup(ctx)
        out = traffic.window(ctx, st, args.seconds)
        traffic.release(ctx, st)
        del st
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        row = {"seed": seed, "items": out["attempted"], "metrics": out["metrics"]}
        if hasattr(traffic, "reference_values"):
            ref = traffic.reference_values(ctx)
            tol = float(ctx.cell["limits"]["tolerance"])
            row["program"] = traffic.compare(ctx.kept, ref, tol)
            row["check_s"] = time.perf_counter() - t0
            if args.control:
                row["control"] = traffic.compare(traffic.reference_values(ctx, tf32=True), ref,
                                                 tol)
        else:
            ref = traffic.reference_run(ctx)
            row["program"] = dict(traffic.numbers(ctx, ctx.snap, ref),
                                  nonfinite_steps=ctx.bad_steps)
            row["check_s"] = time.perf_counter() - t0
            if args.control:
                row["control"] = traffic.numbers(
                    ctx, traffic.control_snapshot(ctx, traffic.reference_run(ctx, tf32=True)), ref)
                row["faults"] = traffic.fault_readings(ctx, ref)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
