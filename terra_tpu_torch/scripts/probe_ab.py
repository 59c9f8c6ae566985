"""A/B of probe-kernel builds on the card: another source against this one.

    python -m terra_tpu_torch.scripts.probe_ab --parent OLD.cu [--reps 200]
        [--json OUT.json]

builds ``OLD.cu`` (an earlier ``csrc/pattern_probes.cu``, e.g. from ``git
show``) and this checkout's ``csrc/pattern_probes.cu`` at once, with the
probes' nvcc flags; prints each build's registers and shared memory per
kernel and which kernels compiled to the parent's SASS instruction for
instruction; holds both builds' kernels to the plain versions on the
reference's input, on ``probes.SEEDS`` seeded ones and on the loop
probe's trip-count edges (0 differing words, or it exits 1 before
timing); then times every body on the reference's input, and the loop
probe also at n = 128 trips, on the device (CUDA events over ``--reps``
launches back to back behind a sleep backlog, so the host's launch rate
is not what is timed) with the builds in turns,
parent, new, new, parent, and the launch floor (``terra_probe_empty`` at
each probe block size) at both ends. Prints the card's name and power
limit and one JSON object as its last line.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import _build, probes
from ..profile import card, device_ms


def footprints(path: str) -> dict:
    """{kernel: "N registers, M bytes smem"} from a build's ptxas log."""
    out, name = {}, None
    for ln in _build.build_log(path).splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", ln):
            name = m.group(1)
        elif (m := re.search(r"Used (\d+) registers", ln)) and name:
            smem = re.search(r"(\d+) bytes smem", ln)
            out[name] = f"{m.group(1)} registers, {smem.group(1) if smem else 0} bytes smem"
            name = None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="the earlier pattern_probes.cu")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_ab: needs an NVIDIA GPU")
    cmd = [_build.nvcc(), *probes.NVCC_FLAGS]
    jobs = {"parent": lambda: _build.build_shared(cmd, [os.path.abspath(args.parent)],
                                                  "pattern_probes_parent"),
            "new": probes.kernel_path}
    with ThreadPoolExecutor(len(jobs)) as ex:
        paths = {b: f.result() for b, f in {b: ex.submit(fn) for b, fn in jobs.items()}.items()}
    libs = {b: probes.load_library(p) for b, p in paths.items()}
    code = {b: probes.sass(p) for b, p in paths.items()}
    same = {b: sorted(k for k, t in code[b].items() if code["parent"].get(k) == t)
            for b in paths}
    for b, p in paths.items():
        print(f"build {b}: " + "; ".join(f"{k} {v}" for k, v in sorted(footprints(p).items()))
              + f"; SASS as the parent's: {same[b]}", flush=True)

    words = {b: {} for b in libs}
    for name in probes.BODIES:
        inputs = [probes.make_input(name, "cuda"),
                  *(probes.seeded_input(name, s, "cuda") for s in range(probes.SEEDS)),
                  *probes.edge_inputs(name, "cuda").values()]
        plain = [probes.run_plain(name, x) for x in inputs]
        for b, lib in libs.items():
            words[b][name] = [int((probes.launch(name, x, lib).view(torch.int32)
                                   != p.view(torch.int32)).sum()) for x, p in zip(inputs, plain)]
    bad = {b: {n: w for n, w in ws.items() if any(w)} for b, ws in words.items()}
    print(f"words differing from the plain version (reference input + {probes.SEEDS} seeded + "
          f"{len(probes.LOOP_EDGES)} loop edges), by build: { {b: bad[b] or 0 for b in bad} }",
          flush=True)
    if any(bad.values()):
        return 1

    order = ["parent", "new", "new", "parent"]
    x0 = probes.make_input("paged/probe1", "cuda")
    threads = sorted({t for _, _, t in probes.KERNELS.values()}, reverse=True)
    timed = {name: (name, probes.make_input(name, "cuda")) for name in probes.BODIES}
    timed[f"{probes.LOOP} n={probes.W}"] = (probes.LOOP,
                                            probes.edge_inputs(probes.LOOP, "cuda")[probes.W])
    times = {label: {b: [] for b in libs} for label in timed}
    floor = {t: [] for t in threads}

    def time_floor():
        for t in threads:
            floor[t].append(device_ms(lambda: probes.run_floor(x0, t, libs["new"]), args.reps,
                                      backlog=True))

    # the process's first timing reads high (4.6 us for a 1.8 us floor on
    # the H100): one untimed pass first
    device_ms(lambda: probes.run_floor(x0, threads[0], libs["new"]), args.reps, backlog=True)
    time_floor()
    for b in order:
        for label, (name, x) in timed.items():
            times[label][b].append(device_ms(lambda: probes.launch(name, x, libs[b]), args.reps,
                                             backlog=True))
    time_floor()

    smi = card()
    print(f"device ms per launch, {args.reps} back to back, builds in turns {order}; floor "
          + "; ".join(f"{t} threads {fs[0]:.5f} / {fs[1]:.5f}" for t, fs in floor.items())
          + f" ms; {smi}", flush=True)
    for name, by in times.items():
        print(f"  {name}: " + "; ".join(f"{b} " + " / ".join(f"{t:.5f}" for t in ts)
                                       for b, ts in by.items()), flush=True)
    result = {"card": smi, "reps": args.reps, "order": order, "floor_ms": floor,
              "ms": times, "footprints": {b: footprints(p) for b, p in paths.items()},
              "sass_as_parent": same}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
