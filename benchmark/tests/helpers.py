"""A benchmark tree of small cells in a temporary directory: the
repository's BENCHMARK.json and benchmark/ copied, plus a small courtyard
configuration and small cells on it, all added as new files."""
from __future__ import annotations

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SMALL_COURTYARD = {"grid": 24, "columns": 6, "column_segments": 8, "column_levels": 3,
                   "tex_res": 16, "seed": 7}
SMALL = {"width": 8, "height": 8}
# limits of the small training cells, at this size on the CPU: sound runs
# read under 1e-6 on each number, the TF32 control and the faults far above
TRAIN_CELL = {"trace_first": 1, "trace_items": 2,
              "limits": {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-3, "box_gap": 0.0,
                         "nonfinite_steps": 0.0}}


def small_tree(tmp) -> str:
    """The copy's root; cells ``small.render``, ``small.inverse`` (the
    benchmark's training cell), ``small.inverse_pos`` (positions and refit
    too) on a small courtyard, and ``cornell.render``, at 8x8 via
    overrides."""
    root = str(tmp)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "courtyard.json")) as f:
        cfg = json.load(f)
    cfg.update(name="small", params=SMALL_COURTYARD)
    cfg.pop("triangles")
    with open(os.path.join(b, "configs", "small.json"), "w") as f:
        json.dump(cfg, f)
    cells = (("small.render", "courtyard.render", "preview_384_8spp"),
             ("small.inverse", "courtyard.inverse_attrs", "inverse_attrs_384_8spp"),
             ("small.inverse_pos", "courtyard.inverse", "inverse_384_8spp"))
    for cell, src, _ in cells:
        if src.startswith("courtyard.inverse"):  # no training cell in the benchmark yet
            with open(os.path.join(b, "workloads", f"{cell}.json"), "w") as f:
                json.dump(TRAIN_CELL, f)
        else:
            shutil.copy(os.path.join(b, "workloads", f"{src}.json"),
                        os.path.join(b, "workloads", f"{cell}.json"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(bench["configs"][0], name="small",
                                 file="benchmark/configs/small.json"))
    bench["workloads"] += [{"name": cell, "config": "small", "traffic": mix, "chips": 1,
                            "why": "test"} for cell, _, mix in cells]
    train = ["small.inverse", "small.inverse_pos"]
    bench["end_to_end"].append({"name": "step_ms", "unit": "ms", "better": "lower", "bound": 0.05,
                                "source": "host_clock", "workloads": train})
    bench["per_layer"] += [
        {"name": "device_idle_pct.train", "unit": "%", "better": "lower", "source": "device_trace",
         "layer": "device", "moves": "step_ms", "workloads": train},
        {"name": "device_ms_per_step.train", "unit": "ms", "better": "lower",
         "source": "device_trace", "layer": "training units", "moves": "step_ms",
         "workloads": train}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "courtyard.render" in m.get("workloads", ()):
            m["workloads"].append("small.render")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
