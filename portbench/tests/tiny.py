"""A copy of the benchmark with tiny cells that run on the CPU in seconds.

``make(tmp)`` copies ``portbench/`` under ``tmp`` and adds, as new files
and new ``BENCHMARK.json`` entries only, two small configurations and
their mixes: the way a later change adds a cell.
"""

from __future__ import annotations

import json
import os
import shutil

from portbench.core import HERE, ROOT, load_benchmark

TINY_CONFIGS = {
    "tinyclique": {"generator": "dense_clique", "variables": 8, "card": 2,
                   "value_offset": 0.1, "model_seed": 0, "dtype": "float32"},
    "tinynet": {"generator": "random_bayesnet", "nodes": 10,
                "max_in_degree": 3, "cards": [2, 3], "cpd_offset": 0.05,
                "model_seed": 1, "dtype": "float32"},
}
_MIX = {"batch": 16,
        "impossible_rows": [1], "pool": 3, "warmup_calls": 1,
        "trace_calls": 2, "check_rows": 5}
TINY_MIXES = {
    "tiny_post_clique": dict(_MIX, surface="posterior_batch",
                             control="reference_tf32",
                             observed=["v0", "v1", "v2", "v3", "v4"],
                             limits={"post_err": 1e-5, "logz_err": 1e-4,
                                     "bad_rows": 0}),
    "tiny_post_net": dict(_MIX, surface="posterior_batch",
                          control="reference_tf32",
                          observed=["n0", "n3", "n6", "n9"],
                          limits={"post_err": 1e-5, "logz_err": 1e-4,
                                  "bad_rows": 0}),
    "tiny_map_net": dict(_MIX, surface="map_assignment_batch",
                         control="reference_bf16",
                         observed=["n0", "n3", "n6", "n9"],
                         limits={"score_err": 1e-4, "assign_gap": 1e-4,
                                 "bad_rows": 0}),
    "tiny_map_clique": dict(_MIX, surface="map_assignment_batch",
                            control="reference_bf16",
                            observed=["v0", "v1", "v2", "v3", "v4"],
                            limits={"score_err": 1e-4, "assign_gap": 1e-4,
                                    "bad_rows": 0}),
}
TINY_CELLS = {"tinyclique-post": ("tinyclique", "tiny_post_clique"),
              "tinyclique-map": ("tinyclique", "tiny_map_clique"),
              "tinynet-post": ("tinynet", "tiny_post_net"),
              "tinynet-map": ("tinynet", "tiny_map_net")}


def make(tmp):
    """(benchmark dict, base, root) of a copy of the benchmark with the tiny
    cells added."""
    root = str(tmp)
    base = os.path.join(root, "portbench")
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = load_benchmark(ROOT)
    for name, cfg in TINY_CONFIGS.items():
        path = os.path.join("portbench", "configs", name + ".json")
        with open(os.path.join(root, path), "w") as f:
            json.dump(dict(cfg, name=name), f)
        bench["configs"].append({"name": name, "source": "test",
                                 "file": path, "reduced": [], "why": "test"})
    for name, mix in TINY_MIXES.items():
        with open(os.path.join(base, "traffic", name + ".json"), "w") as f:
            json.dump(mix, f)
    for name, (cfg, mix) in TINY_CELLS.items():
        bench["workloads"].append({"name": name, "config": cfg,
                                   "traffic": mix, "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + list(TINY_CELLS)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return bench, base, root
