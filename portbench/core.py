"""The harness: one run of one cell of ``BENCHMARK.json``.

A cell names a configuration and a traffic mix, and each piece is found by
its name:

* a configuration is the JSON file that ``BENCHMARK.json`` gives it; its
  ``generator`` names ``models/<generator>.py``, whose ``build(config)``
  makes the factors and values;
* a traffic mix is ``traffic/<mix>.json``: the batch, the observed
  variables, the impossible rows, the sample judged, the limits; its
  ``surface`` names ``surfaces/<surface>.py`` (how to open the engine in
  the configuration's ``dtype``, call it, take its answers and judge them
  against the reference);
* a metric is ``metrics/<metric>.py``, whose ``read(run)`` gives the
  number, or None where the run holds nothing to read.  A metric named
  ``<reader>.<qualifier>`` with no file of its own is read by
  ``metrics/<reader>.py``: the same reading under a name of its own, for
  cells whose end-to-end metric carries a bound of its own.

A run: set-up (model, engine, the evidence pool, warm-up calls), then a
closed loop of calls (each starts when the last has returned) over
``--seconds`` (or, with ``--trace 1``, the
mix's ``trace_calls`` calls under ``torch.profiler``), then the sample of
answers is taken, the program freed, and the reference judges the sample.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "junctiontree_tpu")


# -- finding the pieces by name ---------------------------------------------

def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def named(items, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(base: str, kind: str, name: str):
    """``<base>/<kind>/<name>.py`` as a module."""
    path = os.path.join(base, kind, name + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('-', '_').replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(base: str, name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, else
    ``metrics/<reader>.py`` for a name ``<reader>.<qualifier>``."""
    own = os.path.join(base, "metrics", name + ".py")
    if "." in name and not os.path.isfile(own):
        name = name.split(".", 1)[0]
    return load_module(base, "metrics", name)


def cell(bench: dict, workload: str, base: str = HERE, root: str = ROOT):
    """(cell entry, configuration, traffic mix) of ``workload``."""
    w = named(bench["workloads"], workload, "workload")
    c = named(bench["configs"], w["config"], "config")
    cfg = load_json(os.path.join(root, c["file"]))
    mix_path = os.path.join(base, "traffic", w["traffic"] + ".json")
    if not os.path.isfile(mix_path):
        raise KeyError(f"no traffic mix named {w['traffic']!r} ({mix_path})")
    return w, cfg, load_json(mix_path)


def metrics_of(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: the end-to-end ones
    untraced, the per-layer ones traced.  A metric without ``workloads``
    is reported wherever the metric it moves is."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"]
                                 in reported else [])]


def forbidden_modules() -> List[str]:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def process_seconds() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


# -- one run ---------------------------------------------------------------

@dataclass
class Run:
    """What the metric readers read."""
    setup_s: float
    calls: int = 0
    rows: int = 0
    window_s: float = 0.0
    latencies_s: List[float] = field(default_factory=list)
    peak_bytes: Optional[int] = None
    timers: Dict[str, float] = field(default_factory=dict)
    trace: object = None
    k1_calls: List[dict] = field(default_factory=list)
    step_operations: int = 0


class _K1Recorder:
    """Records the operands of every call the big-clique route hands the
    kernel wrapper (``ops.factored_contract.kernel_or_plain``)."""

    def __init__(self):
        self.calls: List[dict] = []

    def __enter__(self):
        from junctiontree_tpu_torch.ops import factored_contract as fc

        self.fc, self.orig = fc, fc.kernel_or_plain

        def record(pot, w1, w2):
            out = self.orig(pot, w1, w2)
            R1, R2, C = (int(d) for d in pot.shape)
            self.calls.append(dict(
                R1=R1, R2=R2, C=C, B=int(w1.shape[0]),
                pot_bytes=R1 * R2 * C * _itemsize(pot.dtype),
                w1_bytes=w1.numel() * w1.element_size(),
                w2_bytes=w2.numel() * w2.element_size(),
                out_bytes=out.numel() * out.element_size()))
            return out

        fc.kernel_or_plain = record
        return self

    def __exit__(self, *exc):
        self.fc.kernel_or_plain = self.orig


def _itemsize(dtype) -> int:
    import torch

    return torch.empty((), dtype=dtype).element_size()


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mark(stages: Optional[list], name: str):
    """Ends set-up stage ``name`` now (``time.perf_counter()``), where the
    caller keeps ``stages``."""
    if stages is not None:
        stages.append((name, time.perf_counter()))


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, base: str = HERE,
             root: str = ROOT, stages: Optional[list] = None) -> dict:
    """One run; returns the result line (a dict): the driver's keys, then
    ``build_s`` (seconds of the kernel build, 0 where the checkout had it)
    and, last, ``checks``.  Where ``stages`` is a list, each set-up stage
    appends its name and its end (:func:`mark`)."""
    import torch

    import junctiontree_tpu_torch as jt
    from junctiontree_tpu_torch.config import DEFAULT
    from junctiontree_tpu_torch.utils.timing import TIMERS

    from portbench import evidence
    from portbench.reference import Reference

    mark(stages, "program import")

    entry, cfg, mix = cell(bench, workload, base, root)
    gen = load_module(base, "models", cfg["generator"])
    surface = load_module(base, "surfaces", mix["surface"])
    readers = [(m, metric_reader(base, m["name"]))
               for m in metrics_of(bench, workload, trace)]
    cuda = device.type == "cuda"
    # the program's measured-routing table lives under this run's TMPDIR
    DEFAULT.autotune_cache_dir = os.path.join(tempfile.gettempdir(),
                                              "portbench-autotune")

    # -- set-up --------------------------------------------------------------
    # K1's library, built with nvcc in a checkout's first run and loaded
    # from the checkout after: the build's seconds are recorded apart
    build_s = 0.0
    if cuda:
        from junctiontree_tpu_torch.ops import cuda_build

        cuda_build.load_library()
        build_s = cuda_build.build_seconds
    mark(stages, "kernel library")
    TIMERS.reset()
    factors, sizes, values = gen.build(cfg)
    mark(stages, "model")
    inputs = surface.batches(evidence.pool(seed, mix, sizes))
    mark(stages, "evidence pool")
    eng = surface.engine(jt, factors, sizes, values, device, cfg)
    mark(stages, "engine")
    n_pool = len(inputs)
    for i in range(mix["warmup_calls"]):
        surface.call(eng, inputs[i % n_pool])
        _sync(device)
    mark(stages, "warm-up calls")
    timers = dict(TIMERS.totals)
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    run = Run(setup_s=process_seconds() - t_start - build_s, timers=timers)

    # -- the window ----------------------------------------------------------
    last: List[object] = [None] * n_pool   # the newest answers of each batch
    if not trace:
        t0 = time.perf_counter()
        while True:
            k = run.calls % n_pool
            t1 = time.perf_counter()
            out = surface.call(eng, inputs[k])
            _sync(device)
            t2 = time.perf_counter()
            last[k] = out
            run.latencies_s.append(t2 - t1)
            run.calls += 1
            if t2 - t0 >= seconds:
                break
        run.window_s = t2 - t0
    else:
        from torch.profiler import ProfilerActivity, profile, record_function

        from portbench import trace as tr

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        with _K1Recorder() as k1, profile(activities=acts) as prof:
            surface.call(eng, inputs[0])    # the profiler's own first call
            _sync(device)
            del k1.calls[:]
            for i in range(mix["trace_calls"]):
                k = (1 + i) % n_pool
                with record_function(tr.MARK):
                    out = surface.call(eng, inputs[k])
                    _sync(device)
                last[k] = out
                run.calls += 1
        run.trace = tr.read(prof)
        run.window_s = run.trace.window_s
        run.k1_calls = k1.calls
        del prof
        run.step_operations = Reference(factors, sizes).operations(
            mix["batch"])
    run.rows = run.calls * mix["batch"]
    if cuda:
        run.peak_bytes = torch.cuda.max_memory_allocated(device)

    # -- the sample of answers, then the reference ---------------------------
    got, masks = [], []
    for k, rows in enumerate(sample_rows(seed, mix)):
        out = last[k]
        if out is None:
            continue
        got.append(surface.take(eng, out, rows))
        masks.append({v: m[rows] for v, m in inputs[k].items()})
    del eng, out, last
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    got, masks = _concat(got), _concat(masks)
    checks, failed = surface.judge(got, masks, factors, sizes, values,
                                   device, mix["limits"])
    correct = all(checks[k] <= mix["limits"][k] for k in checks)

    metrics = {}
    for m, reader in readers:
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": entry["chips"],
           "memory_peak_bytes": max(setup_peak or 0, run.peak_bytes or 0)}
    line = {"correct": bool(correct), "attempted": run.rows,
            "failed": failed if correct else max(failed, 1),
            "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        line["breakdown"] = {
            "device_ops": [[n, s] for n, s in run.trace.device_ops],
            "idle_gaps": [[n, s] for n, s in run.trace.idle_gaps]}
    line["build_s"] = build_s
    line["checks"] = {k: {"value": _finite(v), "limit": mix["limits"][k]}
                      for k, v in checks.items()}
    return line


def sample_rows(seed: int, mix: dict) -> List[List[int]]:
    """The rows of each pool batch whose answers are judged: the mix's
    impossible rows and ``check_rows`` more drawn from the seed."""
    pick = np.random.default_rng([seed, 1 << 20])
    return [sorted(set(mix.get("impossible_rows", [])) | set(
        pick.choice(mix["batch"], size=mix["check_rows"],
                    replace=False).tolist()))
            for _ in range(mix["pool"])]


def _concat(parts: List[dict]) -> dict:
    """Rows of several samples (nested dicts of arrays) one after another."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _concat([p[k] for p in parts]) for k in first}
    return np.concatenate(parts)


def _finite(v):
    return v if math.isfinite(v) else str(v)


# -- the command -------------------------------------------------------------

def print_stages(stages: list, start: float, build_s: float):
    """Each set-up stage's seconds on standard error, from ``start`` (the
    process's start on ``time.perf_counter()``'s clock); the kernel
    library's without its build, as ``setup_s`` has it.  They sum to
    ``setup_s``."""
    last = start
    for name, end in stages:
        sec = end - last - (build_s if name == "kernel library" else 0.0)
        print(f"setup stage {name}: {sec:.4f} s", file=sys.stderr)
        last = end


def main(argv: List[str], t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    bench = load_benchmark()
    chips = named(bench["workloads"], args.workload, "workload")["chips"]

    # build and kernel caches inside the checkout, at fixed paths
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    # one process with one compute thread: the serving steps are bound by
    # the host, and a pool of spinning threads on a shared host spreads them
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} device(s)", file=sys.stderr)
        return 2
    # the card's context is made on the engine's first upload, inside the
    # "engine" stage (and the program's engine.upload phase)
    stages: list = []
    mark(stages, "torch import")
    start = stages[0][1] - (process_seconds() - t_start)
    line = run_cell(bench, args.workload, args.seed, args.seconds,
                    bool(args.trace), torch.device("cuda", 0), t_start,
                    stages=stages)
    found = forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package is loaded: {found}",
              file=sys.stderr)
        return 3
    print_stages(stages, start, line["build_s"])
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
