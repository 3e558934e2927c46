"""The harness: a cell's files by name, one run, the result line.

A cell is workloads/<cell>.json: its configuration (configs/<config>.json),
its traffic mix (traffic/<traffic>.json, updated by the cell's "mix"), its
entry (entries/<entry>.py) and the limits of its comparison ("limits").
The per-layer metrics are the readers under metrics/, each loaded by its
file name; the end-to-end metrics are the entry's own. Where BENCHMARK.json
stands beside portbench/, the line holds the metrics it lists for the cell
and no others.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BUILD = ROOT / "build" / "portbench"
BANNED = ("jax", "jaxlib", "flax", "grail_tpu")


def load_cell(name: str, overrides: dict | None = None) -> SimpleNamespace:
    """The cell `name` from its files; `overrides` (tests) update the
    traffic mix ("mix"), the configuration ("config") and the cell's own
    keys."""
    from .traffic.generator import load_mix

    overrides = dict(overrides or {})
    path = HERE / "workloads" / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"unknown workload {name!r}: no {path}")
    cell = json.loads(path.read_text())
    config = json.loads((HERE / "configs" / f"{cell['config']}.json")
                        .read_text())
    config.update(overrides.pop("config", {}))
    mix = load_mix(cell["traffic"], {**cell.get("mix", {}),
                                     **overrides.pop("mix", {})})
    cell.update(overrides)
    cell.update(name=name, config_name=cell["config"], config=config,
                mix=mix)
    return SimpleNamespace(**cell)


def entry_class(name: str):
    return importlib.import_module(f"portbench.entries.{name}").Entry


def metric_readers() -> dict:
    """{metric name: read(records) -> value or None}, one per file under
    metrics/ (the file name less .py is the metric's name)."""
    out = {}
    for path in sorted((HERE / "metrics").glob("*.py")):
        if path.name == "__init__.py":
            continue
        name = path.name[:-3]
        spec = importlib.util.spec_from_file_location(
            f"portbench.metrics.{name.replace('.', '__')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod.read
    return out


def listed_metrics(cell_name: str):
    """(end-to-end names, per-layer names) that BENCHMARK.json lists for the
    cell, or (None, None) where there is no BENCHMARK.json."""
    path = ROOT / "BENCHMARK.json"
    if not path.exists():
        return None, None
    bench = json.loads(path.read_text())

    def for_cell(ms):
        return {m["name"] for m in ms
                if cell_name in m.get("workloads", [cell_name])}

    return for_cell(bench["end_to_end"]), for_cell(bench["per_layer"])


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in BANNED})


def run(cell_name: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, overrides: dict | None = None, fault=None):
    """One run of the cell; returns (result dict, check rows). `t_start` is
    the host clock at the process's start (set-up counts from there)."""
    import torch

    from .trace import Tracer, breakdown

    cell = load_cell(cell_name, overrides)
    entry = entry_class(cell.entry)(cell, int(seed), device, fault=fault,
                                    seconds=float(seconds))
    entry.setup()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    tracer = Tracer(bool(trace) and on_card, BUILD)
    t_w = time.perf_counter()
    with tracer.window():
        entry.window(float(seconds), traced=bool(trace))
    t_r = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    records = entry.records()
    if tracer.on:
        records["trace"] = tracer.reduce()
    entry.finish()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_c = time.perf_counter()
    checks = entry.verify()
    t_e = time.perf_counter()
    print(f"portbench: set-up {setup_s:.3f} s, window {t_r - t_w:.3f} s, "
          f"trace and release {t_c - t_r:.3f} s, check {t_e - t_c:.3f} s",
          file=sys.stderr)
    attempted, failed = entry.counts()

    e2e_names, layer_names = listed_metrics(cell_name)
    if trace:
        metrics = {}
        for name, read in metric_readers().items():
            if layer_names is not None and name not in layer_names:
                continue
            got = read(records)
            if got is not None:
                value, unit = got
                metrics[name] = {"value": value, "unit": unit}
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for name, (value, unit) in entry.end_to_end().items():
            if e2e_names is None or name in e2e_names:
                metrics[name] = {"value": value, "unit": unit}

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": all(ok for _, _, _, ok in checks) and bool(checks),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev}
    if tracer.on:
        dev["busy_s"] = records["trace"]["busy_s"]
        dev["window_s"] = records["trace"]["window_s"]
        result["breakdown"] = breakdown(records["trace"])
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit, _ in checks}
    return result, checks
