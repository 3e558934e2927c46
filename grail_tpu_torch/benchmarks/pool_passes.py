"""The pool's host passes by kind on one card, in the benchmark's pool cell.

    python -m grail_tpu_torch.benchmarks.pool_passes [SEED] [SECONDS]
    PYTHONPATH=<an older tree> python grail_tpu_torch/benchmarks/pool_passes.py

Sets up portbench's `pool_en_plain.stream` (StreamPool(768), its feeder,
its warm ticks; run from the repo's root, which holds portbench/) and ticks
it back to back as the cell does, twice:

  * SECONDS (30) with the pool's spans recorded and no profiler (the span
    buffer alone, on the host clock): every `host` span sorted by kind,
    `whole` (an upload of every session: `full_uploads`), `bulk` (more than
    8 sessions' score or lattice rows scattered), `scatter` (1-8),
    `maintenance` (a full pass that uploaded nothing) and `fast` (the quiet
    fast path), with their count, seconds and median; the tallies summed;
    and within the whole and bulk passes the seconds of the parts, timed by
    wrapping the private names `StreamPool._prepare_tick_full`,
    `_upload_scores`, `_upload_lattices`, `StreamSession._build_score`,
    `stream.stack_scores`, `kernel_fused.score_tables` and `stream._up` for
    the run;
  * SECONDS / 2 under torch.profiler (CPU and CUDA): the device time by
    operation, and for each `host` span that uploaded, the pageable
    host-to-device copies' device time and their runtime calls' host time,
    matched through the profiler's correlation ids.

One JSON line with the card's name and power limit, also written to
chiprun_out/pool_passes_<SEED>.json. It gates nothing.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

from grail_tpu_torch.benchmarks.kernel1_ab import _card
from grail_tpu_torch.runtime import stream as pstream
from grail_tpu_torch.runtime import trace
from grail_tpu_torch.synth import kernel_fused as kf

CELL = "pool_en_plain.stream"
PARTS = {"full_pass": (pstream.StreamPool, "_prepare_tick_full"),
         "upload_scores": (pstream.StreamPool, "_upload_scores"),
         "upload_lattices": (pstream.StreamPool, "_upload_lattices"),
         "build_score": (pstream.StreamSession, "_build_score"),
         "stack_scores": (pstream, "stack_scores"),
         "score_tables": (kf, "score_tables"),
         "up": (pstream, "_up")}


def _kind(a: dict) -> str:
    if not a.get("full"):
        return "fast"
    if a.get("full_uploads"):
        return "whole"
    rows = max(a.get("score_rows_uploaded", 0),
               a.get("lattice_rows_uploaded", 0))
    return "bulk" if rows > 8 else "scatter" if rows else "maintenance"


def _run(entry, seconds: float) -> int:
    k0, t0 = entry.k, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        entry._tick()
    entry._take(entry.pool.drain())
    return entry.k - k0


def spans_window(entry, seconds: float) -> dict:
    """The host passes by kind, their tallies and their parts."""
    passes = []                   # (parts of one full pass)
    cur = None
    saved = {name: getattr(owner, attr) for name, (owner, attr)
             in PARTS.items()}

    def timed(name, fn):
        def call(*a, **kw):
            nonlocal cur
            outer = name == "full_pass"
            if outer:
                cur = collections.Counter()
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if cur is not None:
                    cur[name] += time.perf_counter() - t
                if outer:
                    passes.append(cur)
                    cur = None
        return call

    for name, (owner, attr) in PARTS.items():
        setattr(owner, attr, timed(name, saved[name]))
    trace._recording, recording = (lambda: True), trace._recording
    trace.clear()
    t0 = time.perf_counter()
    try:
        ticks = _run(entry, seconds)
    finally:
        window = time.perf_counter() - t0
        trace._recording = recording
        for name, (owner, attr) in PARTS.items():
            setattr(owner, attr, saved[name])
    hosts = [s for s in trace.spans() if s.name == "host"]
    full = iter(passes)
    kinds = collections.defaultdict(list)
    parts = collections.defaultdict(collections.Counter)
    tallies = collections.Counter()
    for s in hosts:
        kind = _kind(s.attrs)
        kinds[kind].append((s.end_ns - s.start_ns) * 1e-6)
        if s.attrs.get("full"):
            p = next(full)
            if kind in ("whole", "bulk"):
                parts[kind].update(p)
        tallies.update({k: v for k, v in s.attrs.items()
                        if k != "full" and isinstance(v, int)})
    return {"ticks": ticks, "window_s": window,
            "xrt": ticks * len(entry.pool.sessions) * entry.block
            / entry.sr / window,
            "kinds": {k: {"n": len(v), "s": sum(v) * 1e-3,
                          "median_ms": statistics.median(v)}
                      for k, v in sorted(kinds.items())},
            "tallies": dict(tallies),
            "parts_s": {k: dict(v) for k, v in parts.items()}}


def profiled_window(entry, seconds: float) -> dict:
    """Device time by operation; the pageable uploads of each host pass."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ticks = _run(entry, seconds)
        if entry.dev.type == "cuda":
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    xs = [e for e in events if e.get("ph") == "X"]
    hosts = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in xs if e.get("name") == trace.PREFIX + "host")
    starts = [a for a, _ in hosts]
    runtime = {e["args"]["correlation"]: e for e in xs
               if e.get("cat") == "cuda_runtime"
               and "correlation" in e.get("args", {})}
    ops = collections.Counter()
    per_host = collections.defaultdict(lambda: [0.0, 0.0, 0])
    for e in xs:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ops[e["name"]] += float(e["dur"]) * 1e-6
        call = runtime.get(e.get("args", {}).get("correlation"))
        if "HtoD" not in e["name"] or call is None:
            continue
        ts = float(call["ts"])
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= hosts[i][1]:
            acc = per_host[i]
            acc[0] += float(e["dur"]) * 1e-3
            acc[1] += float(call["dur"]) * 1e-3
            acc[2] += 1
    uploads = sorted(per_host.values(), reverse=True)
    return {"ticks": ticks, "host_spans": len(hosts),
            "device_s": dict(ops.most_common(6)),
            "uploading_passes": len(uploads),
            "htod_device_ms": [round(u[0], 3) for u in uploads[:12]],
            "htod_call_ms": [round(u[1], 3) for u in uploads[:12]],
            "htod_copies": [u[2] for u in uploads[:12]]}


def main(argv) -> None:
    from portbench import harness

    seed = int(argv[0]) if argv else 4200000102
    seconds = float(argv[1]) if len(argv) > 1 else 30.0
    cell = harness.load_cell(CELL)
    entry = harness.entry_class(cell.entry)(cell, seed, "cuda")
    t = time.perf_counter()
    entry.setup()
    out = {"card": _card(), "seed": seed, "tree": pstream.__file__,
           "setup_s": time.perf_counter() - t,
           "spans": spans_window(entry, seconds),
           "profiled": profiled_window(entry, seconds / 2)}
    line = json.dumps(out)
    Path("chiprun_out").mkdir(exist_ok=True)
    Path(f"chiprun_out/pool_passes_{seed}.json").write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main(sys.argv[1:])
