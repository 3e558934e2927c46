"""The traced run's device record: torch.profiler over the window, reduced.

`Tracer` wraps the measured window in torch.profiler (CPU and CUDA
activities); the harness marks its own phases with `phase(label)`
(record_function), on whatever thread runs them. `reduce` reads the
exported Chrome trace and keeps:

  * every device operation in the window (kernels, copies, sets) with its
    name, start, duration, and the harness phase that launched it: the
    innermost phase open on the launching thread when its runtime call
    (cudaLaunchKernel, cudaGraphLaunch, cudaMemcpyAsync, ...) was made,
    matched through the profiler's correlation ids; '' where none was;
  * busy seconds: the union of the device operations' intervals;
  * the idle gaps between them, each labelled by the harness phase open on
    the harness's threads at the gap's middle.

`outside` takes the intervals of some harness phases (a probe of the
harness's own, which untraced runs do not make) out of both the busy
seconds and the window.
"""

from __future__ import annotations

import contextlib
import json
import os
from bisect import bisect_right
from pathlib import Path

import torch

WINDOW = "portbench.window"
PREFIX = "portbench."


def phase(label: str):
    """A harness phase, seen by the profiler when one runs."""
    return torch.profiler.record_function(PREFIX + label)


class Tracer:
    """Profiles the window when `on`; a no-op context otherwise."""

    def __init__(self, on: bool, out_dir: Path):
        self.on = on
        self.path = Path(out_dir) / f"trace_{os.getpid()}.json"
        self._prof = None

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        with self._prof:
            with torch.profiler.record_function(WINDOW):
                yield
            torch.cuda.synchronize()

    def reduce(self) -> dict:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.path))
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            self.path.unlink(missing_ok=True)
        return reduce_events(events)


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def reduce_events(events) -> dict:
    """Chrome-trace events -> the record the metric readers read (times in
    seconds from the window's start)."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"]
    if not win:
        raise RuntimeError("the trace has no window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    phases = {}                       # tid -> [(ts, end, label)]
    for e in events:
        name = e.get("name", "")
        if (e.get("ph") == "X" and name.startswith(PREFIX)
                and name != WINDOW):
            phases.setdefault(e.get("tid"), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                 name[len(PREFIX):]))
    for v in phases.values():
        v.sort()

    def open_phase(tid, ts):
        best = ""
        for a, b, label in phases.get(tid, ()):
            if a > ts:
                break
            if ts <= b:
                best = label      # the innermost (latest-starting) open one
        return best

    launch = {}                       # correlation -> phase label
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "args" in e:
            corr = e["args"].get("correlation")
            if corr is not None:
                launch[corr] = open_phase(e.get("tid"), float(e["ts"]))
    ops = []
    for e in events:
        if e.get("cat") in _DEVICE_CATS and e.get("ph") == "X":
            ts, dur = float(e["ts"]), float(e.get("dur", 0))
            if ts + dur < w0 or ts > w1:
                continue
            corr = e.get("args", {}).get("correlation")
            ops.append({"name": e.get("name", ""), "cat": e["cat"],
                        "t": (ts - w0) * 1e-6, "dur": dur * 1e-6,
                        "phase": launch.get(corr, "")})
    ops.sort(key=lambda o: o["t"])
    busy, gaps, end = 0.0, [], 0.0
    for o in ops:
        a, b = max(o["t"], 0.0), min(o["t"] + o["dur"], (w1 - w0) * 1e-6)
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    W = (w1 - w0) * 1e-6
    if W > end:
        gaps.append((end, W))
    # the harness's phases on any thread, for labelling the gaps
    flat = sorted((a, b, label) for v in phases.values() for a, b, label in v)
    starts = [a for a, _, _ in flat]

    def label_at(t_s):
        ts = w0 + t_s * 1e6
        i = bisect_right(starts, ts)
        found = [label for a, b, label in flat[max(0, i - 64):i] if b >= ts]
        return found[-1] if found else "none"

    idle = [(label_at(0.5 * (a + b)), b - a) for a, b in gaps]
    return {"ops": ops, "busy_s": busy, "window_s": W, "idle": idle,
            "phases": [(label, (a - w0) * 1e-6, (b - a) * 1e-6)
                       for a, b, label in flat]}


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return out


def outside(rec: dict, labels) -> tuple:
    """(busy seconds, window seconds) of the reduced trace `rec` with the
    intervals of the harness phases named in `labels` taken out of both."""
    W = rec["window_s"]
    cut = _union((max(a, 0.0), min(a + d, W)) for label, a, d in
                 rec["phases"] if label in labels)
    busy = _union((max(o["t"], 0.0), min(o["t"] + o["dur"], W))
                  for o in rec["ops"])
    overlap, j = 0.0, 0
    for a, b in busy:
        while j < len(cut) and cut[j][1] <= a:
            j += 1
        k = j
        while k < len(cut) and cut[k][0] < b:
            overlap += min(b, cut[k][1]) - max(a, cut[k][0])
            k += 1
    return (sum(b - a for a, b in busy) - overlap,
            W - sum(b - a for a, b in cut))


def breakdown(rec: dict, top: int = 10) -> dict:
    """The top device operations by summed seconds and the longest idle
    gaps by the harness phase open across them (summed per phase)."""
    by_op = {}
    for o in rec["ops"]:
        by_op[o["name"]] = by_op.get(o["name"], 0.0) + o["dur"]
    gaps = {}
    for label, s in rec["idle"]:
        gaps[label] = gaps.get(label, 0.0) + s
    return {"device_ops": sorted(([k[:120], v] for k, v in by_op.items()),
                                 key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                key=lambda kv: -kv[1])[:top]}
