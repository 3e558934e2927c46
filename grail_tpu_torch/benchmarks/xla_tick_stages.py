"""The xla tick by stage on one card, in the benchmark's 10-ms pool cell.

    python -m grail_tpu_torch.benchmarks.xla_tick_stages [SEED] [SECONDS]

Sets up portbench's `pool_en_plain_10ms.stream` (StreamPool(768) at block
441, which runs the xla tick; its feeder, its warm ticks; run from the
repo's root, which holds portbench/) and ticks it back to back as the cell
does, twice:

  * SECONDS (20) with the pool's spans kept and no profiler (the span
    buffer alone, on the host clock): the median host ms a tick of `tick`,
    `host`, `launch` and each of `launch`'s five stages (runtime/trace.py);
  * SECONDS / 2 under torch.profiler (CPU and CUDA): every device
    operation (kernel, copy, set) given to the innermost port span open on
    the thread that launched it, matched through the profiler's
    correlation ids ('' where none was open: the feeder's device work, the
    harness's): the operations and the device ms a tick of each.

One JSON line with the card's name and power limit, also written to
chiprun_out/xla_tick_stages_<SEED>.json. It gates nothing.
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
from grail_tpu_torch.benchmarks.pool_passes import _run
from grail_tpu_torch.runtime import trace

CELL = "pool_en_plain_10ms.stream"
SPANS = ("tick", "host", "launch", "jsched", "frames", "carrier", "core",
         "pack")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def spans_window(entry, seconds: float) -> dict:
    """The median host ms a tick of the pool's spans and the xla stages."""
    trace._recording, recording = (lambda: True), trace._recording
    trace.clear()
    try:
        ticks = _run(entry, seconds)
    finally:
        trace._recording = recording
    by = collections.defaultdict(list)
    for s in trace.spans():
        by[s.name].append((s.end_ns - s.start_ns) * 1e-6)
    return {"ticks": ticks, "spans": len(trace.spans()),
            "median_ms": {k: statistics.median(by[k]) for k in SPANS
                          if by[k]}}


def by_span(events) -> dict:
    """Chrome-trace events -> {innermost port span at the launch: [device
    operations, device seconds]}."""
    xs = [e for e in events if e.get("ph") == "X"]
    ranges = collections.defaultdict(list)     # tid -> [(ts, end, name)]
    for e in xs:
        name = e.get("name", "")
        if name.startswith(trace.PREFIX):
            ts = float(e["ts"])
            ranges[e.get("tid")].append(
                (ts, ts + float(e.get("dur", 0)), name[len(trace.PREFIX):]))
    starts = {}
    for tid, v in ranges.items():
        v.sort()
        starts[tid] = [a for a, _, _ in v]

    def innermost(tid, ts):
        # the latest-starting range open at ts: walk back past the siblings
        # that ended before it
        v = ranges.get(tid, ())
        i = bisect.bisect_right(starts.get(tid, ()), ts) - 1
        for j in range(i, max(i - 32, -1), -1):
            if v[j][1] >= ts:
                return v[j][2]
        return ""

    calls = {e["args"]["correlation"]: e for e in xs
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    out = collections.defaultdict(lambda: [0, 0.0])
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        call = calls.get(e.get("args", {}).get("correlation"))
        label = ("" if call is None
                 else innermost(call.get("tid"), float(call["ts"])))
        out[label][0] += 1
        out[label][1] += float(e.get("dur", 0)) * 1e-6
    return dict(out)


def profiled_window(entry, seconds: float) -> dict:
    """Device operations and device ms a tick, by the span that launched
    them."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ticks = _run(entry, seconds)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    spans = by_span(events)
    return {"ticks": ticks,
            "ops_tick": {k: v[0] / ticks for k, v in spans.items()},
            "device_ms_tick": {k: v[1] * 1e3 / ticks
                               for k, v in spans.items()}}


def main(argv) -> None:
    from portbench import harness

    seed = int(argv[0]) if argv else 4280000102
    seconds = float(argv[1]) if len(argv) > 1 else 20.0
    cell = harness.load_cell(CELL)
    entry = harness.entry_class(cell.entry)(cell, seed, "cuda")
    t = time.perf_counter()
    entry.setup()
    out = {"card": _card(), "seed": seed,
           "setup_s": time.perf_counter() - t,
           "spans": spans_window(entry, seconds),
           "profiled": profiled_window(entry, seconds / 2)}
    line = json.dumps(out)
    Path("chiprun_out").mkdir(exist_ok=True)
    Path(f"chiprun_out/xla_tick_stages_{seed}.json").write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main(sys.argv[1:])
