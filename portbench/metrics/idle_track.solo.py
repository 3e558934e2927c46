"""idle_track.solo: the share of the traced window in which no operation
ran on the device while the port's `track` span was open inside a call to
synthesize (the host carrier pre-pass, api._carrier_track_for: the memo's
look-up and, on a miss, the native per-sample phase recurrence), in %; a
part of the device's idle share (1 - busy_s / window_s). Layer: device.
Moves batch_xrt.

This file also holds what both solo readers share (track_ms.solo loads
it): `calls` pairs the i-th `batch` root of the port's spans (synthesize
is synthesize_batch of one text) with the harness's i-th `program` phase,
by order alone, and puts every span of the call on that phase's clock:
the phase's start plus the span's start less the root's. A record of
another entry, a port without spans, and roots and phases of different
counts read as nothing; so does a window in which no call took the track.
"""

import importlib.util
from pathlib import Path

from portbench.trace import outside

# the batch readers' helpers: the port's spans, the harness's own phases
_spec = importlib.util.spec_from_file_location(
    "portbench.metrics.idle_frontend__batch",
    Path(__file__).with_name("idle_frontend.batch.py"))
_batch = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_batch)


def calls(rec, on_trace: bool):
    """Each call of the window as {span name: (start, end)} in seconds on
    the clock of the harness's phases: the host clock of rec["spans"], or
    with `on_trace` the reduced trace's; None where there is nothing to
    pair."""
    got = _batch._port_spans()
    if rec.get("entry") != "solo" or not got:
        return None
    if on_trace:
        if not rec.get("trace"):
            return None
        phases = _batch._one_thread(
            (a, a + d) for label, a, d in rec["trace"]["phases"]
            if label == "program")
    else:
        phases = [(a, b) for label, a, b in rec.get("spans", ())
                  if label == "program"]
    roots = [s for s in got if s.parent is None and s.name == "batch"]
    if not roots or len(roots) != len(phases):
        return None
    by_call = {}
    for s in got:
        by_call.setdefault(s.call, []).append(s)
    return [{s.name: (a + (s.start_ns - root.start_ns) * 1e-9,
                      a + (s.end_ns - root.start_ns) * 1e-9)
             for s in by_call[root.call]}
            for root, (a, _) in zip(roots, phases)]


def read(rec):
    got = calls(rec, on_trace=True)
    opened = [("track", c["track"][0], c["track"][1] - c["track"][0])
              for c in got or () if "track" in c]
    if not opened:
        return None
    tr = rec["trace"]
    W = tr["window_s"]
    if W <= 0:
        return None
    # the spans as phases of a record of their own: outside() then gives
    # the device time outside them, and the window that they leave
    spans_rec = {"window_s": W, "ops": tr["ops"], "phases": opened}
    busy_all, _ = outside(spans_rec, ())
    busy_out, rest = outside(spans_rec, ("track",))
    open_s = W - rest
    return 100.0 * (open_s - (busy_all - busy_out)) / W, "%"
