"""idle_frontend.batch: the share of the traced window in which no
operation ran on the device while the port's `frontend` span was open
inside a call to synthesize_batch, in %; window and device time as
idle_share.batch takes them (the frontend probe out of both), so this is a
part of that share. Layer: device. Moves batch_xrt.

The port records its spans in memory (grail_tpu_torch/runtime/trace.py)
while a profiler records; this file also holds what the four span readers
share (frontend_span_ms.batch, prep_ms.batch and idle_prep.batch load it):
`calls` pairs the i-th `batch` root with the harness's i-th `program`
phase, which opens on the same thread just before it, and puts every span
of the call on that phase's clock: the phase's start plus the span's start
less the root's. A port without spans, or calls that do not pair off,
read as nothing.
"""

from portbench.trace import outside

GRACE = 10e-6      # a root may outlast its phase by the trace's rounding
LAG = 1e-3         # and fall short of it by at most this


def _port_spans():
    try:
        from grail_tpu_torch.runtime import trace
    except ImportError:            # a port without spans
        return None
    return trace.spans()


def _one_thread(intervals):
    """The harness's own phases: each starts after the one before it ended
    (a phase's range that the profiler also draws on a device row overlaps
    the host's and is left out)."""
    out = []
    for a, b in sorted(intervals):
        if not out or a >= out[-1][1]:
            out.append((a, b))
    return out


def calls(rec, on_trace: bool):
    """Each call of the window as {span name: (start, end)} in seconds on
    the clock of the harness's phases: the host clock of rec["spans"], or
    with `on_trace` the reduced trace's; None where there are no spans or
    the roots and the `program` phases do not pair off."""
    got = _port_spans()
    if rec.get("entry") != "batch" or not got:
        return None
    if on_trace:
        if not rec.get("trace"):
            return None
        phases = _one_thread((a, a + d) for label, a, d in
                             rec["trace"]["phases"] if label == "program")
    else:
        phases = [(a, b) for label, a, b in rec.get("spans", ())
                  if label == "program"]
    roots = [s for s in got if s.parent is None and s.name == "batch"]
    if not roots or len(roots) != len(phases):
        return None
    by_call = {}
    for s in got:
        by_call.setdefault(s.call, []).append(s)
    out = []
    for root, (a, b) in zip(roots, phases):
        length = (root.end_ns - root.start_ns) * 1e-9
        if not b - a - LAG <= length <= b - a + GRACE:
            return None
        out.append({s.name: (a + (s.start_ns - root.start_ns) * 1e-9,
                             a + (s.end_ns - root.start_ns) * 1e-9)
                    for s in by_call[root.call]})
    return out


def idle_under(rec, name: str):
    """The share of the window (as idle_share.batch's) in which the device
    ran nothing while a span `name` of a call was open, in %."""
    got = calls(rec, on_trace=True)
    tr = rec.get("trace")
    opened = [(name, c[name][0], c[name][1] - c[name][0])
              for c in got or () if name in c]
    if not opened:
        return None
    _, window = outside(tr, ("frontend_probe",))
    if window <= 0:
        return None
    # the spans as phases of a record of their own: outside() then gives
    # the device time outside them, and the window that they leave
    spans_rec = {"window_s": tr["window_s"], "ops": tr["ops"],
                 "phases": opened}
    busy_all, _ = outside(spans_rec, ())
    busy_out, rest = outside(spans_rec, (name,))
    open_s = tr["window_s"] - rest
    return 100.0 * (open_s - (busy_all - busy_out)) / window, "%"


def read(rec):
    return idle_under(rec, "frontend")
