"""prep_ms.batch: host ms of the port's `prep` span inside a call to
synthesize_batch, from the frontend's end to the call's return (padding,
route, lattices, tables and their upload, the schedule, the enqueue, the
output slices); the median over the window's calls. Layer: routing,
tables, schedule. Moves batch_xrt."""

import importlib.util
import statistics
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench.metrics.idle_frontend__batch",
    Path(__file__).with_name("idle_frontend.batch.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(rec):
    ms = [(c["prep"][1] - c["prep"][0]) * 1e3
          for c in _spans.calls(rec, on_trace=False) or () if "prep" in c]
    return (statistics.median(ms), "ms") if ms else None
