"""track_ms.solo: host ms of the port's `track` span inside a call to
synthesize (the host carrier pre-pass of an utterance past 30 s: the
memo's look-up and, on a miss, the native per-sample phase recurrence);
the median over the window's calls that took the track route. Layer: host
carrier pre-pass. Moves batch_xrt."""

import importlib.util
import statistics
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench.metrics.idle_track__solo",
    Path(__file__).with_name("idle_track.solo.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(rec):
    ms = [(c["track"][1] - c["track"][0]) * 1e3
          for c in _spans.calls(rec, on_trace=False) or () if "track" in c]
    return (statistics.median(ms), "ms") if ms else None
