"""frontend_span_ms.batch: host ms of the port's `frontend` span inside a
call to synthesize_batch (text_to_phoneme_elems and
score_from_phoneme_elems over the batch's texts); the median over the
window's calls. Layer: host frontend. Moves batch_xrt."""

import importlib.util
import statistics
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench.metrics.idle_frontend__batch",
    Path(__file__).with_name("idle_frontend.batch.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(rec):
    ms = [(c["frontend"][1] - c["frontend"][0]) * 1e3
          for c in _spans.calls(rec, on_trace=False) or () if "frontend" in c]
    return (statistics.median(ms), "ms") if ms else None
