"""idle_prep.batch: the share of the traced window in which no operation
ran on the device while the port's `prep` span was open inside a call to
synthesize_batch (padding, route, lattices, tables and their upload, the
schedule, the enqueue, the output slices), in %; a part of
idle_share.batch, as idle_frontend.batch is. Layer: device. Moves
batch_xrt."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench.metrics.idle_frontend__batch",
    Path(__file__).with_name("idle_frontend.batch.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(rec):
    return _spans.idle_under(rec, "prep")
