"""fetch_ms.batch: host ms of the `.cpu()` of one batch's outputs; the
median over the window's batches. Layer: device to host. Moves batch_xrt."""

import statistics


def read(rec):
    ms = [(b - a) * 1e3 for label, a, b in rec.get("spans", ())
          if rec.get("entry") == "batch" and label == "fetch"]
    return (statistics.median(ms), "ms") if ms else None
