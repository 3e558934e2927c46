"""tick_host_ms.pool: host ms of the port's `host` span in a pool tick
(StreamPool._prepare_tick: the quiet fast path's one compare, or the full
pass over every session and the uploads it decides); the median over the
window's ticks. Layer: pool host pass. Moves batch_xrt.

It reads the port's in-memory spans (grail_tpu_torch/runtime/trace.py),
which the pool entry copies after a traced window and which then hold
every span of that window: four a tick and two a fed text, 15-17k in a
51-s traced window on the card (PERF.md section 5), under trace.MAXLEN
(65,536). A port without the pool's spans reads as nothing."""

import statistics


def read(rec):
    ms = [(s.end_ns - s.start_ns) * 1e-6 for s in rec.get("port_spans", ())
          if rec.get("entry") == "pool" and s.name == "host"
          and s.parent == "tick"]
    return (statistics.median(ms), "ms") if ms else None
