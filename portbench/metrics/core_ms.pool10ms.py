"""core_ms.pool10ms: host ms of the port's `core` stage of the xla tick
(the enqueue of synthesize._block_core, the associative-scan core, in the
pool's `launch` span); the median over the window's ticks. Layer: xla tick.
Moves batch_xrt.

It reads the port's in-memory spans, every span of the window (see
tick_host_ms.pool); a port without the xla tick's stages reads as
nothing."""

import statistics


def read(rec):
    ms = [(s.end_ns - s.start_ns) * 1e-6 for s in rec.get("port_spans", ())
          if rec.get("entry") == "pool" and s.name == "core"
          and s.parent == "launch"]
    return (statistics.median(ms), "ms") if ms else None
