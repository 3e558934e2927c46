"""launch_ms.pool10ms: host ms of the port's `launch` span on the xla tick
(attribute `program` 'xla': the enqueue of the tick's five stages and the
output conversion, and the offsets' advance); the median over the window's
ticks. Layer: xla tick. Moves batch_xrt.

It reads the port's in-memory spans, every span of the window (see
tick_host_ms.pool); a port whose `launch` span has no `program` reads as
nothing."""

import statistics


def read(rec):
    ms = [(s.end_ns - s.start_ns) * 1e-6 for s in rec.get("port_spans", ())
          if rec.get("entry") == "pool" and s.name == "launch"
          and s.parent == "tick" and s.attrs.get("program") == "xla"]
    return (statistics.median(ms), "ms") if ms else None
