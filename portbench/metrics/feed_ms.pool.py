"""feed_ms.pool: host ms of feeding one text to a pool session: the
port's `feed` root of StreamPool.feed (attribute what 'feed': the session's
incremental transcription and intonation, the glide merge at append) plus
that of the StreamPool.flush of the same session that follows it (what
'flush': the held-back characters); the median over the window's fed
texts. Layer: session frontend. Moves batch_xrt.

It reads the port's in-memory spans, every span of the window (see
tick_host_ms.pool); a port without the pool's spans reads as nothing."""

import statistics


def read(rec):
    if rec.get("entry") != "pool":
        return None
    texts, last = [], {}
    for s in rec.get("port_spans", ()):
        if s.name != "feed" or s.parent is not None:
            continue
        ms = (s.end_ns - s.start_ns) * 1e-6
        i = s.attrs.get("session")
        if s.attrs.get("what") == "feed":
            last[i] = len(texts)
            texts.append(ms)
        elif i in last:
            texts[last.pop(i)] += ms
    return (statistics.median(texts), "ms") if texts else None
