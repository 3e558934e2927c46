"""full_pass.pool: the share of the window's pool ticks whose `host` span
ran the full maintenance pass (attribute `full`: a session mutated since
the last pass, by a feed, a rebase or a lattice slide, or one crossed its
quiet horizon) instead of the fast path's one compare, in %. Layer: pool
host pass. Moves batch_xrt.

It reads the port's in-memory spans, every span of the window (see
tick_host_ms.pool); a port without the pool's spans reads as nothing."""


def read(rec):
    full = [bool(s.attrs.get("full")) for s in rec.get("port_spans", ())
            if rec.get("entry") == "pool" and s.name == "host"
            and s.parent == "tick"]
    return (100.0 * sum(full) / len(full), "%") if full else None
