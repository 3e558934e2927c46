"""launches_tick.pool10ms: device operations (kernels, copies and sets,
torch.profiler) in the traced window over the pool ticks dispatched in it:
on the xla tick its two seq_scan.cu launches and the plain PyTorch
sequencer, jitter and associative-scan core, one kernel an operation, with
the output conversion, the pinned copy and the feeds' scatters. Layer:
device. Moves batch_xrt.

It reads the device trace alone, so a port without the xla tick's spans
reads too."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("entry") != "pool" or not tr or not rec.get("ticks"):
        return None
    return len(tr["ops"]) / rec["ticks"], "count"
