"""idle_share.pool: the share of the traced window in which no operation
ran on the device (kernels, copies and sets, torch.profiler), in %: the
window less the union of the device operations' intervals. The window
holds the feeder and every tick. Layer: device. Moves batch_xrt."""

from portbench.trace import outside


def read(rec):
    tr = rec.get("trace")
    if rec.get("entry") != "pool" or not tr:
        return None
    busy, window = outside(tr, ())
    if window <= 0:
        return None
    return 100.0 * (1.0 - busy / window), "%"
