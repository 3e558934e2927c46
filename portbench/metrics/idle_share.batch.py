"""idle_share.batch: the share of the traced window in which no operation
ran on the device (kernels, copies and sets, torch.profiler), in %, with
the harness's own frontend probe (frontend_ms.batch's timing, which
untraced runs do not make) taken out of the window and of the busy time.
Layer: device. Moves batch_xrt."""

from portbench.trace import outside


def read(rec):
    tr = rec.get("trace")
    if rec.get("entry") != "batch" or not tr:
        return None
    busy, window = outside(tr, ("frontend_probe",))
    if window <= 0:
        return None
    return 100.0 * (1.0 - busy / window), "%"
