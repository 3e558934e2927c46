"""synth_roofline.batch: the least time of the window's calls (roofline/
counts.py: each batch's true samples under the carrier its semantics
demand) over the summed device time of every kernel launched inside the
calls to synthesize_batch (torch.profiler), in %. Layer: kernels. Moves
batch_xrt."""

from portbench.roofline.counts import least_seconds


def read(rec):
    tr = rec.get("trace")
    if rec.get("entry") != "batch" or not tr or not rec.get("carrier"):
        return None
    dev = sum(o["dur"] for o in tr["ops"]
              if o["cat"] == "kernel" and o["phase"] == "program")
    work = rec["work"][:len(rec["carrier"])]
    least = sum(least_seconds(kind, w["samples"], "f32")
                for w, kind in zip(work, rec["carrier"]))
    if dev <= 0 or least <= 0:
        return None
    return 100.0 * least / dev, "%"
