"""tick_roofline.pool: the least time of the window's delivered samples
over the summed device time of every kernel in the traced window
(torch.profiler: the carry launches, the output conversion, the scatters
of the uploads), in %. Layer: kernels. Moves batch_xrt.

The least time is the larger of the operations over the card's peak FP32
instruction rate and the output bytes over its memory rate
(roofline/peaks.json), for every session-sample delivered to the host:

  * operations: roofline/counts.py's CHAIN_F32 (the chain with the exact
    f32 carrier, which a stream always takes) plus PCM16_OPS, the 16-bit
    conversion of a sample: the scale, the two sides of the saturation,
    the NaN select and the truncating convert;
  * bytes: each output sample written once, 2 bytes of int16 (the tables
    and the carried rows are read once a tick and are small beside it).

The carry tick's own jitter recurrence is not counted, as counts.py
explains for every cell: the reference reads a precomputed schedule."""

from portbench.roofline.counts import CHAIN_F32, PEAKS

PCM16_OPS = 5
OUT_BYTES = 2


def least_seconds(samples: int) -> float:
    ops = (CHAIN_F32 + PCM16_OPS) * float(samples)
    return max(ops / PEAKS["fp32_instructions_per_s"],
               OUT_BYTES * float(samples) / PEAKS["hbm_bytes_per_s"])


def read(rec):
    tr = rec.get("trace")
    if rec.get("entry") != "pool" or not tr or rec.get("output") != "pcm16":
        return None
    dev = sum(o["dur"] for o in tr["ops"] if o["cat"] == "kernel")
    least = least_seconds(rec["samples"])
    if dev <= 0 or least <= 0:
        return None
    return 100.0 * least / dev, "%"
