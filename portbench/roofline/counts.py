"""Operations per audio sample of the reference's math, and the least time.

Counted from reference/plain/synth/fused.py as the least that a correct
implementation of those semantics needs per lane and true audio sample:
one per arithmetic operation, comparison or select (float and integer
alike, at the FP32 instruction rate; a division counts one; a gather
counts none: its bytes are what it costs), under two rules:

  * what is constant over an element of the score (its flags, which of
    the pick's cases holds, the difference of the two elements' values,
    the reciprocal of its blend length) or over a cell of the jitter
    schedule (the difference of two lattice rows) is worked out once per
    element or cell and counts nothing per sample; so a pick is one lerp
    (a multiply and an add), and the element index is a walking index
    (one compare and the sample counter's step a sample; the rare advance
    is per element), not the reference's search;
  * only true samples are counted (see below), so the `valid` mask, and
    the products by it, are 1 and count nothing.

The least time of a call is the larger of

    ops_per_sample * true samples / peak instructions per second
    bytes that must move / peak memory bytes per second,

where the true samples are the audio the call delivers: no padding, no
overlap-save pre-roll, no split. The bytes that must move are each output
sample written once (the tables are read once and are tiny beside it).

How these relate to chip_smoke.py's counts (counted there from the kernel
sources, per lane-sample, so a rewrite of a kernel would change them):
  * FUSED_OPS (751) + SEQ_OPS (18) + ELEM_OPS (2), the chain as kernel 1
    runs it with a walking index (~771; PERF.md's "~784" adds the 3 a step
    of the binary search kernel 1 used before): CHAIN_F32 / CHAIN_Q32 below
    are 690 / 693, lower because the per-element parts of the picks, of
    the sound flags and of the valid mask are hoisted out of the sample;
  * PRE_OPS (3) and ELEM_OPS (2) also count kernel 2's pre-pass, which
    exists only because the kernel splits an utterance; the reference does
    not split, so it has no counterpart here (the true work is one chain);
  * JITTER_OPS (4) is the carry tick's own jitter recurrence, and
    TRACK_OPS (FUSED_OPS - 10 + 1) the chain reading a host carrier track:
    neither is a chain the cells' semantics demand, so neither is counted.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())

# phases A-B, per lane-sample: the walking element index 3 (the compare
# with the element's end, the step of the sample counter, its conversion
# to float); blend alpha 5 (the sample's time 1, its distance from the
# element's end 1, times the reciprocal of the blend length 1, the clamp to
# [0, 1] 2); the frequency pick 2 (a lerp); the pitch jitter 2 (the lattice
# rows' lerp at the schedule's phase); freq_j 2
SEQ = 3 + 5 + 2 + 2 + 2                                             # 14
# phase C, per lane-sample: polyBLEP 17 and the saw 3; Lehmer noise (the
# state step and its float conversion) 5
SAW_NOISE = 17 + 3 + 5                                              # 25
CARRIER_F32 = 3        # phase += f, the compare, the select of phase - 1
CARRIER_Q32 = 6        # scale, truncate, add, mask, convert, scale
# per formant: the five picks 5 x 2 and the amplitude pick 2 (lerps); the
# formant and amplitude jitter 2 + 2 (lerps); ff_j 2; am_j 4; the breath
# blend 3; exp_approx 4; the turbulence amplitude 4; tan_approx_parts 11;
# the coefficients 14; the recurrence (phase D): lp 4, b 8, c 9, b' + b 1
PER_FORMANT = 10 + 2 + 2 + 2 + 2 + 4 + 3 + 4 + 4 + 11 + 14 + 22    # 80
FORMANTS = 8
OUTPUT = 7 + 1         # the formant sum, x 0.25                           # 8

CHAIN_F32 = SEQ + SAW_NOISE + CARRIER_F32 + FORMANTS * PER_FORMANT + OUTPUT
CHAIN_Q32 = SEQ + SAW_NOISE + CARRIER_Q32 + FORMANTS * PER_FORMANT + OUTPUT

OPS_PER_SAMPLE = {"kcar": CHAIN_F32, "q32": CHAIN_Q32}
OUT_BYTES = {"f32": 4}


def least_seconds(kind: str, samples: int, out: str) -> float:
    """The least time the card could take for `samples` true audio samples
    of chain `kind` written as `out`: the larger of the operations over the
    peak instruction rate and the output bytes over the memory rate."""
    ops = OPS_PER_SAMPLE[kind] * float(samples)
    n_bytes = OUT_BYTES[out] * float(samples)
    return max(ops / PEAKS["fp32_instructions_per_s"],
               n_bytes / PEAKS["hbm_bytes_per_s"])
