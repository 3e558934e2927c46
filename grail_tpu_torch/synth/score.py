"""Score: the fixed-shape utterance representation.

The reference streams SequenceElems one at a time through a pull-based state
machine. The device path instead takes the whole utterance as a *parameter
score*: one SynthesisElem table row per timed element plus lengths/blend
lengths/sound flags, padded with zero-length elements so a batch shares one
element count. Everything here is numpy on the host (a copy of
grail_tpu/synth/score.py); synth/kernel_fused.build_tables uploads it once,
and Score.to moves it to a device whole for the sequencer.

Corresponds to: Selector output stream (reference src/lib.rs:978-1022) and
SequenceElem (src/lib.rs:813-835).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..core.constants import NUM_FORMANTS
from ..runtime.native import native_drift_boundaries
from ..text.intonate import PhonemeElem
from ..text.phonemes import is_sound, sound_index
from .elem import SynthesisElem


class Score(NamedTuple):
    """Timed synthesis-element sequence. Leading dims: [..., E]."""

    elem: SynthesisElem       # [..., E, (8)] element params (freq stamped)
    has_sound: np.ndarray     # [..., E] bool — False = silence/stop/undefined
    length: np.ndarray        # [..., E] seconds (0 = padding)
    blend_length: np.ndarray  # [..., E] seconds
    # [..., E] f32 cumulative end-times: the SEQUENTIAL host f32 cumsum of
    # `length`, computed ONCE at construction (Score.build). Every consumer
    # reads this, so the element boundary n_j = floor(cum_length_j * sr)
    # comes from one source.
    cum_length: np.ndarray

    @staticmethod
    def build(elem, has_sound, length, blend_length) -> "Score":
        """Construct a Score, deriving cum_length on the host. `length`
        must be concrete (host array); all construction paths are."""
        cum = np.cumsum(np.asarray(length, np.float32),
                        axis=-1).astype(np.float32)
        return Score(elem, has_sound, length, blend_length, cum)

    @property
    def num_elems(self):
        return self.length.shape[-1]

    def total_seconds(self):
        """Seconds of each utterance: the float32 sum of `length` over the
        last axis (padding elements count 0), a tensor for a Score on a
        device (Score.to), else a numpy value."""
        if isinstance(self.length, torch.Tensor):
            return self.length.to(torch.float32).sum(-1)
        return np.sum(np.asarray(self.length, np.float32), axis=-1,
                      dtype=np.float32)

    def to(self, device) -> "Score":
        """Every leaf as a tensor on `device`: has_sound bool, the rest
        float32 (the sequencer's input, synth/sequencer.py)."""
        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        return Score(elem=self.elem.to(device),
                     has_sound=torch.as_tensor(np.asarray(self.has_sound,
                                                          bool),
                                               device=device),
                     length=f32(self.length),
                     blend_length=f32(self.blend_length),
                     cum_length=f32(self.cum_length))


def _reference_boundary_samples(lengths, sample_rate: float,
                                t0: float = 0.0):
    """Exact element end-samples of the reference's f32 countdown, from the
    native closed form (runtime/native.native_drift_boundaries:
    gt_drift_boundaries in runtime/csrc/drift.cpp, a float32 binade at a
    time), bit-equal to the stepwise loop
    (native_drift_boundaries_stepwise) and to the numpy twin below, which
    stay as the tests' other side. Returns (cumulative end samples [E]
    int64, residuals [E] f32)."""
    return native_drift_boundaries(np.asarray(lengths, np.float32),
                                   sample_rate, t0)


def _reference_boundary_samples_np(lengths, sample_rate: float,
                                   t0: float = 0.0):
    """Exact element end-samples of the reference's f32 countdown.

    The reference Sequencer decrements `time` by 1/sr in f32 EVERY sample
    (src/lib.rs:859-887), accumulating rounding drift that shifts element
    boundaries by several samples per second relative to the drift-free
    floor(cumsum*sr). That shift is OBSERVABLE: a boundary landing one
    sample off at a silence<->sound transition changes the carrier
    frequency (0.25 vs ~0.003) for that sample, permanently displacing the
    carrier phase by up to a quarter cycle — measured -14 dB vs the
    reference on plosive-bearing text when we used exact boundaries.

    np.subtract.accumulate over float32 performs the same sequential
    rounding as the reference's per-sample subtraction, so each element's
    crossing (and the residual carried into the next element via
    `time += length`, same op order as src/lib.rs:864-887) is reproduced
    bit-exactly without a Python per-sample loop.

    `t0` seeds the countdown with a residual carried from earlier elements
    (streaming sessions rebase their rolling score; passing the residual at
    the rebase point keeps the remaining boundaries bit-identical to the
    continuous, never-rebased stream). Returns (cumulative end samples
    [E] int64, per-element residuals [E] f32 — residuals[i] is the t0 for
    a stream continuing after element i).
    """
    sr = np.float32(sample_rate)
    dt = np.float32(np.float32(1.0) / sr)
    t = np.float32(t0)
    counts = []
    residuals = []
    for L in lengths:
        if not np.isfinite(L):
            raise ValueError(f"element length must be finite, got {L}")
        # the advance happens inside a sample step: time -= dt (crossing
        # below 0), then time += next element's length
        t = np.float32(np.float32(t - dt) + np.float32(L))
        if t < 0:
            counts.append(1)   # element consumed within its entry sample
            residuals.append(t)
            continue
        count = 1              # the entry sample
        cap = int(float(L) * float(sr)) + 8
        while True:            # drift can make an element LONGER than its
            seq = np.subtract.accumulate(      # nominal L*sr: extend until
                np.concatenate([np.float32([t]),   # the crossing is found
                                np.full(cap, dt, np.float32)])
                .astype(np.float32), dtype=np.float32)
            neg = np.nonzero(seq < 0)[0]
            if len(neg):
                stop = int(neg[0])    # seq[stop] < 0; seq[:stop] all >= 0
                count += stop - 1     # seq[0] == t was already counted
                t = seq[stop - 1]     # last value still >= 0
                break
            count += cap
            if seq[-1] == t:
                # no progress: past ~256 s of remaining time (44.1 kHz) the
                # f32 subtraction t - dt is a no-op, so the crossing is
                # unreachable — the reference iterator itself would spin on
                # this element forever. Raise instead of hanging the host.
                raise ValueError(
                    f"element length {float(L):.1f}s stalls the reference's "
                    f"f32 countdown at t={float(t):.1f}s (dt is below half "
                    "an ulp); the reference sequencer would never advance "
                    "past it — split the element")
            t = seq[-1]
            cap = 1 << 14
        counts.append(count)
        residuals.append(t)
    return (np.cumsum(np.asarray(counts, np.int64)),
            np.asarray(residuals, np.float32))


def _lengths_hitting_boundaries(n_ref: np.ndarray,
                                sample_rate: float,
                                zero_blend: np.ndarray | None = None,
                                ) -> np.ndarray:
    """Element lengths (f32) whose f32 cumsum floors to exactly n_ref.

    Targets the middle of each sample bin, then nudges by ulps where f32
    cumsum rounding slips a bin (sub-sample adjustments: <23 us at 44.1k).

    `zero_blend[i]` marks elements authored with blend_length == 0. The
    reference computes alpha = (time/0).min(1): +inf -> 1 for time > 0, and
    at a sample where time == 0.0 EXACTLY, 0/0 = NaN and Rust's
    f32::min(NaN, 1) returns 1 — so a zero-blend element holds its
    parameters at EVERY sample, including an exact-grid boundary hit
    (src/lib.rs:899 + Rust f32::min NaN semantics). Our device paths use a
    tiny positive epsilon instead of 0 (min(t/eps, 1) — no inf/NaN on the
    device), which is identical for t > 0 but yields alpha = 0 at t == 0. So
    for zero-blend elements we additionally nudge the cumulative time OFF
    the device's f32 sample grid (c != f32(f32(k)*dt) for every in-element
    sample k), guaranteeing t > 0 on device — the epsilon path then
    reproduces the reference's NaN->hold exactly, at zero device cost."""
    sr = np.float32(sample_rate)
    dt = np.float32(np.float32(1.0) / sr)   # the device's step (build_tables' dt)

    def grid_hit(c: np.float32, n: int) -> bool:
        # does any in-element sample k (selection index still this element
        # at k <= n) satisfy the device's s_k == c exactly?
        return any(np.float32(np.float32(k) * dt) == c
                   for k in range(max(1, n - 3), n + 1))

    out = np.empty(len(n_ref), np.float32)
    c = np.float32(0.0)
    warned = False
    for i in range(len(n_ref)):
        n = int(n_ref[i])
        target = (n + 0.5) / float(sample_rate)
        # pick the f32 CUMULATIVE time nc with floor(nc*sr) == n, stepping
        # at nc's own ulp — correcting the element LENGTH by its (much
        # smaller) ulp stalls once the cumulative time is large, which is
        # exactly when long rolling scores / long-form texts need this
        nc = np.float32(target)
        for _ in range(8):
            b = int(np.floor(nc * sr))
            if b == n:
                break
            nc = np.nextafter(nc, np.float32(np.inf if b < n else -np.inf),
                              dtype=np.float32)
        if zero_blend is not None and zero_blend[i]:
            # avoid the exact device grid by nudging UP only (keeps t > 0
            # at the hit sample, so the epsilon blend holds the element —
            # the reference's NaN->hold). Nudging DOWN can never help: it
            # makes t negative at the hit sample, which the sequencer's
            # alpha clamp maps to the same alpha = 0 corner as the grid
            # value itself (and before that clamp existed it EXPLODED:
            # t = -1 ulp over the 1e-12 epsilon gave alpha ~ -1.5e7, a
            # full-scale one-sample click). If up would slip the bin, keep
            # the grid value: boundary exactness outranks the sub-sample
            # alpha corner, which is then genuinely unrepresentable (the
            # reference itself sits on that grid).
            for _ in range(8):
                if not grid_hit(nc, n):
                    break
                up = np.nextafter(nc, np.float32(np.inf), dtype=np.float32)
                if int(np.floor(up * sr)) != n:
                    break
                nc = up
        # then the length that lands the f32 cumsum exactly on nc
        l = np.float32(np.float64(nc) - np.float64(c))
        for _ in range(8):
            got = np.float32(c + l)
            if got == nc:
                break
            l = np.float32(np.float64(l)
                           + (np.float64(nc) - np.float64(got)))
        c = np.float32(c + l)
        b = int(np.floor(c * sr))
        if b != n:
            # Unreachable boundary: past ~190 s of cumulative f32 time the
            # f32 grid is coarser than one sample bin, so SOME boundaries
            # have no representable cumsum (nothing any retarget can do).
            # Desynchronizing silently would defeat the bit-alignment this
            # machinery exists for, but crashing would kill a live serving
            # session over a sub-sample, minutes-out boundary — warn loudly
            # once and carry the closest representable boundary.
            if not warned:
                import warnings

                warnings.warn(
                    f"boundary retarget off by {b - n} sample(s) at element "
                    f"{i} (cumulative {float(c):.1f}s: f32 grid coarser "
                    "than the sample bin); carrying closest boundary",
                    RuntimeWarning, stacklevel=2)
                warned = True
        out[i] = l
    return out


def merge_glides(phoneme_elems: Sequence[PhonemeElem]) -> list:
    """GLIDE frontend preprocessing: a Glide element extends the previous
    element by the glide's duration and stretches its crossfade over that
    span, so surrounding phonemes blend directly instead of dipping through
    silence (the reference documents this intent at src/lib.rs:642-644 but
    leaves Glide unimplemented). Shared by the fast path's score construction
    AND oracle_pipeline so fidelity comparisons see the same element
    stream — the merge is frontend preprocessing, upstream of the
    reference-semantics DSP."""
    from ..text.phonemes import Phoneme as _P

    merged: list = []
    for pe in phoneme_elems:
        if int(pe.phoneme) == int(_P.GLIDE) and merged:
            prev = merged[-1]
            merged[-1] = PhonemeElem(prev.phoneme,
                                     prev.length + pe.length,
                                     pe.length + 0.5 * prev.blend_length,
                                     prev.frequency)
        else:
            merged.append(pe)
    return merged


def score_from_phoneme_elems(
    phoneme_elems: Sequence[PhonemeElem],
    voice,
    pad_to: int | None = None,
    n_ref: np.ndarray | None = None,
    drift_t0: float = 0.0,
) -> Score:
    """Host-side Selector: phoneme stream -> Score (reference src/lib.rs:987-1006).

    Looks up each phoneme's SynthesisElem in the voice table, stamps the
    intonator's frequency (copy_with_frequency semantics incl. the 0.5
    Nyquist clamp), and marks specials/undefined phonemes as silent.

    GLIDE markers (reference src/lib.rs:642-644: "blend the next phoneme
    into the other seamlessly, useful for indicating diphthongs" — left
    unimplemented there) are realized here: a Glide element extends the
    previous element by the glide's duration and stretches its crossfade
    over that span, so the surrounding phonemes blend directly instead of
    dipping through silence.

    `n_ref` (optional) supplies precomputed reference boundary samples for
    the (already glide-merged) element list, skipping the O(total samples)
    drift simulation — streaming sessions cache it per score revision.
    `drift_t0` seeds the drift simulation's countdown residual (see
    _reference_boundary_samples) when n_ref is not given.
    """
    phoneme_elems = merge_glides(phoneme_elems)
    E = len(phoneme_elems)
    Epad = max(pad_to or E, E, 1)

    table = voice.table  # SynthesisElem [P, ...]
    defined = np.asarray(voice.defined)

    idx = np.zeros(E, np.int32)
    has_sound = np.zeros(E, bool)
    freq = np.zeros(E, np.float32)
    length = np.zeros(E, np.float32)
    blend = np.full(E, 1.0, np.float32)

    # boundary alignment: author lengths are re-targeted (sub-sample
    # nudges) so the closed-form integer boundaries land exactly where the
    # reference's drifting f32 countdown puts them — see
    # _reference_boundary_samples_np for why this is audible
    if E:
        if n_ref is None:
            n_ref, _ = _reference_boundary_samples(
                [pe.length for pe in phoneme_elems],
                float(voice.sample_rate), t0=drift_t0)
        assert len(n_ref) == E, "n_ref must cover the glide-merged elements"
        adj_lengths = _lengths_hitting_boundaries(
            n_ref, float(voice.sample_rate),
            zero_blend=np.asarray(
                [pe.blend_length == 0 for pe in phoneme_elems]))

    for i, pe in enumerate(phoneme_elems):
        p = int(pe.phoneme)
        snd = is_sound(p) and bool(defined[sound_index(p)])
        idx[i] = sound_index(p) if is_sound(p) else 0
        has_sound[i] = snd
        freq[i] = min(np.float32(pe.frequency), np.float32(0.5))
        length[i] = adj_lengths[i]
        # blend_length 0 means "no crossfade, hold until the boundary"
        # (reference: time/0 = inf -> alpha clamps to 1, and at time == 0.0
        # exactly, 0/0 = NaN with Rust f32::min(NaN, 1) = 1 — still hold).
        # A tiny epsilon keeps alpha = min(t/eps, 1) = 1 without inf/NaN on
        # device; t == 0 can never occur because the boundary retarget
        # steers zero-blend elements' cumulative time off the device's f32
        # sample grid (see _lengths_hitting_boundaries), so the epsilon
        # path reproduces the reference's NaN->hold exactly.
        blend[i] = pe.blend_length if pe.blend_length > 0 else 1e-12

    # pure numpy on the host path: no eager device ops, no per-call compiles
    gathered = SynthesisElem(*(np.asarray(f)[idx] for f in table))
    gathered = gathered._replace(frequency=freq)

    # padding rows come from pad_score — ONE implementation of the padding
    # convention (its docstring promises bit-identity with this function)
    return pad_score(Score.build(
        elem=gathered,
        has_sound=has_sound,
        length=length,
        blend_length=blend,
    ), Epad)


def pad_score(score: Score, pad_to: int) -> Score:
    """Append zero-length padding rows to an existing single-utterance
    Score — bit-identical to building with score_from_phoneme_elems(
    pad_to=...), without re-running the text frontend (the batch path
    previously re-transcribed + re-intonated every non-longest utterance
    just to add padding rows)."""
    E = score.num_elems
    k = int(pad_to) - E
    if k <= 0:
        return score
    padq = np.full((k, NUM_FORMANTS), 0.25, np.float32)
    padz = np.zeros((k, NUM_FORMANTS), np.float32)
    pad_elem = SynthesisElem(np.zeros(k, np.float32),
                             padq, padq, padq, padz, padz, padz)
    elem = SynthesisElem(*(np.concatenate([np.asarray(g), p], axis=0)
                           for g, p in zip(score.elem, pad_elem)))
    cum = np.asarray(score.cum_length, np.float32)
    # zero-length padding: cum + 0.0 == cum exactly, so the padded rows
    # repeat the final end-time (E == 0: no end-time yet, pad with zeros)
    tail = (np.full(k, cum[-1], np.float32) if E
            else np.zeros(k, np.float32))
    return Score(
        elem=elem,
        has_sound=np.concatenate(
            [np.asarray(score.has_sound), np.zeros(k, bool)]),
        length=np.concatenate(
            [np.asarray(score.length, np.float32), np.zeros(k, np.float32)]),
        blend_length=np.concatenate(
            [np.asarray(score.blend_length, np.float32),
             np.full(k, 1.0, np.float32)]),
        cum_length=np.concatenate([cum, tail]),
    )


def stack_scores(scores: Sequence[Score]) -> Score:
    """Stack single-utterance scores (same E) into a batched [B, E] score."""
    elems = SynthesisElem(*(np.stack([np.asarray(f) for f in fs])
                            for fs in zip(*(s.elem for s in scores))))
    return Score(
        elem=elems,
        has_sound=np.stack([np.asarray(s.has_sound) for s in scores]),
        length=np.stack([np.asarray(s.length) for s in scores]),
        blend_length=np.stack([np.asarray(s.blend_length) for s in scores]),
        cum_length=np.stack([np.asarray(s.cum_length) for s in scores]),
    )


__all__ = ["Score", "score_from_phoneme_elems", "pad_score", "stack_scores"]
