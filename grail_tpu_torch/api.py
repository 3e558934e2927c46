"""High-level synthesis API: text -> audio, batched, on one device.

The reference's chain (examples/cli.rs:175-184)

    chars.transcribe(lang).intonate(lang, voice).select(voice)
         .sequence(voice).jitter(seed, voice).synthesize()

runs as a host frontend (text -> timed phoneme elements -> a numpy Score
per utterance) followed by one fused synthesizer call over the padded batch
(synth/kernel_fused.py): the CUDA kernels on a GPU, their plain PyTorch
versions on the CPU. `route` decides the implementation, the carrier and
the overlap-save split in one place.

The split (`_synthesize_split`, the counterpart of grail_tpu's
_synth_jit_split_fused) runs each utterance's time axis as S segments on S
kernel lanes, so that a small batch fills the card: each segment re-derives
its filter state from a WARMUP-sample pre-roll whose output is discarded,
while the Q32 carrier phase (the pre-pass kernel's exact integral) and the
Lehmer seed (closed-form skip-ahead) continue exactly. `choose_split` picks
S from the card's resident-block capacity. On the CPU the route stays
unsplit; the split is reached there through `_synthesize_split`. Host
carrier tracks, streaming and the CLI are later slices; this API has no
argument for them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .languages import get_language
from .core.constants import LEHMER_A
from .core.rng import lehmer_skip
from .synth.jitter import JitterLattice, build_lattice
from .synth.kernel_fused import (FusedTables, build_tables, fused_synth_slots,
                                 phase_q32_pre_block, synth_fused)
from .synth.schedule import device_window
from .synth.synthesize import SynthState
from .synth.score import Score, pad_score, score_from_phoneme_elems, stack_scores
from .text.intonate import intonate
from .text.language import Language
from .text.transcribe import transcribe
from .voices import Voice, get_voice

BLOCK_SIZE = 4096   # utterance lengths pad to a multiple of this
WARMUP = 4096       # overlap-save pre-roll (the IIRs forget in ~200 samples)
MAX_SPLIT = 128     # largest segment count choose_split considers

# Auto exact-carrier duration gate (the JAX package's value): the Q32
# carrier's residual against the reference's f32 recurrence grows with
# duration, so past 30 s the exact f32 carrier runs in the kernel.
EXACT_CARRIER_AUTO_SECONDS = 30.0

# 'kernel' is kept as another name for True, so that calls written for
# grail_tpu (whose host-track modes this port does not have) run unchanged
_EXACT_CARRIER_CHOICES = (None, True, False, "kernel")


def _resolve_voice(voice) -> Voice:
    return get_voice(voice) if isinstance(voice, str) else voice


def _seeds(seeds, B: int) -> list:
    seeds = [0] * B if seeds is None else [int(sd) for sd in seeds]
    if len(seeds) != B:
        raise ValueError(f"{len(seeds)} seeds for {B} utterances")
    return seeds


def _per_item(value, B: int, what: str) -> list:
    """One value for the batch, or a list/tuple of one per item."""
    if isinstance(value, (list, tuple)):
        if len(value) != B:
            raise ValueError(f"{len(value)} {what}s for {B} utterances")
        return list(value)
    return [value] * B


def _resolve_language(language) -> Language:
    return get_language(language) if isinstance(language, str) else language


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch finds no CUDA device; the plain "
                "PyTorch path runs only when asked for with device='cpu'")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def choose_split(B: int, maxN: int, slots: int):
    """Overlap-save split decision for the card: (segments per utterance S,
    padded length T), with T % (S * BLOCK_SIZE) == 0.

    `slots` is how many blocks of the fused kernel the card holds at once.
    A block's time grows with its length and the kernel's time is flat in
    the number of blocks up to `slots` (PERF.md), so the estimated time is
    waves x samples per lane:

        S = 1:  ceil(B / slots) * round_up(maxN, BLOCK_SIZE)
        S > 1:  ceil(S*B / slots) * (T_S / S + WARMUP),
                T_S = round_up(maxN, S * BLOCK_SIZE)

    over powers of two S up to MAX_SPLIT; ties go to the smaller S. A batch
    of at least `slots` utterances fills the card unsplit and stays so: a
    split would only add pre-roll work."""
    if B < 1 or slots < 1:
        raise ValueError(f"need B >= 1 and slots >= 1, got {B}, {slots}")
    n = max(int(maxN), 1)
    T1 = _round_up(n, BLOCK_SIZE)
    if B >= slots:
        return 1, T1
    best = (T1, 1, T1)
    S = 2
    while S <= MAX_SPLIT:
        TS = _round_up(n, S * BLOCK_SIZE)
        cost = -(-(S * B) // slots) * (TS // S + WARMUP)
        if cost < best[0]:
            best = (cost, S, TS)
        S *= 2
    return best[1], best[2]


def route(B: int, maxN: int, exact_carrier, device,
          sample_rate: float):
    """The one routing decision: (implementation, carrier mode, S, T),
    which synthesize_scores runs as they are.

    implementation: 'kernel' (the CUDA kernels, device 'cuda') or 'plain'
    (their PyTorch versions, device 'cpu'); a CUDA device without CUDA
    raises. carrier mode: 'kcar' (the reference's exact f32 recurrence, in
    the kernel) for exact_carrier True or 'kernel', and for exact_carrier
    None when the longest utterance (maxN samples at sample_rate) exceeds
    EXACT_CARRIER_AUTO_SECONDS; 'q32' (fixed point) otherwise.
    S, T: the overlap-save split and the padded length, from choose_split
    with the card's resident-block capacity on 'cuda'. On 'cpu' (slots = 1)
    and with 'kcar' (the split cannot seed segment-boundary f32 phases)
    S = 1, T = round_up(maxN, BLOCK_SIZE)."""
    if B < 1:
        raise ValueError(f"batch size must be >= 1, got {B}")
    if exact_carrier not in _EXACT_CARRIER_CHOICES:
        raise ValueError(f"exact_carrier must be one of "
                         f"{_EXACT_CARRIER_CHOICES}, got {exact_carrier!r}")
    dev = _resolve_device(device)
    impl = "kernel" if dev.type == "cuda" else "plain"
    if exact_carrier in (True, "kernel") or (
            exact_carrier is None
            and maxN > EXACT_CARRIER_AUTO_SECONDS * float(sample_rate)):
        return impl, "kcar", 1, _round_up(max(maxN, 1), BLOCK_SIZE)
    slots = fused_synth_slots(dev) if impl == "kernel" else 1
    return (impl, "q32") + choose_split(B, maxN, slots)


def text_to_phoneme_elems(text: str, voice="generic", language="generic",
                          contour: bool = False, speaking_rate: float = 1.0):
    """Host frontend through intonation: text -> timed PhonemeElems.

    With contour=True the text is segmented into clauses at punctuation and
    each clause is intonated with the language's IntonationRules (question
    rise at '?', statement fall at '.', comma pauses)."""
    from .text.intonate import PhonemeElem as _PE, split_clauses
    from .text.phonemes import Phoneme as _P

    v = _resolve_voice(voice)
    l = _resolve_language(language)
    if not contour:
        phonemes = transcribe(text, l)
        return intonate(phonemes, l, v, contour=False,
                        speaking_rate=speaking_rate)

    pelems = []
    rate = max(speaking_rate, 1e-3)
    for clause, kind, pause in split_clauses(text):
        phonemes = transcribe(clause, l)
        pelems.extend(intonate(phonemes, l, v, contour=True,
                               speaking_rate=speaking_rate, clause=kind))
        if pause is not None:
            dur = (l.intonation.comma_pause if pause == "comma"
                   else l.intonation.sentence_pause) / rate
            pelems.append(_PE(_P.SILENCE, dur, min(0.5 * dur, 0.06 / rate),
                              v.center_frequency))
    if not pelems:   # punctuation-only / empty input: one silent element
        pelems = [_PE(_P.SILENCE, 0.12 / rate, 0.06 / rate,
                      v.center_frequency)]
    return pelems


def text_to_score(text: str, voice="generic", language="generic",
                  contour: bool = False, speaking_rate: float = 1.0,
                  pad_to: Optional[int] = None) -> Score:
    """Host frontend: transcribe + intonate + select into a numpy Score."""
    v = _resolve_voice(voice)
    pelems = text_to_phoneme_elems(text, v, language, contour=contour,
                                   speaking_rate=speaking_rate)
    return score_from_phoneme_elems(pelems, v, pad_to=pad_to)


def _score_num_samples(score: Score, sample_rate: float) -> int:
    """Sample count of one utterance: floor(cum_length[-1] * sr) in f32,
    from the same array the kernel's element boundaries come from."""
    C = np.asarray(score.cum_length, np.float32)
    assert C.ndim == 1, "pass per-utterance scores, not a batch"
    return int(np.floor(np.float32(C[-1]) * np.float32(sample_rate)))


def _split_lane_setup(tables: FusedTables, T: int, S: int):
    """Overlap-save lane setup: (g0 [S] segment sample offsets, seed [S*B]
    int64 Lehmer seeds, tables tiled to S*B lanes, g0 [S*B] int32).

    Segment s renders absolute samples s*Ts - W + 1 .. (s+1)*Ts (Ts = T/S,
    W = WARMUP). Lanes are s-major (lane = s*B + b), so every per-utterance
    table row, the per-voice jitter deltas included, is tiled S times. The
    Lehmer seed of segment s >= 1 skips s*Ts - W states ahead; segment 0's
    is the negative skip that lands on state 0 at the first real sample."""
    B = tables.n.shape[0]
    dev = tables.n.device
    Ts, W = T // S, WARMUP
    g0 = [s * Ts - W for s in range(S)]
    a_inv_w = pow(LEHMER_A, -W, 1 << 32)
    seed_neg = (-(a_inv_w * lehmer_skip(W)[1])) & 0xFFFFFFFF
    seeds = [seed_neg] + [lehmer_skip(g)[1] for g in g0[1:]]
    seed_lane = torch.tensor(seeds, dtype=torch.int64,
                             device=dev).repeat_interleave(B)
    g0_lane = torch.tensor(g0, dtype=torch.int32,
                           device=dev).repeat_interleave(B)
    tables_t = FusedTables(*(x.repeat((S,) + (1,) * (x.dim() - 1))
                             for x in tables))
    return g0, seed_lane, tables_t, g0_lane


def _split_sched(inc, T: int, S: int, device):
    """The split's exact jitter schedule as views of one window of samples
    -W+1 .. T (schedule.device_window, memoized there; samples <= 0 report
    (0, 0)): ((phi [T], cell [T]) for the pre-pass over samples 1..T,
    (phi [S, Ts+W], cell [S, Ts+W]) the per-segment windows, row s covering
    absolute samples s*Ts - W + 1 .. (s+1)*Ts at a row stride of Ts."""
    W, Ts = WARMUP, T // S
    phi, cell = device_window(inc, -W, T + W, device)
    return ((phi[W:], cell[W:]),
            (phi.unfold(0, Ts + W, Ts), cell.unfold(0, Ts + W, Ts)))


def _split_lanes(tables: FusedTables, T: int, S: int, impl: str, inc):
    """The fused synthesizer's inputs for the split of B utterances of T
    samples (T % (S * BLOCK_SIZE) == 0) into S*B lanes of Ts + W samples:
    (tables tiled s-major, segment schedule rows (phi, cell) [S, Ts + W],
    initial SynthState (zero filters, skip-ahead seeds), exact Q32 phases
    [S*B], g0 [S*B]). The pre-pass (`impl`) integrates the Q32 phase to
    every block boundary; segment 0 starts at phase 0."""
    if S < 2 or T % (S * BLOCK_SIZE):
        raise ValueError(f"need S >= 2 and T % (S*{BLOCK_SIZE}) == 0, got "
                         f"S={S}, T={T}")
    B = tables.n.shape[0]
    pre, seg = _split_sched(inc, T, S, tables.n.device)
    g0, seed_lane, tables_t, g0_lane = _split_lane_setup(tables, T, S)
    q_at_block = phase_q32_pre_block(tables, pre, T, BLOCK_SIZE, impl)
    q_seg = q_at_block[[max(g, 0) // BLOCK_SIZE for g in g0]]  # [S, B]
    q_seg[0] = 0
    state = SynthState.init(S * B, tables.n.device)._replace(seed=seed_lane)
    return tables_t, seg, state, q_seg.reshape(S * B), g0_lane


def _split_program(tables: FusedTables, T: int, S: int, impl: str,
                   inc) -> torch.Tensor:
    """Overlap-save split over B utterances of T samples: the fused
    synthesizer over the S*B lanes of `_split_lanes`, each lane's first W
    samples (the pre-roll) dropped. Returns audio [B, T]."""
    B = tables.n.shape[0]
    Ts, W = T // S, WARMUP
    tables_t, seg, state, q, g0 = _split_lanes(tables, T, S, impl, inc)
    full, _ = synth_fused(tables_t, Ts + W, impl, state=state, sched=seg,
                          phase_q32=q, g0=g0)
    return full[:, W:].reshape(S, B, Ts).transpose(0, 1).reshape(B, T)


class _Batch:
    """A batch of scores made ready for one synthesizer call: voices
    resolved and checked, seeds, scores padded to one element count, and
    each utterance's sample count."""

    def __init__(self, scores_raw: list, voice, seeds):
        self.B = B = len(scores_raw)
        self.voices = [_resolve_voice(v) for v in _per_item(voice, B, "voice")]
        v0 = self.v0 = self.voices[0]
        self.sr = sr = float(v0.sample_rate)
        if any(float(v.sample_rate) != sr for v in self.voices):
            raise ValueError("batched voices must share a sample rate")
        if any(abs(v.jitter_frequency - v0.jitter_frequency) >= 1e-9
               for v in self.voices):
            raise ValueError("batched voices must share a jitter rate")
        self.seeds = _seeds(seeds, B)
        E = max(s.num_elems for s in scores_raw)
        self.scores = [pad_score(s, E) for s in scores_raw]
        self.Ns = [_score_num_samples(s, sr) for s in self.scores]

    def tables(self, T: int, dev) -> FusedTables:
        """Lattices for T samples and the kernel tables, on `dev`."""
        v0, voices = self.v0, self.voices
        lat_cache = {}
        for sd in self.seeds:
            if sd not in lat_cache:
                lat_cache[sd] = build_lattice(sd, T, v0.jitter_frequency)
        lattices = JitterLattice(*(np.stack(f) for f in zip(
            *(lat_cache[sd] for sd in self.seeds))))
        if any(v is not v0 for v in voices):
            jparams = (v0.jitter_frequency,
                       [v.jitter_delta_frequency for v in voices],
                       [v.jitter_delta_formant_frequency for v in voices],
                       [v.jitter_delta_amplitude for v in voices])
        else:
            jparams = (v0.jitter_frequency, v0.jitter_delta_frequency,
                       v0.jitter_delta_formant_frequency,
                       v0.jitter_delta_amplitude)
        return build_tables(stack_scores(self.scores), lattices, jparams,
                            self.sr, device=dev)

    def run(self, impl: str, carrier: str, S: int, T: int,
            dev) -> List[torch.Tensor]:
        """Synthesize; one tensor per utterance, sliced to its length."""
        tables = self.tables(T, dev)
        inc = self.v0.jitter_frequency
        if S > 1:
            audio = _split_program(tables, T, S, impl, inc)
        else:
            audio, _ = synth_fused(tables, T, impl,
                                   sched=device_window(inc, 0, T, dev),
                                   exact_carrier=carrier == "kcar")
        return [audio[i, :n] for i, n in enumerate(self.Ns)]


def _synthesize_split(scores: Sequence[Score], voice="generic",
                      seeds: Optional[Sequence[int]] = None, S: int = 2,
                      device="cuda") -> List[torch.Tensor]:
    """The overlap-save split route at a given S >= 2 (Q32 carrier), with
    T = round_up(maxN, S * BLOCK_SIZE): what synthesize_scores runs when
    route picks S, reachable here at any S and on the CPU too (the tests
    and chip_smoke.py use it). Same arguments and outputs as
    synthesize_scores."""
    scores = list(scores)
    if not scores:
        return []
    b = _Batch(scores, voice, seeds)
    impl = route(b.B, max(b.Ns), False, device, b.sr)[0]
    T = _round_up(max(max(b.Ns), 1), S * BLOCK_SIZE)
    return b.run(impl, "q32", S, T, torch.device(device))


def synthesize_scores(scores: Sequence[Score], voice="generic",
                      seeds: Optional[Sequence[int]] = None,
                      exact_carrier=None,
                      device="cuda") -> List[torch.Tensor]:
    """Synthesize prepared per-utterance Scores in one fused call.

    `voice` is one voice/name or one per score (shared sample rate and
    jitter rate; per-voice jitter deltas run per utterance). Scores pad to a
    shared element count and length; the outputs are float32 tensors on
    `device`, sliced to each utterance's true length. `exact_carrier` and
    the overlap-save split: see `route`."""
    scores = list(scores)
    if not scores:
        return []
    b = _Batch(scores, voice, seeds)
    impl, carrier, S, T = route(b.B, max(b.Ns), exact_carrier, device, b.sr)
    return b.run(impl, carrier, S, T, torch.device(device))


def synthesize_batch(texts: Sequence[str], voice="generic",
                     language="generic",
                     seeds: Optional[Sequence[int]] = None,
                     contour: bool = False, speaking_rate: float = 1.0,
                     sample_rate: Optional[float] = None,
                     exact_carrier=None,
                     device="cuda") -> List[torch.Tensor]:
    """Batched synthesis: texts -> one float32 waveform tensor per text, on
    `device` ('cuda' runs the kernel; 'cpu' its plain PyTorch version).

    `voice` and `language` take one value or one per text (mixed voices
    and languages batch freely; voices must share sample rate and jitter
    rate). A `sample_rate` other than the voice's retargets the voice
    first (reference resampling, src/lib.rs:418-440). `exact_carrier`:
    None (auto: exact f32 carrier past EXACT_CARRIER_AUTO_SECONDS), True
    (exact f32 carrier in the kernel; 'kernel' is another name for it),
    False (Q32 carrier)."""
    if isinstance(texts, str):
        raise TypeError(
            "texts must be a sequence of strings, not a single string — "
            "synthesize_batch('hello') would synthesize one utterance per "
            "CHARACTER; use synthesize(text) or pass [text]")
    B = len(texts)
    if B == 0:
        return []
    languages_ = _per_item(language, B, "language")
    voices = [_resolve_voice(v) for v in _per_item(voice, B, "voice")]
    if sample_rate and float(sample_rate) != float(voices[0].sample_rate):
        # resample each distinct voice object once, so a single-voice batch
        # stays single-voice
        resampled = {}
        for v in voices:
            if id(v) not in resampled:
                resampled[id(v)] = v.resampled(float(sample_rate))
        voices = [resampled[id(v)] for v in voices]
    seeds = _seeds(seeds, B)
    _resolve_device(device)    # fail before the host frontend runs

    scores = [score_from_phoneme_elems(
        text_to_phoneme_elems(t, v, lng, contour=contour,
                              speaking_rate=speaking_rate), v)
        for t, v, lng in zip(texts, voices, languages_)]
    return synthesize_scores(scores, voices, seeds=seeds,
                             exact_carrier=exact_carrier, device=device)


def synthesize(text: str, voice="generic", language="generic", seed: int = 0,
               contour: bool = False, speaking_rate: float = 1.0,
               sample_rate: Optional[float] = None, exact_carrier=None,
               device="cuda") -> torch.Tensor:
    """Text -> float32 waveform tensor: synthesize_batch([text])[0]."""
    return synthesize_batch([text], voice, language, seeds=[seed],
                            contour=contour, speaking_rate=speaking_rate,
                            sample_rate=sample_rate,
                            exact_carrier=exact_carrier, device=device)[0]


__all__ = ["route", "choose_split", "text_to_phoneme_elems", "text_to_score",
           "synthesize_scores", "synthesize_batch", "synthesize",
           "EXACT_CARRIER_AUTO_SECONDS", "BLOCK_SIZE", "WARMUP", "MAX_SPLIT"]
