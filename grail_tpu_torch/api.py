"""High-level synthesis API: text -> audio, batched, on one device.

The reference's chain (examples/cli.rs:175-184)

    chars.transcribe(lang).intonate(lang, voice).select(voice)
         .sequence(voice).jitter(seed, voice).synthesize()

runs as a host frontend (text -> timed phoneme elements -> a numpy Score
per utterance) followed by one synthesizer program over the padded batch:
the CUDA kernels on a GPU, their plain PyTorch versions on the CPU. Two
backends:

  * 'fused' (the default): one fused synthesizer call (synth/
    kernel_fused.py), the counterpart of grail_tpu's backend "fused";
  * 'core' ('pallas' is another name for it, so that calls written for
    grail_tpu run unchanged): the round-1 program of grail_tpu's backend
    "pallas" — per 4096-sample block, the sequencer (synth/sequencer.py),
    the jitter (synth/jitter.py) and the DSP core (synth/kernel.py: a
    PyTorch coefficient prep, then the recurrence kernel), with the state
    carried from block to block. It has the Q32 carrier only.

`route` decides the implementation, the carrier and the overlap-save split
in one place.

The split (`_synthesize_split`, the counterpart of grail_tpu's
_synth_jit_split_fused) runs each utterance's time axis as S segments on S
kernel lanes, so that a small batch fills the card: each segment re-derives
its filter state from a WARMUP-sample pre-roll whose output is discarded,
while the Q32 carrier phase (the pre-pass kernel's exact integral) and the
Lehmer seed (closed-form skip-ahead) continue exactly. `choose_split` picks
S from the card's resident-block capacity. The core backend splits the
same way (`_core_split_program`, the counterpart of _synth_jit_split), with
a plain PyTorch pre-pass that integrates the Q32 phase of expand_frequency's
stream, and S from the core kernel's own lane capacity. On the CPU the route
stays unsplit; the split is reached there through `_synthesize_split`. Host
carrier tracks, streaming and the CLI are later slices; this API has no
argument for them.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .languages import get_language
from .core.constants import LEHMER_A
from .core.rng import MASK32, lehmer_skip
from .synth.elem import SynthesisElem
from .synth.jitter import (JitterLattice, apply_jitter, build_lattice,
                           lattice_to, per_lane, pitch_values, sched_slice)
from .synth.kernel import CORE_MAX_LANES, synth_core
from .synth.kernel_fused import (FusedTables, build_tables, fused_synth_slots,
                                 phase_q32_pre_block, synth_fused)
from .synth.schedule import device_window
from .synth.sequencer import expand_frequency, expand_score
from .synth.synthesize import _INV_Q32, _Q32, SynthState
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

# backend names -> the program; 'pallas' is another name for 'core', as
# grail_tpu calls that program. An unknown name is an error, never a silent
# fall-through to another program.
_BACKENDS = {"fused": "fused", "core": "core", "pallas": "core"}

# lane-samples per call of the core split's pre-pass (bounds its memory)
_PRE_SAMPLES = 1 << 22


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


def _check_backend(backend) -> str:
    """'fused' or 'core' for a backend name; raises ValueError otherwise."""
    if not isinstance(backend, str) or backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: "
                         f"{', '.join(_BACKENDS)}")
    return _BACKENDS[backend]


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

    `slots` is how many lanes the card runs in one wave: the fused kernel's
    resident blocks, or the core program's lane capacity
    (kernel.CORE_MAX_LANES). A lane's time grows with its length and the
    time is flat in the number of lanes up to `slots` (PERF.md), so the
    estimated time is waves x samples per lane:

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
          sample_rate: float, backend: str = "fused"):
    """The one routing decision: (implementation, carrier mode, S, T),
    which synthesize_scores runs as they are, for `backend` 'fused' or
    'core' ('pallas').

    implementation: 'kernel' (the CUDA kernels, device 'cuda') or 'plain'
    (their PyTorch versions, device 'cpu'); a CUDA device without CUDA
    raises. carrier mode: 'kcar' (the reference's exact f32 recurrence, in
    the kernel) for exact_carrier True or 'kernel', and for exact_carrier
    None when the longest utterance (maxN samples at sample_rate) exceeds
    EXACT_CARRIER_AUTO_SECONDS; 'q32' (fixed point) otherwise.
    S, T: the overlap-save split and the padded length, from choose_split
    with the card's resident-block capacity on 'cuda'. On 'cpu' (slots = 1)
    and with 'kcar' (the split cannot seed segment-boundary f32 phases)
    S = 1, T = round_up(maxN, BLOCK_SIZE).

    The core backend has the Q32 carrier only, as in grail_tpu: with it
    exact_carrier True or 'kernel' raises ValueError, and None stays Q32 at
    any length. Its S comes from choose_split with the core program's lane
    capacity (kernel.CORE_MAX_LANES) on 'cuda'."""
    if B < 1:
        raise ValueError(f"batch size must be >= 1, got {B}")
    if exact_carrier not in _EXACT_CARRIER_CHOICES:
        raise ValueError(f"exact_carrier must be one of "
                         f"{_EXACT_CARRIER_CHOICES}, got {exact_carrier!r}")
    backend = _check_backend(backend)
    dev = _resolve_device(device)
    impl = "kernel" if dev.type == "cuda" else "plain"
    if backend == "core":
        if exact_carrier in (True, "kernel"):
            raise ValueError(
                f"exact_carrier={exact_carrier!r} needs the fused backend: "
                "the core backend has the Q32 carrier only")
        slots = CORE_MAX_LANES if impl == "kernel" else 1
        return (impl, "q32") + choose_split(B, maxN, slots)
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


def _segments(T: int, S: int):
    """The split's segments: (g0, seed), one int each per segment. Segment
    s renders absolute samples g0 + 1 .. g0 + T/S + WARMUP, g0 = s*T/S - W;
    its Lehmer seed skips g0 states ahead, and segment 0's is the negative
    skip that lands on state 0 at the first real sample."""
    Ts, W = T // S, WARMUP
    g0 = [s * Ts - W for s in range(S)]
    a_inv_w = pow(LEHMER_A, -W, 1 << 32)
    seed_neg = (-(a_inv_w * lehmer_skip(W)[1])) & 0xFFFFFFFF
    return g0, [seed_neg] + [lehmer_skip(g)[1] for g in g0[1:]]


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
    g0, seeds = _segments(T, S)
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


def _reassemble(full: torch.Tensor, B: int, T: int, S: int) -> torch.Tensor:
    """The split's lanes [S*B, T/S + W] (s-major) -> audio [B, T]: each
    lane's first W samples (the pre-roll) dropped, segments in order."""
    W = WARMUP
    return full[:, W:].reshape(S, B, T // S).transpose(0, 1).reshape(B, T)


def _split_program(tables: FusedTables, T: int, S: int, impl: str,
                   inc) -> torch.Tensor:
    """Overlap-save split over B utterances of T samples: the fused
    synthesizer over the S*B lanes of `_split_lanes`, reassembled.
    Returns audio [B, T]."""
    tables_t, seg, state, q, g0 = _split_lanes(tables, T, S, impl, inc)
    full, _ = synth_fused(tables_t, T // S + WARMUP, impl, state=state,
                          sched=seg, phase_q32=q, g0=g0)
    return _reassemble(full, tables.n.shape[0], T, S)


class _CoreLanes(NamedTuple):
    """The core program's inputs, one row per lane, on one device."""

    score: Score             # [L, E(, 8)] tensors (Score.to)
    lattice: JitterLattice   # [L, W(, 8)] tensors
    deltas: tuple            # (jdf, jdff, jda): floats, or f32 tensors [L]

    def tile(self, S: int) -> "_CoreLanes":
        """S copies of every lane, s-major (lane s*L + l is lane l)."""
        def t(x):
            if not isinstance(x, torch.Tensor):
                return x
            return x.repeat((S,) + (1,) * (x.dim() - 1))

        sc = self.score
        return _CoreLanes(
            Score(SynthesisElem(*map(t, sc.elem)), t(sc.has_sound),
                  t(sc.length), t(sc.blend_length), t(sc.cum_length)),
            JitterLattice(*map(t, self.lattice)),
            tuple(map(t, self.deltas)))


def _core_frames(lanes: _CoreLanes, sr: float, blk: int, offset, sched_b,
                 masked: bool):
    """One block of the core program's per-sample frames: expand_score at
    `offset` (one int or one per lane) and apply_jitter with the block's
    schedule (jitter masked off invalid samples when `masked`, as the split
    needs), time-major [blk, L(, 8)]; and valid [L, blk]."""
    elems, valid = expand_score(lanes.score, sr, blk, offset=offset)
    elems = apply_jitter(elems, lanes.lattice, *lanes.deltas, sched_b,
                         mask=valid if masked else None)
    return SynthesisElem(*(f.transpose(0, 1) for f in elems)), valid


class _CoreSetup(NamedTuple):
    """One core program, ready to run: the state before block 0, the block
    count, and `frames(i)` -> block i's time-major frames and valid [L,
    BLOCK_SIZE] (_core_frames)."""

    state: SynthState
    nb: int
    frames: Callable[[int], tuple]


def _core_unsplit_setup(lanes: _CoreLanes, T: int, sr: float,
                        inc) -> _CoreSetup:
    """The unsplit core program (the counterpart of grail_tpu's
    _synth_jit_batch with backend "pallas") over L lanes of T samples: zero
    state, blocks of BLOCK_SIZE samples at offsets i * BLOCK_SIZE, the
    schedule of samples 1..T."""
    L = lanes.score.cum_length.shape[0]
    dev = lanes.score.cum_length.device
    nb = max(T // BLOCK_SIZE, 1)
    blk = T // nb
    sched = device_window(inc, 0, T, dev)

    def frames(i):
        off = i * blk
        return _core_frames(lanes, sr, blk, off,
                            sched_slice(sched, off, blk), False)

    return _CoreSetup(SynthState.init(L, dev), nb, frames)


def _core_pre_pass(lanes: _CoreLanes, T: int, sr: float,
                   sched) -> torch.Tensor:
    """The core split's pre-pass: the Q32 carrier phase before each
    BLOCK_SIZE block of samples 1..T, uint32 values in int64 [T / BLOCK_SIZE,
    L]. It integrates expand_frequency's stream plus the masked pitch jitter
    (the frequency the segments synthesize) as trunc(f * 2^32), mod 2^32.
    `sched` covers samples -WARMUP+1 .. T. Plain PyTorch, as in grail_tpu:
    the pre-pass kernel of the fused backend integrates the fused chain's
    frequency, not this one."""
    L = lanes.score.cum_length.shape[0]
    blk, W = BLOCK_SIZE, WARMUP
    jdf = per_lane(lanes.deltas[0], L, 1)
    nblk = T // blk
    per = max(1, _PRE_SAMPLES // (L * blk))          # blocks per call
    sums = []
    for i0 in range(0, nblk, per):
        n = min(per, nblk - i0) * blk
        f, valid = expand_frequency(lanes.score, sr, n, offset=i0 * blk)
        pitch = pitch_values(lanes.lattice,
                             *sched_slice(sched, i0 * blk + W, n))
        f = f + pitch * valid.to(torch.float32) * jdf
        fq = (f * _Q32).to(torch.int64)      # exact scale, then truncate
        sums.append(fq.reshape(L, -1, blk).sum(-1))
    sums = torch.cat(sums, dim=1) & MASK32                   # [L, nblk]
    return ((torch.cumsum(sums, dim=1) - sums) & MASK32).T


def _core_split_setup(lanes: _CoreLanes, T: int, S: int, sr: float,
                      inc) -> _CoreSetup:
    """The overlap-save split of the core program (the counterpart of
    grail_tpu's _synth_jit_split) over B utterances of T samples, T % (S *
    BLOCK_SIZE) == 0: S*B lanes of T/S + WARMUP samples, lane s*B + b
    rendering utterance b from sample g0_s + 1 (`_segments`), its jitter
    masked off invalid samples. Each lane starts from zero filters, its
    skip-ahead Lehmer seed and the pre-pass's Q32 phase at its first sample,
    rounded to f32 as grail_tpu rounds it (segment 0: phase 0)."""
    if S < 2 or T % (S * BLOCK_SIZE):
        raise ValueError(f"need S >= 2 and T % (S*{BLOCK_SIZE}) == 0, got "
                         f"S={S}, T={T}")
    B = lanes.score.cum_length.shape[0]
    dev = lanes.score.cum_length.device
    Ts, W, blk = T // S, WARMUP, BLOCK_SIZE
    sched = device_window(inc, -W, T + W, dev)   # index j <-> sample j-W+1
    g0, seeds = _segments(T, S)
    q = _core_pre_pass(lanes, T, sr, sched)                  # [T/blk, B]
    phase = q[[max(g, 0) // blk for g in g0]].to(torch.float32) * _INV_Q32
    phase[0] = 0.0
    state = SynthState.init(S * B, dev)._replace(
        phase=phase.reshape(S * B),
        seed=torch.tensor(seeds, dtype=torch.int64,
                          device=dev).repeat_interleave(B))
    lanes_t = lanes.tile(S)
    g0_lane = torch.tensor(g0, dtype=torch.int64,
                           device=dev).repeat_interleave(B)

    def frames(i):
        off = i * blk
        # every window lies inside the schedule: off + g0 + W >= 0 and
        # off + g0 + W + blk <= (S - 1) * Ts + Ts + W = T + W
        return _core_frames(lanes_t, sr, blk, off + g0_lane,
                            sched_slice(sched, off + W + g0_lane, blk), True)

    return _CoreSetup(state, (Ts + W) // blk, frames)


def _core_run(setup: _CoreSetup, impl: str) -> torch.Tensor:
    """Run a core program: per block the frames, then synth_core with the
    state carried from the block before; zero past each utterance's end.
    Audio [L, nb * BLOCK_SIZE]."""
    state, outs = setup.state, []
    for i in range(setup.nb):
        elems, valid = setup.frames(i)
        out, state = synth_core(elems, state, impl)
        outs.append(out.T * valid)
    return torch.cat(outs, dim=1)


def _core_split_program(lanes: _CoreLanes, T: int, S: int, sr: float, inc,
                        impl: str) -> torch.Tensor:
    """The split core program (_core_split_setup) with the pre-rolls'
    output dropped: audio [B, T]."""
    full = _core_run(_core_split_setup(lanes, T, S, sr, inc), impl)
    return _reassemble(full, lanes.score.cum_length.shape[0], T, S)


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

    def jitter(self, T: int):
        """(numpy lattices [B, W(, 8)] for T samples, jparams): jparams =
        (jitter rate, jdf, jdff, jda), each delta one value, or a list of
        one per utterance when the voices differ."""
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
        return lattices, jparams

    def tables(self, T: int, dev) -> FusedTables:
        """Lattices for T samples and the kernel tables, on `dev`."""
        lattices, jparams = self.jitter(T)
        return build_tables(stack_scores(self.scores), lattices, jparams,
                            self.sr, device=dev)

    def core_lanes(self, T: int, dev) -> _CoreLanes:
        """The core program's inputs for T samples, on `dev`."""
        lattices, jparams = self.jitter(T)

        def delta(x):
            if isinstance(x, list):
                return torch.tensor(x, dtype=torch.float32, device=dev)
            return float(np.float32(x))

        return _CoreLanes(stack_scores(self.scores).to(dev),
                          lattice_to(lattices, dev),
                          tuple(delta(x) for x in jparams[1:]))

    def run(self, impl: str, carrier: str, S: int, T: int, dev,
            backend: str = "fused") -> List[torch.Tensor]:
        """Synthesize; one tensor per utterance, sliced to its length."""
        inc = self.v0.jitter_frequency
        if backend == "core":
            lanes = self.core_lanes(T, dev)
            audio = (_core_split_program(lanes, T, S, self.sr, inc, impl)
                     if S > 1 else
                     _core_run(_core_unsplit_setup(lanes, T, self.sr, inc),
                               impl))
            return [audio[i, :n] for i, n in enumerate(self.Ns)]
        tables = self.tables(T, dev)
        if S > 1:
            audio = _split_program(tables, T, S, impl, inc)
        else:
            audio, _ = synth_fused(tables, T, impl,
                                   sched=device_window(inc, 0, T, dev),
                                   exact_carrier=carrier == "kcar")
        return [audio[i, :n] for i, n in enumerate(self.Ns)]


def _synthesize_split(scores: Sequence[Score], voice="generic",
                      seeds: Optional[Sequence[int]] = None, S: int = 2,
                      device="cuda", backend="fused") -> List[torch.Tensor]:
    """The overlap-save split route at a given S >= 2 (Q32 carrier), with
    T = round_up(maxN, S * BLOCK_SIZE): what synthesize_scores runs when
    route picks S, reachable here at any S and on the CPU too (the tests
    and chip_smoke.py use it). Same arguments and outputs as
    synthesize_scores."""
    scores = list(scores)
    if not scores:
        return []
    b = _Batch(scores, voice, seeds)
    impl = route(b.B, max(b.Ns), False, device, b.sr, backend)[0]
    T = _round_up(max(max(b.Ns), 1), S * BLOCK_SIZE)
    return b.run(impl, "q32", S, T, torch.device(device),
                 _check_backend(backend))


def synthesize_scores(scores: Sequence[Score], voice="generic",
                      seeds: Optional[Sequence[int]] = None,
                      exact_carrier=None, device="cuda",
                      backend="fused") -> List[torch.Tensor]:
    """Synthesize prepared per-utterance Scores in one synthesizer program.

    `voice` is one voice/name or one per score (shared sample rate and
    jitter rate; per-voice jitter deltas run per utterance). Scores pad to a
    shared element count and length; the outputs are float32 tensors on
    `device`, sliced to each utterance's true length. `backend` is 'fused'
    (default), 'core' or its other name 'pallas' (see the module doc);
    `exact_carrier` and the overlap-save split: see `route`."""
    scores = list(scores)
    if not scores:
        return []
    b = _Batch(scores, voice, seeds)
    impl, carrier, S, T = route(b.B, max(b.Ns), exact_carrier, device, b.sr,
                                backend)
    return b.run(impl, carrier, S, T, torch.device(device),
                 _check_backend(backend))


def synthesize_batch(texts: Sequence[str], voice="generic",
                     language="generic",
                     seeds: Optional[Sequence[int]] = None,
                     contour: bool = False, speaking_rate: float = 1.0,
                     sample_rate: Optional[float] = None,
                     exact_carrier=None, device="cuda",
                     backend="fused") -> List[torch.Tensor]:
    """Batched synthesis: texts -> one float32 waveform tensor per text, on
    `device` ('cuda' runs the kernels; 'cpu' their plain PyTorch versions).

    `voice` and `language` take one value or one per text (mixed voices
    and languages batch freely; voices must share sample rate and jitter
    rate). A `sample_rate` other than the voice's retargets the voice
    first (reference resampling, src/lib.rs:418-440). `exact_carrier`:
    None (auto: exact f32 carrier past EXACT_CARRIER_AUTO_SECONDS), True
    (exact f32 carrier in the kernel; 'kernel' is another name for it),
    False (Q32 carrier). `backend`: 'fused' (default) or 'core' ('pallas'),
    the round-1 program, which has the Q32 carrier only (exact_carrier
    True raises; None stays Q32)."""
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
    _check_backend(backend)

    scores = [score_from_phoneme_elems(
        text_to_phoneme_elems(t, v, lng, contour=contour,
                              speaking_rate=speaking_rate), v)
        for t, v, lng in zip(texts, voices, languages_)]
    return synthesize_scores(scores, voices, seeds=seeds,
                             exact_carrier=exact_carrier, device=device,
                             backend=backend)


def synthesize(text: str, voice="generic", language="generic", seed: int = 0,
               contour: bool = False, speaking_rate: float = 1.0,
               sample_rate: Optional[float] = None, exact_carrier=None,
               device="cuda", backend="fused") -> torch.Tensor:
    """Text -> float32 waveform tensor: synthesize_batch([text])[0]."""
    return synthesize_batch([text], voice, language, seeds=[seed],
                            contour=contour, speaking_rate=speaking_rate,
                            sample_rate=sample_rate,
                            exact_carrier=exact_carrier, device=device,
                            backend=backend)[0]


__all__ = ["route", "choose_split", "text_to_phoneme_elems", "text_to_score",
           "synthesize_scores", "synthesize_batch", "synthesize",
           "EXACT_CARRIER_AUTO_SECONDS", "BLOCK_SIZE", "WARMUP", "MAX_SPLIT"]
