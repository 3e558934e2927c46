"""High-level synthesis API: text -> audio, batched, on one device.

The reference's chain (examples/cli.rs:175-184)

    chars.transcribe(lang).intonate(lang, voice).select(voice)
         .sequence(voice).jitter(seed, voice).synthesize()

runs as a host frontend (text -> timed phoneme elements -> a numpy Score
per utterance; transcription and the drift boundaries in the native host
library, runtime/native.py) followed by one synthesizer program over the
padded batch:
the CUDA kernels on a GPU, their plain PyTorch versions on the CPU. Each
entry point takes grail_tpu's parameters in grail_tpu's order and adds
`device` last, so a positional call means what it means there. Four
backends, under grail_tpu's names (`_BACKENDS`; its '_interpret' names are
other names of the same programs, so that calls written for grail_tpu run
unchanged):

  * 'fused' (the default on both devices, `default_backend`): one fused
    synthesizer call (synth/kernel_fused.py), the counterpart of
    grail_tpu's backend "fused";
  * 'core' (also 'pallas'): the round-1 program of grail_tpu's backend
    "pallas" — per 4096-sample block, the sequencer (synth/sequencer.py),
    the jitter (synth/jitter.py) and the DSP core (synth/kernel.py: a
    PyTorch coefficient prep, then the recurrence kernel), with the state
    carried from block to block. It has the Q32 carrier only;
  * 'xla': grail_tpu's associative-scan core (synth/synthesize.
    _block_core) in plain PyTorch per 4096-sample block, its carrier the
    Q32 accumulator, a host track, or the f32 recurrence of the kernel
    synth/csrc/seq_scan.cu ('kcar');
  * 'scan': grail_tpu's reference core (synth/synthesize.synthesize_scan),
    a Python loop over samples of the recurrent part, its carrier the f32
    recurrence (seq_scan.cu) or a host track.

`xla` and `scan` run unsplit, with no lane padding (S = 1,
T = round_up(maxN, 4096)). `synthesize_score`'s `pad_samples_to`, and a
`sample_rate` other than the voice's, run on them only, as in grail_tpu.

`route` decides the implementation, the carrier and the overlap-save split
in one place.

The split (`_synthesize_split`, the counterpart of grail_tpu's
_synth_jit_split_fused) runs each utterance's time axis as S segments on S
kernel lanes, so that a small batch fills the card: each segment re-derives
its filter state from a WARMUP-sample pre-roll whose output is discarded,
while the carrier phase and the Lehmer seed (closed-form skip-ahead)
continue exactly: the Q32 phase from the pre-pass kernel's exact integral,
the exact f32 phase ('kcar') from the seam pre-pass kernel, which steps the
reference's f32 recurrence to each segment's first sample. `choose_split`
picks S from the card's resident-block capacity. The core backend splits the
same way (`_core_split_program`, the counterpart of _synth_jit_split), with
a plain PyTorch pre-pass that integrates the Q32 phase of expand_frequency's
stream, and S from the core kernel's own lane capacity. On the CPU the route
stays unsplit; the split is reached there through `_synthesize_split`.

The solo long-form route: for one utterance past EXACT_CARRIER_AUTO_SECONDS
(or with exact_carrier=True) `synthesize`/`synthesize_batch` run the native
carrier pre-pass on the host (`_carrier_track_for`: the reference's f32
phase recurrence per sample, runtime/native.py) and hand the track to the
fused kernel's 'host_track' mode. The track gives every segment its exact
phase, so this route keeps the split (`_split_carrier`), launches no Q32
pre-pass, and uploads the track once.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .languages import get_language
from .runtime.native import native_carrier_track
from .runtime.trace import annotate, span, tally
from .core.constants import LEHMER_A
from .core.rng import MASK32, lehmer_skip
from .synth.elem import SynthesisElem
from .synth.jitter import (JitterLattice, apply_jitter, build_lattice,
                           lattice_to, per_lane, pitch_values, sched_slice)
from .synth.kernel import CORE_MAX_LANES, synth_core
from .synth.kernel_fused import (FusedTables, build_tables, fused_synth_slots,
                                 kcar_seam_phases, phase_q32_pre_block,
                                 synth_fused)
from .synth.schedule import device_window
from .synth.sequencer import expand_frequency, expand_score
from .synth.synthesize import (_INV_Q32, _Q32, SynthState, _block_core,
                               carrier_scan, synthesize_scan)
from .synth.score import Score, pad_score, score_from_phoneme_elems, stack_scores
from .text.intonate import intonate
from .text.language import Language
from .text.transcribe import transcribe
from .voices import Voice, get_spec, get_voice

BLOCK_SIZE = 4096   # utterance lengths pad to a multiple of this
WARMUP = 4096       # overlap-save pre-roll (the IIRs forget in ~200 samples)
MAX_SPLIT = 128     # largest segment count choose_split considers

# Auto exact-carrier duration gate (the JAX package's value): the Q32
# carrier's residual against the reference's f32 recurrence grows with
# duration, so past 30 s the exact f32 carrier runs in the kernel.
EXACT_CARRIER_AUTO_SECONDS = 30.0

# True: the exact carrier, from a host track where there is one (one
# utterance, fused backend), else stepped in the kernel; 'kernel' pins the
# in-kernel recurrence
_EXACT_CARRIER_CHOICES = (None, True, False, "kernel")

# backend names -> the program, grail_tpu's names (api.py:119-120) and the
# port's 'core'; 'pallas' is grail_tpu's name for the core program, and the
# '_interpret' names (grail_tpu's Pallas interpreter, a CPU mode) are other
# names of the same programs. An unknown name is an error, never a silent
# fall-through to another program.
_BACKENDS = {"fused": "fused", "fused_interpret": "fused", "core": "core",
             "pallas": "core", "pallas_interpret": "core", "xla": "xla",
             "scan": "scan"}

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


def default_backend() -> str:
    """'fused' on both devices: the port's fused program runs its kernels
    on a card and its plain version on the CPU. grail_tpu's default is
    'xla' off a TPU (its fused kernel runs on the CPU only in interpret
    mode)."""
    return "fused"


def _check_backend(backend) -> str:
    """The program ('fused', 'core', 'xla' or 'scan') a backend name runs;
    None is default_backend(). Raises ValueError for an unknown name."""
    if backend is None:
        backend = default_backend()
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
          sample_rate: float, backend: Optional[str] = None,
          track: bool = False):
    """The one routing decision: (implementation, carrier mode, S, T),
    which synthesize_scores runs as they are, for any backend name
    (None: default_backend()).

    implementation: 'kernel' (the CUDA kernels, device 'cuda') or 'plain'
    (their PyTorch versions, device 'cpu'); a CUDA device without CUDA
    raises. carrier mode, as in grail_tpu's synthesize_scores:
      * 'track' (the reference's exact f32 phase, read from a host-built
        track) when the caller holds one (`track=True`) for a single
        utterance on the fused backend; a track takes precedence over
        exact_carrier, as in grail_tpu;
      * 'kcar' (the same recurrence, stepped in the kernel) without a track
        for exact_carrier True or 'kernel', and for exact_carrier None when
        the longest utterance (maxN samples at sample_rate) exceeds
        EXACT_CARRIER_AUTO_SECONDS;
      * 'q32' (fixed point) otherwise.
    A track does not apply to B > 1 or to the core backend: the returned
    mode says what will run. S, T: the overlap-save split and the padded
    length, from choose_split with the card's resident-block capacity on
    'cuda', whatever the carrier: 'track' splits with every segment's exact
    phase read from the track, 'kcar' with each segment's exact f32 phase
    from the seam pre-pass kernel. On 'cpu' (slots = 1) S = 1,
    T = round_up(maxN, BLOCK_SIZE).

    The core backend has the Q32 carrier only, as in grail_tpu: with it
    exact_carrier True or 'kernel' raises ValueError, and None stays Q32 at
    any length. Its S comes from choose_split with the core program's lane
    capacity (kernel.CORE_MAX_LANES) on 'cuda'.

    'xla' and 'scan' run unsplit: S = 1, T = round_up(maxN, BLOCK_SIZE), as
    grail_tpu's _synth_jit and _synth_jit_batch do. A track applies to one
    utterance on both; without one, 'xla' chooses 'kcar' (the f32 recurrence
    of the carrier_scan kernel, once a block) or 'q32' as the fused backend
    does, and 'scan' always steps the f32 recurrence ('kcar'), whatever
    exact_carrier says, as grail_tpu's lax.scan core does."""
    if B < 1:
        raise ValueError(f"batch size must be >= 1, got {B}")
    if exact_carrier not in _EXACT_CARRIER_CHOICES:
        raise ValueError(f"exact_carrier must be one of "
                         f"{_EXACT_CARRIER_CHOICES}, got {exact_carrier!r}")
    backend = _check_backend(backend)
    dev = _resolve_device(device)
    impl = "kernel" if dev.type == "cuda" else "plain"
    if backend in ("xla", "scan"):
        T = _round_up(max(maxN, 1), BLOCK_SIZE)
        if track and B == 1:
            return impl, "track", 1, T
        if backend == "scan" or exact_carrier in (True, "kernel") or (
                exact_carrier is None
                and maxN > EXACT_CARRIER_AUTO_SECONDS * float(sample_rate)):
            return impl, "kcar", 1, T
        return impl, "q32", 1, T
    if backend == "core":
        if exact_carrier in (True, "kernel"):
            raise ValueError(
                f"exact_carrier={exact_carrier!r} needs the fused backend: "
                "the core backend has the Q32 carrier only")
        slots = CORE_MAX_LANES if impl == "kernel" else 1
        return (impl, "q32") + choose_split(B, maxN, slots)
    slots = fused_synth_slots(dev) if impl == "kernel" else 1
    if track and B == 1:
        return (impl, "track") + choose_split(B, maxN, slots)
    if exact_carrier in (True, "kernel") or (
            exact_carrier is None
            and maxN > EXACT_CARRIER_AUTO_SECONDS * float(sample_rate)):
        return (impl, "kcar") + choose_split(B, maxN, slots)
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


def _spec_for_voice(v: Voice):
    """The registered VoiceSpec behind a compiled Voice (by name,
    retargeted to the voice's sample rate), or None when the voice is not
    a registered preset (a voice file): the native pre-pass needs the spec,
    so such a voice has no host track."""
    try:
        spec = get_spec(v.name)
    except KeyError:
        return None
    if float(spec.sample_rate) != float(v.sample_rate):
        spec = dataclasses.replace(spec, sample_rate=float(v.sample_rate))
    return spec


def _wants_exact_carrier(pelems) -> bool:
    return (sum(float(p.length) for p in pelems)
            > EXACT_CARRIER_AUTO_SECONDS)


_carrier_cache = {}


def _carrier_track_for(pelems, v: Voice, seed: int) -> Optional[np.ndarray]:
    """Host pre-pass: the reference's exact f32 carrier phase per sample for
    this utterance (runtime/native.native_carrier_track: the frequency chain
    alone, bit-equal to oracle/native.native_carrier_phase_track), memoized
    over the last 32 utterances. None only when the voice has no registered
    spec (`_spec_for_voice`); the caller then gets the in-kernel recurrence,
    and `route` says so. The host library is built at first use; a failed
    build raises. The look-up and the pre-pass run in the span `track`, with
    the track's length (`samples`) and whether the memo held it (`hit`); a
    miss adds `track_chain_samples` there too."""
    spec = _spec_for_voice(v)
    if spec is None:
        return None
    with span("track"):
        key_parts = [f"{p.phoneme.value}:{p.length!r}:{p.blend_length!r}:"
                     f"{p.frequency!r}" for p in pelems]
        key_parts.append(f"{spec.name}:{spec.sample_rate}:{int(seed)}")
        key = hashlib.sha256("|".join(key_parts).encode()).hexdigest()
        track = _carrier_cache.get(key)
        hit = track is not None
        if not hit:
            track = native_carrier_track(pelems, spec,
                                         jitter_seed=int(seed))
            if len(_carrier_cache) >= 32:
                _carrier_cache.clear()
            _carrier_cache[key] = track
        annotate(hit=hit, samples=len(track))
    return track


def _carrier_window(track, T: int, pre: int, device) -> torch.Tensor:
    """`pre` pre-roll phases, then the track edge-padded to T samples, as
    one f32 tensor [pre + T] on `device` (index j <-> absolute sample
    j - pre + 1). The oracle's sample count can differ from the score's by
    a few samples; the tail past the track is invalid (its output is
    zeroed), so its phase only needs to be finite. A track longer than T
    raises. The pre-roll is the phase cycle {0, .25, .5, .75} of silence
    (f = 0.25 exactly) from phase 0, aligned so that it returns to 0 at
    absolute sample 1 (`pre` % 4 == 0): what the Q32 split's segment 0
    renders before the stream. On a CUDA device the window is assembled in
    pinned memory and uploaded once."""
    t = np.asarray(track, np.float32).reshape(-1)
    if len(t) > T:
        raise ValueError(f"carrier track of {len(t)} samples exceeds the "
                         f"padded length {T}")
    if pre % 4:
        raise ValueError(f"pre-roll {pre} must be a multiple of 4")
    dev = torch.device(device)
    host = torch.empty(pre + T, dtype=torch.float32,
                       pin_memory=dev.type == "cuda")
    w = host.numpy()
    w[:pre] = (np.arange(pre, dtype=np.int64) % 4).astype(np.float32) * 0.25
    w[pre:pre + len(t)] = t
    w[pre + len(t):] = t[-1] if len(t) else 0.0
    return host.to(dev, non_blocking=True)


def _pad_track(track, T: int, device) -> torch.Tensor:
    """A carrier track edge-padded to T samples, on `device` (the unsplit
    route's)."""
    return _carrier_window(track, T, 0, device)


def _split_carrier(track, T: int, S: int, device) -> torch.Tensor:
    """Per-segment carrier windows [S, T/S + WARMUP] for the overlap-save
    split: row s covers absolute samples s*Ts - W + 1 .. (s+1)*Ts, so index
    j of row s is absolute sample s*Ts + j - W + 1. The rows are overlapping
    views (row stride Ts) of one window of W + T floats, as the schedule's
    rows are (`_split_sched`): the track is uploaded once and never tiled
    to the S*B lanes. Segment 0's pre-roll lies before the stream: see
    `_carrier_window`; the first real sample reads track[0], the
    reference's initial phase 0."""
    Ts = T // S
    return _carrier_window(track, T, WARMUP, device).unfold(
        0, Ts + WARMUP, Ts)


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


def _split_lanes(tables: FusedTables, T: int, S: int, impl: str, inc,
                 track=None, sched=None, kcar: bool = False):
    """The fused synthesizer's inputs for the split of B utterances of T
    samples (T % (S * BLOCK_SIZE) == 0) into S*B lanes of Ts + W samples:
    (tables tiled s-major, segment schedule rows (phi, cell) [S, Ts + W],
    initial SynthState (zero filters, skip-ahead seeds), exact Q32 phases
    [S*B], g0 [S*B], carrier rows [S, Ts + W] or None). The pre-pass
    (`impl`) integrates the Q32 phase to every block boundary; segment 0
    starts at phase 0. With a carrier `track` (one utterance) the segments
    read their phases from it (`_split_carrier`): the pre-pass is not
    launched and the Q32 phases are zero. With `kcar` (the exact f32
    carrier stepped in the kernel) the seam pre-pass steps the reference's
    f32 recurrence to each segment's first sample g0 + 1 and puts that
    phase in the lane's state.phase; segment 0 starts at phase 0, which its
    pre-roll of silence (f = 0.25 exactly, W % 4 == 0) brings back to 0 at
    sample 1. `sched` is `_split_sched(inc, T, S, device)` where the caller
    has built it already."""
    if S < 2 or T % (S * BLOCK_SIZE):
        raise ValueError(f"need S >= 2 and T % (S*{BLOCK_SIZE}) == 0, got "
                         f"S={S}, T={T}")
    B = tables.n.shape[0]
    pre, seg = sched or _split_sched(inc, T, S, tables.n.device)
    g0, seed_lane, tables_t, g0_lane = _split_lane_setup(tables, T, S)
    state = SynthState.init(S * B, tables.n.device)._replace(seed=seed_lane)
    if track is not None:
        car = _split_carrier(track, T, S, tables.n.device)
        q = torch.zeros(S * B, dtype=torch.int64, device=tables.n.device)
        return tables_t, seg, state, q, g0_lane, car
    if kcar:
        seams = kcar_seam_phases(tables, pre, g0[1], T // S, S - 1, impl)
        phase = torch.cat([torch.zeros(B, dtype=torch.float32,
                                       device=tables.n.device),
                           seams.reshape(-1)])
        q = torch.zeros(S * B, dtype=torch.int64, device=tables.n.device)
        return tables_t, seg, state._replace(phase=phase), q, g0_lane, None
    q_at_block = phase_q32_pre_block(tables, pre, T, BLOCK_SIZE, impl)
    q_seg = q_at_block[[max(g, 0) // BLOCK_SIZE for g in g0]]  # [S, B]
    q_seg[0] = 0
    return tables_t, seg, state, q_seg.reshape(S * B), g0_lane, None


def _reassemble(full: torch.Tensor, B: int, T: int, S: int) -> torch.Tensor:
    """The split's lanes [S*B, T/S + W] (s-major) -> audio [B, T]: each
    lane's first W samples (the pre-roll) dropped, segments in order."""
    W = WARMUP
    return full[:, W:].reshape(S, B, T // S).transpose(0, 1).reshape(B, T)


def _split_program(tables: FusedTables, T: int, S: int, impl: str,
                   inc, track=None, sched=None,
                   kcar: bool = False) -> torch.Tensor:
    """Overlap-save split over B utterances of T samples: the fused
    synthesizer over the S*B lanes of `_split_lanes`, reassembled.
    Returns audio [B, T]."""
    tables_t, seg, state, q, g0, car = _split_lanes(tables, T, S, impl, inc,
                                                    track, sched, kcar)
    full, _ = synth_fused(tables_t, T // S + WARMUP, impl, state=state,
                          sched=seg, exact_carrier=kcar, phase_q32=q, g0=g0,
                          carrier=car)
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


def _xla_run(setup: _CoreSetup, carrier: str, track=None) -> torch.Tensor:
    """The xla program (grail_tpu's _synth_jit_batch with backend "xla",
    and _synth_jit's block loop) over the blocks of an unsplit core setup:
    per block the frames, then _block_core with the state carried, its
    carrier the Q32 accumulator ('q32'), the carrier_scan recurrence from
    the carried phase ('kcar') or the block's window of the host `track`
    ('track', one utterance); zero past each utterance's end. Each block's
    scan temporaries (~100 MB at 64 lanes) are freed before the next.
    Audio [L, nb * BLOCK_SIZE]."""
    state, outs = setup.state, []
    car = None
    if carrier == "track":
        car = _pad_track(track, setup.nb * BLOCK_SIZE,
                         state.phase.device)[:, None]
    for i in range(setup.nb):
        elems, valid = setup.frames(i)
        if carrier == "kcar":
            car_b, phase_out = carrier_scan(state.phase, elems.frequency)
            out, state = _block_core(elems, state, carrier=car_b)
            state = state._replace(phase=phase_out)
        else:
            car_b = (None if car is None
                     else car[i * BLOCK_SIZE:(i + 1) * BLOCK_SIZE])
            out, state = _block_core(elems, state, carrier=car_b)
        outs.append(out.T * valid)
        del elems, valid, out, car_b
    return torch.cat(outs, dim=1)


def _scan_run(lanes: _CoreLanes, T: int, sr: float, inc,
              track=None) -> torch.Tensor:
    """The scan program (grail_tpu's lax.scan core): the frames of all T
    samples, then synthesize_scan from the zero state, its carrier the f32
    recurrence or the host `track` (one utterance); zero past each
    utterance's end. Audio [L, T]."""
    dev = lanes.score.cum_length.device
    elems, valid = _core_frames(lanes, sr, T, 0, device_window(inc, 0, T,
                                                               dev), False)
    car = None if track is None else _pad_track(track, T, dev)[:, None]
    out, _ = synthesize_scan(elems, carrier=car)
    return out.T * valid


class _Batch:
    """A batch of scores made ready for one synthesizer call: voices
    resolved and checked, seeds, scores padded to one element count, and
    each utterance's sample count. `sample_rate` renders the scores at
    another rate than the voices' (synthesize_score's, on xla and scan)."""

    def __init__(self, scores_raw: list, voice, seeds, sample_rate=None):
        self.B = B = len(scores_raw)
        self.voices = [_resolve_voice(v) for v in _per_item(voice, B, "voice")]
        v0 = self.v0 = self.voices[0]
        sr = float(v0.sample_rate)
        if any(float(v.sample_rate) != sr for v in self.voices):
            raise ValueError("batched voices must share a sample rate")
        self.sr = sr = float(sample_rate) if sample_rate else sr
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
        with span("lattices"):
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
        with span("tables"):
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
            backend: str = "fused", track=None) -> List[torch.Tensor]:
        """Synthesize; one tensor per utterance, sliced to its length.
        `track` is the host carrier track that the carrier mode 'track'
        reads (one utterance; fused, xla or scan backend)."""
        if (carrier == "track") != (track is not None):
            raise ValueError(f"carrier mode {carrier!r} with"
                             f"{'out' if track is None else ''} a track")
        inc = self.v0.jitter_frequency
        if backend in ("xla", "scan"):
            if S != 1:
                raise ValueError(f"the {backend} backend runs unsplit, "
                                 f"got S={S}")
            lanes = self.core_lanes(T, dev)
            audio = (_scan_run(lanes, T, self.sr, inc, track)
                     if backend == "scan" else
                     _xla_run(_core_unsplit_setup(lanes, T, self.sr, inc),
                              carrier, track))
            return [audio[i, :n] for i, n in enumerate(self.Ns)]
        if backend == "core":
            lanes = self.core_lanes(T, dev)
            audio = (_core_split_program(lanes, T, S, self.sr, inc, impl)
                     if S > 1 else
                     _core_run(_core_unsplit_setup(lanes, T, self.sr, inc),
                               impl))
            return [audio[i, :n] for i, n in enumerate(self.Ns)]
        tables = self.tables(T, dev)
        with span("schedule"):
            sched = (_split_sched(inc, T, S, dev) if S > 1
                     else device_window(inc, 0, T, dev))
        with span("launch"):
            if S > 1:
                audio = _split_program(tables, T, S, impl, inc, track,
                                       sched=sched, kcar=carrier == "kcar")
            else:
                car = None if track is None else _pad_track(track, T, dev)
                audio, _ = synth_fused(tables, T, impl, sched=sched,
                                       exact_carrier=carrier == "kcar",
                                       carrier=car)
        if carrier == "kcar" and S > 1:     # the seam pre-pass's lane-samples
            tally(kcar_seam_samples=self.B * _segments(T, S)[0][-1])
        return [audio[i, :n] for i, n in enumerate(self.Ns)]


def _applicable_track(carrier_tracks, B: int, backend):
    """The host carrier track that applies, or None: a track is read for
    one utterance on the fused, xla and scan backends, as in grail_tpu
    (per-lane tracks for a batch would cost a host pre-pass and an upload
    per lane; the core backend has the Q32 carrier only)."""
    if carrier_tracks is None or B != 1 or _check_backend(backend) == "core":
        return None
    if len(carrier_tracks) != B:
        raise ValueError(f"{len(carrier_tracks)} carrier tracks for {B} "
                         "utterances")
    return carrier_tracks[0]


def _synthesize_split(scores: Sequence[Score], voice="generic",
                      seeds: Optional[Sequence[int]] = None, S: int = 2,
                      device="cuda", backend="fused",
                      carrier_tracks: Optional[Sequence] = None,
                      exact_carrier=False) -> List[torch.Tensor]:
    """The overlap-save split route at a given S >= 2 (the carrier that
    `route` gives for `exact_carrier`: Q32, the exact f32 carrier from the
    seam pre-pass, or the host track of `carrier_tracks` for one
    utterance), with T = round_up(maxN, S * BLOCK_SIZE): what
    synthesize_scores runs when route picks S, reachable here at any S and
    on the CPU too (the tests use it). Same arguments and outputs as
    synthesize_scores."""
    scores = list(scores)
    if not scores:
        return []
    if _check_backend(backend) not in ("fused", "core"):
        raise ValueError(f"backend {backend!r} has no split; the split runs "
                         "the fused and core programs")
    b = _Batch(scores, voice, seeds)
    track = _applicable_track(carrier_tracks, b.B, backend)
    impl, carrier = route(b.B, max(b.Ns), exact_carrier, device, b.sr,
                          backend, track=track is not None)[:2]
    T = _round_up(max(max(b.Ns), 1), S * BLOCK_SIZE)
    return b.run(impl, carrier, S, T, torch.device(device),
                 _check_backend(backend), track)


def synthesize_scores(scores: Sequence[Score], voice="generic",
                      seeds: Optional[Sequence[int]] = None,
                      backend: Optional[str] = None,
                      carrier_tracks: Optional[Sequence] = None,
                      exact_carrier=None, device="cuda"
                      ) -> List[torch.Tensor]:
    """Synthesize prepared per-utterance Scores in one synthesizer program.

    `voice` is one voice/name or one per score (shared sample rate and
    jitter rate; per-voice jitter deltas run per utterance). Scores pad to a
    shared element count and length; the outputs are float32 tensors on
    `device`, sliced to each utterance's true length. `backend`: any name of
    `_BACKENDS` (see the module doc), None for default_backend();
    `exact_carrier` and the overlap-save split: see `route`.
    `carrier_tracks` (one per score, entries may be None): exact f32
    carrier phase tracks (runtime/native.native_carrier_track), read
    for one utterance on the fused, xla and scan backends, where a track
    takes precedence over `exact_carrier` (and keeps the fused split)."""
    with span("prep"):
        return _synthesize_scores(list(scores), voice, seeds, backend,
                                  carrier_tracks, exact_carrier, device)


def _synthesize_scores(scores: list, voice, seeds, backend, carrier_tracks,
                       exact_carrier, device) -> List[torch.Tensor]:
    """synthesize_scores inside its caller's `prep` span, which takes the
    route's carrier, S and T."""
    if not scores:
        return []
    b = _Batch(scores, voice, seeds)
    track = _applicable_track(carrier_tracks, b.B, backend)
    impl, carrier, S, T = route(b.B, max(b.Ns), exact_carrier, device, b.sr,
                                backend, track=track is not None)
    annotate(carrier=carrier, S=S, T=T)
    return b.run(impl, carrier, S, T, torch.device(device),
                 _check_backend(backend), track)


def synthesize_batch(texts: Sequence[str], voice="generic",
                     language="generic",
                     seeds: Optional[Sequence[int]] = None,
                     contour: bool = False, speaking_rate: float = 1.0,
                     sample_rate: Optional[float] = None,
                     use_scan: bool = False,
                     backend: Optional[str] = None,
                     exact_carrier=None, device="cuda"
                     ) -> List[torch.Tensor]:
    """Batched synthesis: texts -> one float32 waveform tensor per text, on
    `device` ('cuda' runs the kernels; 'cpu' their plain PyTorch versions).

    `voice` and `language` take one value or one per text (mixed voices
    and languages batch freely; voices must share sample rate and jitter
    rate). A `sample_rate` other than the voice's retargets the voice
    first (reference resampling, src/lib.rs:418-440). `exact_carrier`, as
    in grail_tpu: None (auto: the reference's exact f32 carrier for
    utterances past EXACT_CARRIER_AUTO_SECONDS: the host track of the
    native pre-pass for one utterance of a registered voice; the in-kernel
    recurrence for a batch or a voice file; both split, see `route`), True
    (the exact carrier at any length, by the same rule), 'kernel' (pin the
    in-kernel recurrence), False (Q32 carrier).
    `backend`: 'fused' (None: default_backend()), 'core' ('pallas'), the
    round-1 program, which has the Q32 carrier only (exact_carrier True
    raises; None stays Q32), 'xla' or 'scan' (see the module doc and
    `route`); the '_interpret' names are other names of 'fused' and 'core'.
    `use_scan=True` with no backend named means 'scan', as in grail_tpu."""
    if isinstance(texts, str):
        raise TypeError(
            "texts must be a sequence of strings, not a single string — "
            "synthesize_batch('hello') would synthesize one utterance per "
            "CHARACTER; use synthesize(text) or pass [text]")
    with span("batch", B=len(texts)):
        return _synthesize_batch(texts, voice, language, seeds, contour,
                                 speaking_rate, sample_rate, use_scan,
                                 backend, exact_carrier, device)


def _synthesize_batch(texts, voice, language, seeds, contour, speaking_rate,
                      sample_rate, use_scan, backend, exact_carrier, device
                      ) -> List[torch.Tensor]:
    """synthesize_batch inside its `batch` span, which so also covers the
    release of the call's host objects (the frontend's, ~1 ms at B = 64)."""
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
    if backend is None and use_scan:
        backend = "scan"
    _check_backend(backend)

    with span("frontend"):
        pelems_all = [text_to_phoneme_elems(t, v, lng, contour=contour,
                                            speaking_rate=speaking_rate)
                      for t, v, lng in zip(texts, voices, languages_)]
        scores = [score_from_phoneme_elems(p, v)
                  for p, v in zip(pelems_all, voices)]
    with span("prep"):
        tracks = None
        if B == 1:
            tracks = [_solo_carrier_track(pelems_all[0], voices[0],
                                          seeds[0], exact_carrier, backend)]
        return _synthesize_scores(scores, voices, seeds, backend, tracks,
                                  exact_carrier, device)


def _solo_carrier_track(pelems, v: Voice, seed: int, exact_carrier,
                        backend) -> Optional[np.ndarray]:
    """The host carrier track of a solo utterance, where the caller's
    `exact_carrier` asks for one (True, or None past
    EXACT_CARRIER_AUTO_SECONDS) on a backend that reads tracks (fused, xla,
    scan); None otherwise, and for a voice without a registered spec."""
    if _check_backend(backend) == "core" or exact_carrier == "kernel":
        return None
    if exact_carrier or (exact_carrier is None
                         and _wants_exact_carrier(pelems)):
        return _carrier_track_for(pelems, v, seed)
    return None


def synthesize_score(score: Score, voice, seed: int = 0,
                     sample_rate: Optional[float] = None,
                     use_scan: bool = False,
                     pad_samples_to: Optional[int] = None,
                     backend: Optional[str] = None,
                     carrier_track: Optional[np.ndarray] = None,
                     exact_carrier=None, device="cuda") -> torch.Tensor:
    """Synthesize one prepared Score to a float32 waveform tensor, the solo
    route (grail_tpu's synthesize_score): synthesize_scores with B = 1 on
    the fused and core backends, the unsplit xla or scan program otherwise.

    `backend` None means default_backend(), or 'scan' with use_scan=True;
    use_scan=True with backend 'xla' runs the scan core too.
    `pad_samples_to` pins the length: it must cover the utterance and is
    rounded up to a multiple of BLOCK_SIZE. It, and a `sample_rate` other
    than the voice's (the score is then rendered at that rate, as grail_tpu
    renders it), run on xla or scan only, as in grail_tpu: with no backend
    named they take 'xla'; a fused or core backend named raises ValueError
    (resample the voice first, voice.resampled(sr), as synthesize does).

    `carrier_track` (optional f32 [<= T]): the reference's exact
    per-sample carrier phase (runtime/native.native_carrier_track);
    on the fused, xla and scan backends it replaces the carrier accumulator
    (and keeps the fused split). `synthesize` computes it for long
    utterances."""
    v = _resolve_voice(voice)
    sr = float(sample_rate or v.sample_rate)
    explicit = backend is not None
    name = backend if explicit else ("scan" if use_scan
                                     else default_backend())
    program = _check_backend(name)
    if program in ("fused", "core"):
        if pad_samples_to is None and sr == float(v.sample_rate):
            return synthesize_scores([score], v, seeds=[seed],
                                     exact_carrier=exact_carrier,
                                     device=device, backend=name,
                                     carrier_tracks=[carrier_track])[0]
        if explicit:
            raise ValueError(
                f"backend={backend!r} supports neither pad_samples_to nor a "
                "sample_rate differing from the voice's "
                f"({sr} vs {float(v.sample_rate)}); resample the voice first "
                "(voice.resampled(sr), as synthesize() does) or use "
                "backend='xla'/'scan'")
        program = "xla"
    if use_scan:
        program = "scan"
    b = _Batch([score], v, [seed], sample_rate=sr)
    N = b.Ns[0]
    impl, carrier, S, T = route(1, N, exact_carrier, device, sr, program,
                                track=carrier_track is not None)
    if pad_samples_to is not None:
        if pad_samples_to < N:
            raise ValueError(
                f"pad_samples_to={pad_samples_to} < utterance length {N}")
        T = _round_up(max(int(pad_samples_to), 1), BLOCK_SIZE)
    return b.run(impl, carrier, S, T, torch.device(device), program,
                 carrier_track)[0]


def synthesize(text: str, voice="generic", language="generic", seed: int = 0,
               contour: bool = False, speaking_rate: float = 1.0,
               sample_rate: Optional[float] = None, use_scan: bool = False,
               backend: Optional[str] = None, exact_carrier=None,
               device="cuda") -> torch.Tensor:
    """Text -> float32 waveform tensor (the reference CLI chain, one
    utterance): synthesize_batch of one text, which runs the host frontend,
    the carrier pre-pass where `exact_carrier` asks for it, and the solo
    route. A `sample_rate` other than the voice's retargets the voice
    first. `backend` and `use_scan`: as for synthesize_batch."""
    return synthesize_batch([text], voice, language, seeds=[seed],
                            contour=contour, speaking_rate=speaking_rate,
                            sample_rate=sample_rate,
                            exact_carrier=exact_carrier, device=device,
                            backend=backend, use_scan=use_scan)[0]


__all__ = ["route", "choose_split", "default_backend",
           "text_to_phoneme_elems", "text_to_score",
           "synthesize_scores", "synthesize_batch", "synthesize_score",
           "synthesize",
           "EXACT_CARRIER_AUTO_SECONDS", "BLOCK_SIZE", "WARMUP", "MAX_SPLIT"]
