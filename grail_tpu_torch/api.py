"""High-level synthesis API: text -> audio, batched, on one device.

The reference's chain (examples/cli.rs:175-184)

    chars.transcribe(lang).intonate(lang, voice).select(voice)
         .sequence(voice).jitter(seed, voice).synthesize()

runs as a host frontend (text -> timed phoneme elements -> a numpy Score
per utterance) followed by one fused synthesizer call over the padded batch
(synth/kernel_fused.py): the CUDA kernel on a GPU, its plain PyTorch version
on the CPU. `route` decides both in one place.

Every utterance runs unsplit: one kernel block walks its whole time axis.
The overlap-save split, host carrier tracks, streaming and the CLI are
later slices; this API has no argument for them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .languages import get_language
from .synth.jitter import JitterLattice, build_lattice
from .synth.kernel_fused import build_tables, synth_fused
from .synth.schedule import device_window
from .synth.score import Score, pad_score, score_from_phoneme_elems, stack_scores
from .text.intonate import intonate
from .text.language import Language
from .text.transcribe import transcribe
from .voices import Voice, get_voice

BLOCK_SIZE = 4096   # utterance lengths pad to a multiple of this

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


def route(B: int, maxN: int, exact_carrier, device,
          sample_rate: float):
    """The one routing decision: (implementation, carrier mode), which
    synthesize_scores hands to kernel_fused.synth_fused as they are.

    implementation: 'kernel' (the CUDA kernel, device 'cuda') or 'plain'
    (its PyTorch version, device 'cpu'); a CUDA device without CUDA raises.
    carrier mode: 'kcar' (the reference's exact f32 recurrence, in the
    kernel) for exact_carrier True or 'kernel', and for exact_carrier None
    when the longest utterance (maxN samples at sample_rate) exceeds
    EXACT_CARRIER_AUTO_SECONDS; 'q32' (fixed point) otherwise.
    B is the batch size: every B runs unsplit in this slice."""
    if B < 1:
        raise ValueError(f"batch size must be >= 1, got {B}")
    if exact_carrier not in _EXACT_CARRIER_CHOICES:
        raise ValueError(f"exact_carrier must be one of "
                         f"{_EXACT_CARRIER_CHOICES}, got {exact_carrier!r}")
    impl = "kernel" if _resolve_device(device).type == "cuda" else "plain"
    if exact_carrier in (True, "kernel") or (
            exact_carrier is None
            and maxN > EXACT_CARRIER_AUTO_SECONDS * float(sample_rate)):
        return impl, "kcar"
    return impl, "q32"


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


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def synthesize_scores(scores: Sequence[Score], voice="generic",
                      seeds: Optional[Sequence[int]] = None,
                      exact_carrier=None,
                      device="cuda") -> List[torch.Tensor]:
    """Synthesize prepared per-utterance Scores in one fused call.

    `voice` is one voice/name or one per score (shared sample rate and
    jitter rate; per-voice jitter deltas run per utterance). Scores pad to a
    shared element count and length; the outputs are float32 tensors on
    `device`, sliced to each utterance's true length. `exact_carrier`: see
    `route`."""
    scores_raw = list(scores)
    B = len(scores_raw)
    if B == 0:
        return []
    voices = [_resolve_voice(v) for v in _per_item(voice, B, "voice")]
    v0 = voices[0]
    sr = float(v0.sample_rate)
    if any(float(v.sample_rate) != sr for v in voices):
        raise ValueError("batched voices must share a sample rate")
    if any(abs(v.jitter_frequency - v0.jitter_frequency) >= 1e-9
           for v in voices):
        raise ValueError("batched voices must share a jitter rate")
    seeds = _seeds(seeds, B)

    E = max(s.num_elems for s in scores_raw)
    scores_p = [pad_score(s, E) for s in scores_raw]
    Ns = [_score_num_samples(s, sr) for s in scores_p]
    impl, carrier = route(B, max(Ns), exact_carrier, device, sr)
    dev = torch.device(device)
    T = _round_up(max(max(Ns), 1), BLOCK_SIZE)

    lat_cache = {}
    for sd in seeds:
        if sd not in lat_cache:
            lat_cache[sd] = build_lattice(sd, T, v0.jitter_frequency)
    lattices = JitterLattice(*(np.stack(f) for f in zip(
        *(lat_cache[sd] for sd in seeds))))
    if any(v is not v0 for v in voices):
        jparams = (v0.jitter_frequency,
                   [v.jitter_delta_frequency for v in voices],
                   [v.jitter_delta_formant_frequency for v in voices],
                   [v.jitter_delta_amplitude for v in voices])
    else:
        jparams = (v0.jitter_frequency, v0.jitter_delta_frequency,
                   v0.jitter_delta_formant_frequency,
                   v0.jitter_delta_amplitude)
    tables = build_tables(stack_scores(scores_p), lattices, jparams, sr,
                          device=dev)
    sched = device_window(v0.jitter_frequency, 0, T, dev)
    audio, _ = synth_fused(tables, T, impl, sched=sched,
                           exact_carrier=carrier == "kcar")
    return [audio[i, :n] for i, n in enumerate(Ns)]


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


__all__ = ["route", "text_to_phoneme_elems", "text_to_score",
           "synthesize_scores", "synthesize_batch", "synthesize",
           "EXACT_CARRIER_AUTO_SECONDS", "BLOCK_SIZE"]
