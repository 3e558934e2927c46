"""The plain reference: texts and seeds -> audio, with no code of the port.

`utterances` runs the host frontend (transcription, intonation, selection,
the score with its drift boundaries) of the frozen copy in
reference/plain/. `render` runs the fused chain of reference/plain/synth/
fused.py over a group of lanes, in blocks of samples, with the carrier
that the batch's semantics demand: the reference's exact f32 recurrence
when the batch's longest utterance passes EXACT_CARRIER_AUTO_SECONDS, the
Q32 accumulator below (grail_tpu_torch.api.route's rule), or the exact
one always for a stream.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .plain.languages import get_language
from .plain.synth.fused import ChainState, build_tables, chain_block
from .plain.synth.jitter import build_lattice
from .plain.synth.schedule import get_schedule
from .plain.synth.score import pad_score, score_from_phoneme_elems, stack_scores
from .plain.text.intonate import intonate
from .plain.text.transcribe import transcribe
from .plain.voices import get_voice

EXACT_CARRIER_AUTO_SECONDS = 30.0
BLOCK_SIZE = 4096


def utterance(text: str, voice: str, language: str):
    """One text -> its Score (the frontend of the frozen copy)."""
    v, lang = get_voice(voice), get_language(language)
    pelems = intonate(transcribe(text, lang), lang, v, contour=False,
                      speaking_rate=1.0)
    return score_from_phoneme_elems(pelems, v)


def num_samples(score, voice: str) -> int:
    """An utterance's sample count: floor(f32 cum_length[-1] * sr)."""
    sr = np.float32(get_voice(voice).sample_rate)
    C = np.asarray(score.cum_length, np.float32)
    return int(np.floor(np.float32(C[-1]) * sr))


def longest_samples(texts: Sequence[str], voice: str, language: str) -> int:
    """The longest utterance's sample count in a batch: the total element
    length of each text (no drift) picks the three longest, whose scores
    give the exact count."""
    v, lang = get_voice(voice), get_language(language)
    approx = []
    for t in texts:
        pe = intonate(transcribe(t, lang), lang, v, contour=False,
                      speaking_rate=1.0)
        approx.append(sum(float(p.length) for p in pe))
    top = np.argsort(approx)[::-1][:3]
    return max(num_samples(utterance(texts[i], voice, language), voice)
               for i in top)


def exact_carrier(longest_samples: int, voice: str) -> bool:
    """The batch carrier rule: exact f32 past EXACT_CARRIER_AUTO_SECONDS."""
    sr = float(get_voice(voice).sample_rate)
    return longest_samples > EXACT_CARRIER_AUTO_SECONDS * sr


def render(texts: Sequence[str], seeds: Sequence[int], voice: str,
           language: str, kcar: bool, device, stop: Optional[int] = None,
           dtype=torch.float32, block: int = 0, lengths: bool = False
           ) -> list:
    """Audio of each text (float32 numpy, its own length; with `stop`, the
    first `stop` samples, zero past the utterance's end), rendered
    together in blocks of `block` samples on `device` (0: 65,536 on a
    card, 8,192 on the CPU). With `lengths`,
    (audio, the utterance's sample count) pairs."""
    v = get_voice(voice)
    block = block or (65536 if torch.device(device).type == "cuda" else 8192)
    scores = [utterance(t, voice, language) for t in texts]
    E = max(s.num_elems for s in scores)
    scores = [pad_score(s, E) for s in scores]
    sr = np.float32(v.sample_rate)
    Ns = [num_samples(s, voice) for s in scores]
    T = stop if stop is not None else max(max(Ns), 1)
    T_pad = -(-T // BLOCK_SIZE) * BLOCK_SIZE
    inc = v.jitter_frequency
    lattices = [build_lattice(int(sd), T_pad, inc) for sd in seeds]
    lat = tuple(np.stack(f) for f in zip(*lattices))
    jparams = (inc, v.jitter_delta_frequency,
               v.jitter_delta_formant_frequency, v.jitter_delta_amplitude)
    tables = build_tables(stack_scores(scores), lat, jparams, sr,
                          device=device, dtype=dtype)
    phi, cell = get_schedule(inc).window(0, T)
    phi = torch.from_numpy(np.ascontiguousarray(phi)).to(device)
    cell = torch.from_numpy(np.ascontiguousarray(cell)).to(device)
    state = ChainState.init(len(texts), device, dtype)
    out = np.zeros((len(texts), T), np.float32)
    with torch.no_grad():
        for s in range(0, T, block):
            e = min(T, s + block)
            audio, state = chain_block(tables, s, phi[s:e], cell[s:e], state,
                                       kcar)
            out[:, s:e] = audio.to("cpu", torch.float32).numpy()
    audio = (list(out) if stop is not None
             else [out[i, :n] for i, n in enumerate(Ns)])
    return list(zip(audio, Ns)) if lengths else audio
