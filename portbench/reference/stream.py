"""The plain reference of a stream: a session's fed texts -> its pcm16 audio.

A session that never runs dry speaks its fed texts back to back, so its
audio is one utterance of the texts' elements in feed order:

  * `elements` transcribes and intonates each text alone (the frozen copy
    in reference/plain/), gives the first text the lead silence that a
    whole utterance starts with (grail-rs src/lib.rs:1197-1204) and no
    later one, and merges glides at each join (the previous text's last
    element is the context of the next text's first);
  * `render_stream` renders that list with the exact f32 carrier from
    position 0, through render.py's block loop (the same tables, schedule
    and chain), and converts the audio to 16-bit PCM by the rule of a WAV
    encoder's Rust `as i16`: scale by 32767, saturate, NaN -> 0, truncate
    toward zero.

Where it departs from the port's StreamSession, which it is held against:
it has no rebase (one drift countdown over the whole list from 0, where the
session drops played elements and carries the countdown's residual), no
lattice window (the whole lattice drawn from the seed, where the session
slides a window of it), no idle horizon (a session fed before it runs dry
never appends silence) and no blocks of a tick (one score rendered in
blocks of its own). Each of these the session is built to make invisible:
the comparison decides whether it does.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .plain.languages import get_language
from .plain.synth.fused import ChainState, build_tables, chain_block
from .plain.synth.jitter import build_lattice
from .plain.synth.schedule import get_schedule
from .plain.synth.score import (merge_glides, score_from_phoneme_elems,
                                stack_scores)
from .plain.text.intonate import intonate
from .plain.text.transcribe import transcribe
from .plain.voices import get_voice
from .render import BLOCK_SIZE


def elements(texts: Sequence[str], voice: str, language: str) -> List:
    """The session's element list after feeding `texts` in order."""
    v, lang = get_voice(voice), get_language(language)
    out: List = []
    for k, text in enumerate(texts):
        pelems = intonate(transcribe(text, lang, leading_silence=k == 0),
                          lang, v, contour=False, speaking_rate=1.0)
        if not pelems:
            continue
        tail = out[-1:]
        out = out[:len(out) - len(tail)] + merge_glides(tail + list(pelems))
    return out


def pcm16(audio: np.ndarray) -> np.ndarray:
    """float32 [-1, 1] -> int16: scale, saturate, NaN -> 0, truncate."""
    x = np.asarray(audio, np.float32) * np.float32(32767.0)
    x = np.clip(x, np.float32(-32768.0), np.float32(32767.0))
    x = np.where(np.isnan(x), np.float32(0.0), x)
    return np.trunc(x).astype(np.int16)


def render_stream(texts: Sequence[str], seed: int, voice: str,
                  language: str, device, stop: int, dtype=torch.float32,
                  block: int = 0) -> np.ndarray:
    """The first `stop` samples of the session fed `texts` with `seed`, as
    int16 PCM (zero past the elements' end), rendered in blocks of `block`
    samples on `device` (0: 65,536 on a card, 8,192 on the CPU)."""
    v = get_voice(voice)
    block = block or (65536 if torch.device(device).type == "cuda" else 8192)
    score = score_from_phoneme_elems(elements(texts, voice, language), v)
    T = int(stop)
    T_pad = -(-T // BLOCK_SIZE) * BLOCK_SIZE
    inc = v.jitter_frequency
    lat = tuple(f[None] for f in build_lattice(int(seed), T_pad, inc))
    jparams = (inc, v.jitter_delta_frequency,
               v.jitter_delta_formant_frequency, v.jitter_delta_amplitude)
    tables = build_tables(stack_scores([score]), lat, jparams,
                          np.float32(v.sample_rate), device=device,
                          dtype=dtype)
    phi, cell = get_schedule(inc).window(0, T)
    phi = torch.from_numpy(np.ascontiguousarray(phi)).to(device)
    cell = torch.from_numpy(np.ascontiguousarray(cell)).to(device)
    state = ChainState.init(1, device, dtype)
    out = np.zeros(T, np.float32)
    with torch.no_grad():
        for s in range(0, T, block):
            e = min(T, s + block)
            audio, state = chain_block(tables, s, phi[s:e], cell[s:e], state,
                                       True)
            out[s:e] = audio[0].to("cpu", torch.float32).numpy()
    return pcm16(out)
