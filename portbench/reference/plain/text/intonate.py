"""Intonation: Phoneme -> PhonemeElem (adds pitch + duration).

The reference Intonator (grail-rs src/lib.rs:1047-1089) is a stub: it
emits a fixed 0.5 s length, 0.5 s blend, and the voice's constant center
frequency for every phoneme (its TODOs at src/lib.rs:1062-1066 list contour,
speaking rate and per-phoneme durations as planned work; README.md:15 plans a
lookahead ruleset). The target configs require a *working* intonator,
so we ship two:

  * `intonate(..., contour=False)`  - the reference's exact stub semantics
    (used for parity / golden tests).
  * `intonate(..., contour=True)`   - a real contour: per-class durations,
    declining F0 with accent bumps, phrase-final lengthening and fall,
    speaking-rate control. Pure host-side preprocessing; the device kernel
    only ever sees the resulting parameter score.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from .language import Language
from .phonemes import Phoneme, is_sound


@dataclass(frozen=True)
class PhonemeElem:
    """Reference PhonemeElem (src/lib.rs:960-973)."""

    phoneme: Phoneme
    length: float        # seconds
    blend_length: float  # seconds
    frequency: float     # normalized to sample rate


# --- duration classes (seconds, at speaking_rate=1.0) for the contour mode
_VOWELS = {"A", "E", "I", "O", "U", "AE", "AH", "IH", "EH", "UH", "OW"}
_NASALS_LIQUIDS = {"M", "N", "NG", "L", "R", "W", "Y"}
_FRICATIVES = {"V", "Z", "ZH", "DH", "F", "S", "SH", "TH", "H"}
_PLOSIVES = {"P", "B", "T", "D", "K", "G"}


def _duration(p: Phoneme) -> float:
    name = p.name
    if name in _VOWELS:
        return 0.16
    if name in _NASALS_LIQUIDS:
        return 0.10
    if name in _FRICATIVES:
        return 0.11
    if name in _PLOSIVES:
        return 0.05  # short release burst
    if p == Phoneme.STOP:
        return 0.04  # closure gap
    if p == Phoneme.SILENCE:
        return 0.12
    return 0.10


def intonate(
    phonemes: Sequence[Phoneme],
    language: Language,
    voice,
    contour: bool = False,
    speaking_rate: float = 1.0,
    seed: int = 0,
    clause: str = "statement",
) -> List[PhonemeElem]:
    """Assign length/blend/pitch to a phoneme sequence.

    With contour=False this reproduces the reference stub exactly:
    length=0.5, blend_length=0.5, frequency=voice.center_frequency
    (src/lib.rs:1068-1073); `language` is unused exactly like the
    reference's `_language` parameter.

    With contour=True the LANGUAGE's IntonationRules drive the prosody (the
    reference's roadmap "lookahead based intonation ruleset", README.md:15):
    declination across the clause, periodic vowel accents, clause-final
    lengthening, and a clause-type-dependent boundary tone — `clause` is
    one of 'statement' (final fall), 'question' (final rise), 'exclamation'
    (final fall, raised overall gain). The frontend (api.text_to_score)
    segments text into clauses at punctuation and passes the type per
    clause — the lookahead the reference planned.
    """
    cf = float(voice.center_frequency)
    if not contour:
        # stub parity at speaking_rate=1.0 (0.5/1.0 == 0.5 exactly); the
        # rate knob still works in stub mode by scaling the fixed lengths
        d = 0.5 / max(speaking_rate, 1e-3)
        return [PhonemeElem(p, d, d, cf) for p in phonemes]

    from .language import IntonationRules

    r = getattr(language, "intonation", None) or IntonationRules()
    gain = r.exclaim_gain if clause == "exclamation" else 1.0
    boundary = r.question_rise if clause == "question" else r.statement_fall

    elems: List[PhonemeElem] = []
    n_sound = max(1, sum(1 for p in phonemes if is_sound(p)))
    sound_i = 0
    vowel_i = 0
    for p in phonemes:
        dur = _duration(p) / max(speaking_rate, 1e-3)
        if is_sound(p):
            # declination: F0 falls across the clause
            pos = sound_i / n_sound
            f = cf * gain * (r.onset_boost - (r.onset_boost - 1.0
                                              + r.declination) * pos)
            # periodic accent on early vowels — counted over VOWELS (a raw
            # sound counter made stress an artifact of consonant parity:
            # CV-alternating words would never accent at period 2)
            if p.name in _VOWELS:
                if (r.accent_period > 0
                        and vowel_i % r.accent_period == 0 and pos < 0.8):
                    f *= r.accent_gain
                vowel_i += 1
            # clause-final boundary tone + lengthening over the last k
            # SOUNDS (a raw index window could cover only trailing STOP
            # markers/consonants, leaving the final vowel without the
            # question rise)
            if n_sound - sound_i <= r.final_window:
                f *= boundary
                dur *= r.final_lengthen
            sound_i += 1
        else:
            f = cf
        blend = min(0.5 * dur, 0.06 / max(speaking_rate, 1e-3))
        elems.append(PhonemeElem(p, dur, blend, f))
    return elems


_CLAUSE_END = {".": "statement", "?": "question", "!": "exclamation",
               ",": "comma", ";": "comma", ":": "comma"}


def split_clauses_partial(text: str, final: bool = False):
    """Incremental clause segmentation: (clauses, tail) where clauses are
    TERMINATED (clause_text, kind, pause_kind) tuples and `tail` is the raw
    unterminated remainder (streaming frontends buffer it until more text
    or a flush arrives). kind is 'statement'/'question'/'exclamation';
    pause_kind is 'comma'/'sentence'.

    '.', ':' and ';' directly between two digits do NOT terminate a clause
    ("3.14", "3:30" — a sentence pause mid-number is never intended);
    abbreviations ("Dr. Smith") are out of scope for this rule. Without
    `final`, such a punctuation mark at the very end of a digit-trailing
    buffer is held back too (the next feed may continue the number);
    final=True (end of input) lets it terminate normally."""
    out = []
    start = 0
    for i, ch in enumerate(text):
        if ch not in _CLAUSE_END:
            continue
        if ch in ".;:" and i > 0 and text[i - 1].isdigit():
            if i + 1 < len(text) and text[i + 1].isdigit():
                continue                      # mid-number: not a boundary
            if i + 1 == len(text) and not final:
                break                         # "…3." — digits may follow
        kind = _CLAUSE_END[ch]
        clause = text[start:i].strip()
        start = i + 1
        if clause:
            if kind == "comma":
                out.append((clause, "statement", "comma"))
            else:
                out.append((clause, kind, "sentence"))
    return out, text[start:]


def split_clauses(text: str) -> List[tuple]:
    """Segment text at punctuation into (clause_text, kind, pause_kind)
    tuples; kind is 'statement'/'question'/'exclamation' and pause_kind is
    'comma'/'sentence'/None (trailing clause without punctuation)."""
    out, tail = split_clauses_partial(text, final=True)
    tail = tail.strip()
    if tail:
        out.append((tail, "statement", None))
    return out


__all__ = ["PhonemeElem", "intonate", "split_clauses", "split_clauses_partial"]
