"""Transcription rulesets.

Reference: TranscriptionRule / Language at grail-rs src/lib.rs:1029-1045.
Rules MUST be lexicographically sorted (binary-search precondition noted at
src/lib.rs:1094-1096); we sort + validate at construction instead of trusting
the author.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

from .phonemes import Phoneme


@dataclass(frozen=True)
class TranscriptionRule:
    string: str
    phonemes: Tuple[Phoneme, ...]

    def __post_init__(self):
        object.__setattr__(self, "phonemes", tuple(Phoneme(int(p)) for p in self.phonemes))


@dataclass(frozen=True)
class IntonationRules:
    """Per-language prosody ruleset (the reference's roadmap intonator:
    "lookahead based intonation ruleset", README.md:15; TODOs at
    src/lib.rs:1062-1066). Drives `intonate(..., contour=True)`; the stub
    parity mode ignores it entirely.

    Frequencies are multiplicative factors on the voice center frequency;
    durations are seconds at speaking_rate=1.0.
    """

    declination: float = 0.25       # F0 drop fraction across a clause
    onset_boost: float = 1.10       # clause-initial F0 factor
    question_rise: float = 1.22     # clause-final factor when clause ends '?'
    statement_fall: float = 0.92    # clause-final factor otherwise
    exclaim_gain: float = 1.08      # overall gain for '!' clauses
    accent_period: int = 2          # stress every k-th vowel
    accent_gain: float = 1.06
    final_lengthen: float = 1.35    # duration stretch in the last window
    final_window: int = 3           # phonemes counted as clause-final
    comma_pause: float = 0.18       # seconds of silence at , ; :
    sentence_pause: float = 0.30    # seconds of silence at . ? !


@dataclass(frozen=True)
class Language:
    rules: Tuple[TranscriptionRule, ...]
    case_sensitive: bool = False
    name: str = ""
    intonation: IntonationRules = IntonationRules()

    def __post_init__(self):
        rules = tuple(sorted(self.rules, key=lambda r: r.string))
        if any(not r.string for r in rules):
            raise ValueError("empty rule strings are not allowed")
        if not self.case_sensitive:
            # the transcriber folds only INPUT chars (ASCII-only, like the
            # reference's to_ascii_lowercase): a rule containing A-Z could
            # never match and would silently degrade text to silence
            bad = [r.string for r in rules
                   if any("A" <= ch <= "Z" for ch in r.string)]
            if bad:
                raise ValueError(
                    f"case-insensitive language {self.name!r}: rules "
                    f"{bad} contain ASCII uppercase and can never match "
                    f"(only input is case-folded; author rules lowercase)")
        object.__setattr__(self, "rules", rules)

    @staticmethod
    def from_pairs(pairs: Sequence[Tuple[str, Sequence[Phoneme]]],
                   case_sensitive: bool = False, name: str = "",
                   intonation: "IntonationRules" = None) -> "Language":
        return Language(
            rules=tuple(TranscriptionRule(s, tuple(p)) for s, p in pairs),
            case_sensitive=case_sensitive,
            name=name,
            intonation=intonation or IntonationRules(),
        )


__all__ = ["TranscriptionRule", "Language", "IntonationRules"]
