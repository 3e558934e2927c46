"""The 'generic' language ruleset — rule-parity with the reference
(grail-rs src/languages/mod.rs:7-32): six sorted rules."""

from __future__ import annotations

from ..text.language import Language
from ..text.phonemes import Phoneme

LANGUAGE = Language.from_pairs(
    [
        ("a", [Phoneme.A]),
        ("e", [Phoneme.E]),
        ("i", [Phoneme.A]),
        ("ii", [Phoneme.E, Phoneme.A]),
        ("oui", [Phoneme.A, Phoneme.E, Phoneme.A]),
        ("p", [Phoneme.SILENCE]),
    ],
    case_sensitive=False,
    name="generic",
)
