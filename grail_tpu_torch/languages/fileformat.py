"""Declarative language files: JSON-authored transcription rulesets.

Companion to voices/fileformat.py (the reference's data-file authoring
roadmap, README.md:17). A language is a list of (string -> phoneme names)
rules plus optional case sensitivity and intonation prosody parameters;
sortedness is enforced by the Language constructor as always.

Schema:

    {
      "name": "custom",
      "case_sensitive": false,
      "rules": [["a", ["A"]], ["sh", ["SH"]], ["p", ["STOP", "P"]]],
      "intonation": {"declination": 0.25, "question_rise": 1.22, ...}
    }

Phoneme names are the `Phoneme` enum members (incl. SILENCE/STOP/GLIDE).
"""

from __future__ import annotations

import json

from ..text.language import IntonationRules, Language
from ..text.phonemes import Phoneme


def language_from_dict(doc: dict) -> Language:
    pairs = []
    for item in doc.get("rules", []):
        s, names = item
        pairs.append((str(s), tuple(Phoneme[n] for n in names)))
    intonation = IntonationRules(**doc.get("intonation", {}))
    return Language.from_pairs(pairs,
                               case_sensitive=bool(doc.get("case_sensitive",
                                                           False)),
                               name=str(doc.get("name", "file-language")),
                               intonation=intonation)


def language_to_dict(lang: Language) -> dict:
    import dataclasses

    return {
        "name": lang.name,
        "case_sensitive": lang.case_sensitive,
        "rules": [[r.string, [Phoneme(int(p)).name for p in r.phonemes]]
                  for r in lang.rules],
        "intonation": dataclasses.asdict(lang.intonation),
    }


def load_language_file(path: str) -> Language:
    """Structural problems surface as ValueError (CLI clean-error contract)."""
    with open(path) as fh:
        doc = json.load(fh)
    try:
        return language_from_dict(doc)
    except ValueError:
        raise
    except Exception as e:  # TypeError/AttributeError/KeyError from shape
        raise ValueError(f"malformed language file {path!r}: {e}") from e


def save_language_file(path: str, lang: Language) -> None:
    with open(path, "w") as fh:
        json.dump(language_to_dict(lang), fh, indent=2)


__all__ = ["load_language_file", "save_language_file", "language_from_dict",
           "language_to_dict"]
