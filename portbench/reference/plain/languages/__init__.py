"""Language presets + registry (reference: grail-rs src/languages/mod.rs)."""

from __future__ import annotations

from typing import Dict

from ..text.language import Language

_LANGS: Dict[str, Language] = {}


def register_language(lang: Language) -> None:
    if not lang.name:
        raise ValueError("language must have a name to be registered")
    _LANGS[lang.name] = lang


def language_names():
    return sorted(_LANGS)


def get_language(name: str) -> Language:
    try:
        return _LANGS[name]
    except KeyError:
        raise KeyError(f"unknown language {name!r}; available: {language_names()}") from None


def generic() -> Language:
    """The built-in ruleset, mirroring languages::generic()."""
    return _LANGS["generic"]


from .preset_generic import LANGUAGE as _GENERIC_LANGUAGE  # noqa: E402
from .preset_english import LANGUAGE as _ENGLISH_LANGUAGE  # noqa: E402

register_language(_GENERIC_LANGUAGE)
register_language(_ENGLISH_LANGUAGE)

__all__ = ["register_language", "language_names", "get_language", "generic", "Language"]
