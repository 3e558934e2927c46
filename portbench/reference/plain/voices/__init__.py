"""Voice presets + registry (reference: grail-rs src/voices/mod.rs)."""

from __future__ import annotations

from typing import Dict

from .voice import PhonemeSpec, Voice, VoiceSpec, compile_voice

_SPECS: Dict[str, VoiceSpec] = {}
_COMPILED: Dict[str, Voice] = {}


def register_voice(spec: VoiceSpec) -> None:
    _SPECS[spec.name] = spec
    _COMPILED.pop(spec.name, None)


def voice_names():
    return sorted(_SPECS)


def get_spec(name: str) -> VoiceSpec:
    try:
        return _SPECS[name]
    except KeyError:
        raise KeyError(f"unknown voice {name!r}; available: {voice_names()}") from None


def get_voice(name: str) -> Voice:
    if name not in _COMPILED:
        _COMPILED[name] = compile_voice(get_spec(name))
    return _COMPILED[name]


def generic() -> Voice:
    """The built-in preset, mirroring voices::generic()."""
    return get_voice("generic")


from .preset_generic import SPEC as _GENERIC_SPEC  # noqa: E402
from .preset_plain import SPEC as _PLAIN_SPEC  # noqa: E402

register_voice(_GENERIC_SPEC)
register_voice(_PLAIN_SPEC)

__all__ = [
    "PhonemeSpec", "VoiceSpec", "Voice", "compile_voice",
    "register_voice", "voice_names", "get_spec", "get_voice", "generic",
]
