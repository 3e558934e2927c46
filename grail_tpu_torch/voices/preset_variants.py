"""Derived voice presets: 'bright' and 'deep' variants of 'plain'.

Demonstrates programmatic voice authoring (the reference's README.md:17
plans a voice-file macro; here voices are plain dataclasses, so deriving a
new voice is a dict comprehension): formant scaling shifts perceived vocal
tract length, center frequency shifts pitch.
"""

from __future__ import annotations


from .preset_plain import SPEC as _PLAIN
from .voice import PhonemeSpec, VoiceSpec


def _scaled(name: str, formant_scale: float, center_hz: float,
            breath_boost: float = 0.0) -> VoiceSpec:
    phonemes = {}
    for pname, ph in _PLAIN.phonemes.items():
        phonemes[pname] = PhonemeSpec(
            freq=tuple(f * formant_scale for f in ph.freq),
            bw=tuple(b * formant_scale for b in ph.bw),
            smooth=ph.smooth,
            turb=ph.turb,
            breath=tuple(min(1.0, b + breath_boost) for b in ph.breath),
            amp=ph.amp,
        )
    return VoiceSpec(
        name=name,
        phonemes=phonemes,
        center_frequency_hz=center_hz,
        jitter_frequency_hz=_PLAIN.jitter_frequency_hz,
        jitter_delta_frequency_hz=_PLAIN.jitter_delta_frequency_hz,
        jitter_delta_formant_frequency_hz=_PLAIN.jitter_delta_formant_frequency_hz,
        jitter_delta_amplitude=_PLAIN.jitter_delta_amplitude,
    )


BRIGHT = _scaled("bright", formant_scale=1.18, center_hz=210.0)
DEEP = _scaled("deep", formant_scale=0.88, center_hz=90.0)
WHISPER = _scaled("whisper", formant_scale=1.0, center_hz=120.0, breath_boost=0.85)
