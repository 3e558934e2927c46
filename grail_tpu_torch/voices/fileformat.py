"""Declarative voice files: JSON-authored voices loaded at runtime.

The reference's roadmap plans "a macro to generate voice files"
(grail-rs README.md:17) — a data-driven way to author voices without
touching code. Here a voice is a JSON document of Hz tables (exactly the
`VoiceSpec` authoring model the code presets use), compiled through the same
`compile_voice` path (unit-gain normalize + Hz->normalized + Nyquist
handling, src/lib.rs:381-401, 418-440).

Schema (all frequencies in Hz; every phoneme table has NUM_FORMANTS values):

    {
      "name": "custom",
      "sample_rate": 44100.0,
      "center_frequency_hz": 120.0,
      "jitter": {
        "frequency_hz": 16.0,
        "delta_frequency_hz": 6.0,
        "delta_formant_frequency_hz": 6.0,
        "delta_amplitude": 0.2
      },
      "phonemes": {
        "A": {"freq": [...], "bw": [...], "smooth": [...],
               "turb": [...], "breath": [...], "amp": [...]},
        ...
      }
    }
"""

from __future__ import annotations

import json
from typing import Union

from .voice import PhonemeSpec, Voice, VoiceSpec, compile_voice

_FIELDS = ("freq", "bw", "smooth", "turb", "breath", "amp")


def spec_from_dict(doc: dict) -> VoiceSpec:
    jit = doc.get("jitter", {})
    phonemes = {}
    for name, tabs in doc.get("phonemes", {}).items():
        missing = [f for f in _FIELDS if f not in tabs]
        if missing:
            raise ValueError(f"phoneme {name!r}: missing fields {missing}")
        phonemes[name] = PhonemeSpec(**{f: tuple(float(x) for x in tabs[f])
                                        for f in _FIELDS})
    if not phonemes:
        raise ValueError("voice file defines no phonemes")
    return VoiceSpec(
        name=str(doc.get("name", "file-voice")),
        phonemes=phonemes,
        center_frequency_hz=float(doc.get("center_frequency_hz", 120.0)),
        jitter_frequency_hz=float(jit.get("frequency_hz", 16.0)),
        jitter_delta_frequency_hz=float(jit.get("delta_frequency_hz", 6.0)),
        jitter_delta_formant_frequency_hz=float(
            jit.get("delta_formant_frequency_hz", 6.0)),
        jitter_delta_amplitude=float(jit.get("delta_amplitude", 0.2)),
        sample_rate=float(doc.get("sample_rate", 44100.0)),
    )


def spec_to_dict(spec: VoiceSpec) -> dict:
    return {
        "name": spec.name,
        "sample_rate": spec.sample_rate,
        "center_frequency_hz": spec.center_frequency_hz,
        "jitter": {
            "frequency_hz": spec.jitter_frequency_hz,
            "delta_frequency_hz": spec.jitter_delta_frequency_hz,
            "delta_formant_frequency_hz": spec.jitter_delta_formant_frequency_hz,
            "delta_amplitude": spec.jitter_delta_amplitude,
        },
        "phonemes": {
            name: {f: list(getattr(ph, f)) for f in _FIELDS}
            for name, ph in spec.phonemes.items()
        },
    }


def load_voice_file(path: str) -> Voice:
    """Load + compile a JSON voice file.

    Any structural problem (wrong types, missing tables, empty document)
    surfaces as ValueError so the CLI's clean-error contract holds."""
    with open(path) as fh:
        doc = json.load(fh)
    try:
        return compile_voice(spec_from_dict(doc))
    except ValueError:
        raise
    except Exception as e:  # TypeError/AttributeError/KeyError from shape
        raise ValueError(f"malformed voice file {path!r}: {e}") from e


def save_voice_file(path: str, spec: Union[VoiceSpec, dict]) -> None:
    doc = spec if isinstance(spec, dict) else spec_to_dict(spec)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2)


__all__ = ["load_voice_file", "save_voice_file", "spec_from_dict",
           "spec_to_dict"]
