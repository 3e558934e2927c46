"""The 'generic' voice preset — parameter-parity with the reference preset
(grail-rs src/voices/generic.rs:5-39): formant tables in Hz for the
A and E vowels, 120 Hz center frequency, 16 Hz jitter rate, 6 Hz frequency
deltas, 0.2 amplitude delta."""

from __future__ import annotations

from .voice import PhonemeSpec, VoiceSpec

SPEC = VoiceSpec(
    name="generic",
    phonemes={
        "A": PhonemeSpec(
            freq=(910.0, 1271.0, 2851.0, 3213.0, 1200.0, 2000.0, 3000.0, 4000.0),
            bw=(60.0, 160.0, 180.0, 200.0, 100.0, 100.0, 100.0, 100.0),
            smooth=(1600.0,) * 8,
            turb=(0.2, 0.2, 0.1, 0.0, 0.0, 0.0, 0.0, 0.0),
            breath=(0.5, 0.2, 0.05, 0.0, 0.0, 0.0, 0.0, 0.0),
            amp=(0.3, 0.3, 0.2, 0.1, 0.0, 0.0, 0.0, 0.0),
        ),
        "E": PhonemeSpec(
            freq=(910.0, 1871.0, 2851.0, 3213.0, 1200.0, 2000.0, 3000.0, 4000.0),
            bw=(80.0, 180.0, 180.0, 200.0, 100.0, 100.0, 100.0, 100.0),
            smooth=(1600.0,) * 8,
            turb=(0.2, 0.4, 0.4, 0.4, 0.4, 0.4, 0.4, 0.4),
            breath=(1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.1, 0.1),
            amp=(0.5, 0.4, 0.3, 0.2, 0.0, 0.0, 0.0, 0.0),
        ),
    },
    center_frequency_hz=120.0,
    jitter_frequency_hz=16.0,
    jitter_delta_frequency_hz=6.0,
    jitter_delta_formant_frequency_hz=6.0,
    jitter_delta_amplitude=0.2,
)
