"""Voice model: Hz-authored spec -> compiled, normalized parameter tables.

Reference: `Voice` + `VoiceStorage` (grail-rs src/lib.rs:653-717) and
the preset compiler behavior of `SynthesisElem::new_phoneme`
(src/lib.rs:381-401): per-phoneme amplitude tables are normalized to unit
gain, then all frequency-valued fields are converted from Hz to
sample-rate-normalized units with Nyquist clamping (resample, src/lib.rs:418-440).

A compiled Voice packs every sound phoneme's SynthesisElem into one
[P, NUM_FORMANTS] numpy table plus a `defined` mask, so phoneme -> parameter
lookup is a single gather. Host-side numpy throughout: the copy of
grail_tpu/voices/voice.py without its pytree registration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from ..core.constants import DEFAULT_SAMPLE_RATE, NUM_FORMANTS
from ..synth.elem import SynthesisElem
from ..text.phonemes import NUM_SOUND_PHONEMES, Phoneme, is_sound, sound_index


@dataclass(frozen=True)
class PhonemeSpec:
    """Hz-authored tables for one phoneme, in MKPHON argument order
    (grail-rs src/voices/mod.rs:7-14)."""

    freq: Tuple[float, ...]    # formant frequencies, Hz
    bw: Tuple[float, ...]      # formant bandwidths, Hz
    smooth: Tuple[float, ...]  # lowpass cutoffs, Hz
    turb: Tuple[float, ...]    # turbulence amounts, 0..1
    breath: Tuple[float, ...]  # breathiness, 0..1
    amp: Tuple[float, ...]     # relative amplitudes (normalized to unit gain)


@dataclass(frozen=True)
class VoiceSpec:
    """A voice as authored: per-phoneme Hz tables + prosody/jitter params."""

    name: str
    phonemes: Dict[str, PhonemeSpec]
    center_frequency_hz: float = 120.0
    jitter_frequency_hz: float = 16.0
    jitter_delta_frequency_hz: float = 6.0
    jitter_delta_formant_frequency_hz: float = 6.0
    jitter_delta_amplitude: float = 0.2
    sample_rate: float = DEFAULT_SAMPLE_RATE


@dataclass(frozen=True)
class Voice:
    """Compiled voice. `table` has leading dim [NUM_SOUND_PHONEMES]; its
    leaves and `defined` are numpy arrays."""

    sample_rate: float
    table: SynthesisElem          # [P, ...] normalized parameter table
    defined: np.ndarray           # [P] bool: does this voice define the phoneme
    center_frequency: float       # normalized
    jitter_frequency: float       # normalized
    jitter_delta_frequency: float
    jitter_delta_formant_frequency: float
    jitter_delta_amplitude: float
    name: str = ""

    def get(self, phoneme: Phoneme):
        """VoiceStorage::get (src/lib.rs:664-671): None for a special or an
        undefined phoneme, else the phoneme's SynthesisElem row."""
        p = int(phoneme)
        if not is_sound(p) or not bool(self.defined[sound_index(p)]):
            return None
        return self.table[sound_index(p)]

    def resampled(self, new_sample_rate: float) -> "Voice":
        """Retarget the voice to a different output sample rate
        (reference resampling support, src/lib.rs:20-21, 418-440)."""
        if new_sample_rate == self.sample_rate:
            return self
        r = self.sample_rate / new_sample_rate
        from ..synth.jitter import MAX_JITTER_INC
        if self.jitter_frequency * r > MAX_JITTER_INC:
            raise ValueError(
                f"voice {self.name!r}: resampling to {new_sample_rate:.0f} Hz puts "
                f"the jitter rate above the supported bound "
                f"({MAX_JITTER_INC * new_sample_rate:.0f} Hz)")
        return Voice(
            sample_rate=new_sample_rate,
            table=_np_resample(self.table, self.sample_rate,
                               new_sample_rate),
            defined=self.defined,
            center_frequency=min(self.center_frequency * r, 0.5),
            jitter_frequency=self.jitter_frequency * r,
            jitter_delta_frequency=self.jitter_delta_frequency * r,
            jitter_delta_formant_frequency=self.jitter_delta_formant_frequency * r,
            jitter_delta_amplitude=self.jitter_delta_amplitude,
            name=self.name,
        )


def _np_resample(e: SynthesisElem, old_sr: float, new_sr: float) -> SynthesisElem:
    """SynthesisElem::resample (reference src/lib.rs:418-440) in numpy:
    carrier and formant freqs clamp to Nyquist (0.5); amplitudes of formants
    whose unclamped scaled frequency exceeds Nyquist are zeroed."""
    scale = np.float32(old_sr / new_sr)
    scaled_ff = (e.formant_freq * scale).astype(np.float32)
    return SynthesisElem(
        frequency=np.minimum(e.frequency * scale, np.float32(0.5)).astype(np.float32),
        formant_freq=np.minimum(scaled_ff, np.float32(0.5)).astype(np.float32),
        formant_bw=(e.formant_bw * scale).astype(np.float32),
        formant_smooth=(e.formant_smooth * scale).astype(np.float32),
        formant_breath=np.asarray(e.formant_breath, np.float32),
        formant_turb=np.asarray(e.formant_turb, np.float32),
        formant_amp=np.where(scaled_ff > 0.5, np.float32(0), e.formant_amp).astype(np.float32),
    )


def _np_new_phoneme(freq, bw, smooth, turb, breath, amp) -> SynthesisElem:
    """Numpy mirror of SynthesisElem.new_phoneme (src/lib.rs:381-401)."""
    amp = np.asarray(amp, np.float32)
    # Rust's iter().sum() is a SEQUENTIAL left fold in f32; numpy's
    # pairwise sum rounds differently in ~40% of 8-element rows (1 ulp),
    # which would break bit-parity with the oracle's tables
    total = amp[..., 0]
    for j in range(1, amp.shape[-1]):
        total = (total + amp[..., j]).astype(np.float32)
    amp = (amp / total[..., None]).astype(np.float32)
    e = SynthesisElem(
        frequency=np.zeros(amp.shape[:-1], np.float32),
        formant_freq=np.asarray(freq, np.float32),
        formant_bw=np.asarray(bw, np.float32),
        formant_smooth=np.asarray(smooth, np.float32),
        formant_breath=np.asarray(breath, np.float32),
        formant_turb=np.asarray(turb, np.float32),
        formant_amp=amp,
    )
    return _np_resample(e, 1.0, DEFAULT_SAMPLE_RATE)


def compile_voice(spec: VoiceSpec) -> Voice:
    """Compile an Hz-authored VoiceSpec into normalized parameter tables."""
    P = NUM_SOUND_PHONEMES
    fields = {k: np.zeros((P, NUM_FORMANTS), np.float32)
              for k in ("freq", "bw", "smooth", "turb", "breath", "amp")}
    defined = np.zeros((P,), bool)
    # benign defaults so undefined rows can't produce NaNs (freq>0 for k=bw/f)
    fields["freq"][:] = 0.25 * spec.sample_rate
    fields["bw"][:] = 0.25 * spec.sample_rate
    fields["smooth"][:] = 0.25 * spec.sample_rate
    fields["amp"][:] = 1.0  # unit-gain normalize keeps rows finite

    for name, ph in spec.phonemes.items():
        i = sound_index(Phoneme[name])
        defined[i] = True
        for k in fields:
            v = np.asarray(getattr(ph, k), np.float32)
            if v.shape != (NUM_FORMANTS,):
                raise ValueError(f"{spec.name}/{name}/{k}: expected {NUM_FORMANTS} values")
            fields[k][i] = v
        if float(np.sum(fields["amp"][i], dtype=np.float64)) == 0.0:
            raise ValueError(
                f"{spec.name}/{name}: amp row sums to zero — unit-gain "
                f"normalization would produce NaN parameters")

    table = _np_new_phoneme(
        freq=fields["freq"], bw=fields["bw"], smooth=fields["smooth"],
        turb=fields["turb"], breath=fields["breath"], amp=fields["amp"],
    )
    if spec.sample_rate != DEFAULT_SAMPLE_RATE:
        # new_phoneme normalized to DEFAULT; re-target to the voice's rate
        table = _np_resample(table, DEFAULT_SAMPLE_RATE, spec.sample_rate)

    sr = spec.sample_rate
    from ..synth.jitter import MAX_JITTER_INC
    if spec.jitter_frequency_hz / sr > MAX_JITTER_INC:
        raise ValueError(
            f"voice {spec.name!r}: jitter_frequency {spec.jitter_frequency_hz} Hz "
            f"exceeds the supported bound {MAX_JITTER_INC * sr:.0f} Hz")
    return Voice(
        sample_rate=sr,
        table=table,
        defined=defined,
        center_frequency=spec.center_frequency_hz / sr,
        jitter_frequency=spec.jitter_frequency_hz / sr,
        jitter_delta_frequency=spec.jitter_delta_frequency_hz / sr,
        jitter_delta_formant_frequency=spec.jitter_delta_formant_frequency_hz / sr,
        jitter_delta_amplitude=spec.jitter_delta_amplitude,
        name=spec.name,
    )


__all__ = ["PhonemeSpec", "VoiceSpec", "Voice", "compile_voice"]
