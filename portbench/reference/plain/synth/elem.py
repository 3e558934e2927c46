"""SynthesisElem: the synthesis parameter frame (grail-rs src/lib.rs:316-460).

One scalar carrier frequency plus six 8-wide formant fields, all
frequency-valued fields normalized to the sample rate. The leaves are numpy
arrays on the host (voice tables, scores) and become tensors with `.to`;
the cores take frames of tensors [T, B(, 8)].

The reference's SynthesisElem API, in numpy float32 with grail_tpu's
operation order (grail_tpu/synth/elem.py), so that each op gives the JAX
version's bits:
  silent              src/lib.rs:367-377
  blend               src/lib.rs:404-414
  resample            src/lib.rs:418-440 (Nyquist clamp; amps above it 0)
  copy_with_frequency src/lib.rs:445-450
  copy_silent         src/lib.rs:454-459
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.constants import NUM_FORMANTS

_F32 = np.float32


class SynthesisElem(NamedTuple):
    """Synthesis parameters. Leading dims are free (phoneme, element, batch
    or time). Indexing (`elem[idx]`) indexes every leaf, as grail_tpu's
    does; the fields are read by name."""

    frequency: np.ndarray       # [...], base (carrier) frequency
    formant_freq: np.ndarray    # [..., NUM_FORMANTS]
    formant_bw: np.ndarray      # [..., NUM_FORMANTS]
    formant_smooth: np.ndarray  # [..., NUM_FORMANTS]
    formant_breath: np.ndarray  # [..., NUM_FORMANTS]
    formant_turb: np.ndarray    # [..., NUM_FORMANTS]
    formant_amp: np.ndarray     # [..., NUM_FORMANTS]

    def to(self, device) -> "SynthesisElem":
        """Every leaf as a float32 tensor on `device`."""
        return SynthesisElem(*(torch.as_tensor(f, dtype=torch.float32,
                                               device=device) for f in self))

    # ---- ops ----------------------------------------------------------

    def blend(self, other: "SynthesisElem", alpha) -> "SynthesisElem":
        """lerp(self, other, alpha) = self * (1 - alpha) + other * alpha;
        alpha may broadcast over the leading dims."""
        a = np.asarray(alpha, _F32)
        af = a[..., None] if a.ndim else a

        def lerp(x, y, aa):
            x, y = np.asarray(x, _F32), np.asarray(y, _F32)
            return x * (_F32(1.0) - aa) + y * aa

        return SynthesisElem(
            frequency=lerp(self.frequency, other.frequency, a),
            formant_freq=lerp(self.formant_freq, other.formant_freq, af),
            formant_bw=lerp(self.formant_bw, other.formant_bw, af),
            formant_smooth=lerp(self.formant_smooth, other.formant_smooth, af),
            formant_breath=lerp(self.formant_breath, other.formant_breath, af),
            formant_turb=lerp(self.formant_turb, other.formant_turb, af),
            formant_amp=lerp(self.formant_amp, other.formant_amp, af),
        )

    def resample(self, old_sample_rate, new_sample_rate) -> "SynthesisElem":
        """Rescale every normalized frequency to a new sample rate, as the
        reference does: carrier and formant frequencies clamp to Nyquist
        (0.5); the amplitudes of formants whose unclamped scaled frequency
        exceeds Nyquist become 0; breath and turbulence are untouched."""
        scale = _F32(old_sample_rate / new_sample_rate)
        scaled_ff = np.asarray(self.formant_freq, _F32) * scale
        return self._replace(
            frequency=np.minimum(np.asarray(self.frequency, _F32) * scale,
                                 _F32(0.5)),
            formant_freq=np.minimum(scaled_ff, _F32(0.5)),
            formant_bw=np.asarray(self.formant_bw, _F32) * scale,
            formant_smooth=np.asarray(self.formant_smooth, _F32) * scale,
            formant_amp=np.where(scaled_ff > _F32(0.5), _F32(0.0),
                                 np.asarray(self.formant_amp, _F32)),
        )

    def copy_with_frequency(self, frequency) -> "SynthesisElem":
        """This frame at carrier `frequency`, clamped to Nyquist."""
        return self._replace(frequency=np.minimum(
            np.asarray(frequency, _F32), _F32(0.5)))

    def copy_silent(self) -> "SynthesisElem":
        """This frame with every formant amplitude 0."""
        return self._replace(formant_amp=np.zeros_like(
            np.asarray(self.formant_amp, _F32)))

    # ---- constructors ---------------------------------------------------

    @staticmethod
    def silent(shape=()) -> "SynthesisElem":
        """The reference's silent frame: 0.25 frequencies, zero breath,
        turbulence and amplitude."""
        shape = tuple(shape)
        f = np.full(shape, 0.25, _F32)
        q = np.full(shape + (NUM_FORMANTS,), 0.25, _F32)
        z = np.zeros(shape + (NUM_FORMANTS,), _F32)
        return SynthesisElem(f, q, q.copy(), q.copy(), z, z.copy(), z.copy())

    # ---- utilities -------------------------------------------------------

    def __getitem__(self, idx) -> "SynthesisElem":  # type: ignore[override]
        return SynthesisElem(*(f[idx] for f in self))

    @property
    def batch_shape(self):
        return tuple(self.formant_freq.shape[:-1])


def stack_elems(elems) -> SynthesisElem:
    """Stack a sequence of SynthesisElems along a new leading axis."""
    return SynthesisElem(*(np.stack([np.asarray(f) for f in fs])
                           for fs in zip(*elems)))


__all__ = ["SynthesisElem", "stack_elems"]
