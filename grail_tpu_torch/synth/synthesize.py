"""Carried DSP state and the feed-forward parts of the DSP core (grail-rs
src/lib.rs:467-600), counterpart of grail_tpu/synth/synthesize.py.

Per sample the reference runs a polyBLEP anti-aliased saw carrier, a white-
noise breath blend, a one-pole lowpass, turbulence and amplitude, and a bank
of 8 SVF resonators. This module holds what is closed-form or elementwise
in that chain, which the round-1 core's coefficient prep
(synth/kernel.precompute_streams) builds on:

  * `carrier_phase` — the Q32 fixed-point carrier (exclusive prefix sum of
    trunc(f * 2^32), mod 2^32), on top of `q32_carrier`, which the fused
    synthesizer's plain version uses too;
  * `block_noise` — closed-form Lehmer noise (core/rng.lehmer_block_states);
  * `_polyblep` and `_svf_coeffs` — the saw correction and the SVF
    coefficients a1, a2, a3 (with the division form of tan_approx).

Time-major layouts ([T, B, ...]) follow the JAX functions. The block core,
its associative scans and `carrier_scan` come with the streaming slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.approx import tan_approx
from ..core.constants import NUM_FORMANTS
from ..core.rng import MASK32, lehmer_block_states, random_f32_from_state

_Q32 = 4294967296.0          # 2^32
_INV_Q32 = 1.0 / 4294967296.0


class SynthState(NamedTuple):
    """Per-utterance carried state. `seed` holds the uint32 Lehmer state as
    int64 in [0, 2^32)."""

    phase: torch.Tensor           # [B] f32 carrier phase
    filter_state_a: torch.Tensor  # [B, 8] one-pole lowpass
    filter_state_b: torch.Tensor  # [B, 8] SVF ic1eq
    filter_state_c: torch.Tensor  # [B, 8] SVF ic2eq
    seed: torch.Tensor            # [B] int64 noise state

    @staticmethod
    def init(batch: int, device) -> "SynthState":
        """Reference IntoSynthesize::synthesize init (src/lib.rs:587-596)."""
        z8 = torch.zeros(batch, NUM_FORMANTS, dtype=torch.float32,
                         device=device)
        return SynthState(
            phase=torch.zeros(batch, dtype=torch.float32, device=device),
            filter_state_a=z8, filter_state_b=z8.clone(),
            filter_state_c=z8.clone(),
            seed=torch.zeros(batch, dtype=torch.int64, device=device))


def _polyblep(phase, f):
    """Anti-aliasing offset for the saw discontinuity (src/lib.rs:503-514)."""
    t0 = phase / f
    first = 2.0 * t0 - t0 * t0 - 1.0
    t1 = (phase - 1.0) / f
    last = t1 * t1 + 2.0 * t1 + 1.0
    return torch.where(phase < f, first,
                       torch.where(phase > 1.0 - f, last,
                                   torch.zeros_like(phase)))


def _svf_coeffs(elem):
    """SVF coefficients (a1, a2, a3) of the cytomic trapezoidal resonator
    from the formant frequency and bandwidth fields."""
    g = tan_approx(elem.formant_freq)
    k = elem.formant_bw / elem.formant_freq
    a1 = 1.0 / (1.0 + g * (g + k))
    a2 = g * a1
    a3 = g * a2
    return a1, a2, a3


def q32_carrier(freq: torch.Tensor, p0: torch.Tensor):
    """Q32 fixed-point carrier phase over the last axis: the exclusive
    prefix sum of trunc(f * 2^32) from the uint32 phase `p0` (int64 [...]),
    mod 2^32, as f32 in [0, 1). Returns (phase f32 [..., T], final uint32
    phase int64 [...]). torch has no uint32 cumsum, so the sum runs in int64
    and is masked to 32 bits; the u32 -> f32 conversion rounds to nearest
    even, as numpy's does."""
    fq = (freq * _Q32).to(torch.int64)         # exact scale, then truncate
    csum = torch.cumsum(fq, dim=-1)
    q = (p0[..., None] + csum - fq) & MASK32
    return q.to(torch.float32) * _INV_Q32, (p0 + csum[..., -1]) & MASK32


def carrier_phase(frequency: torch.Tensor, phase0: torch.Tensor):
    """Closed-form polyBLEP phase track over axis 0 (time): frequency
    [T, ...], phase0 f32 [...]. Returns (phase [T, ...], phase_out [...]),
    both f32. The accumulator is Q32 fixed point, so uint32 wraparound is
    the mod 1, exactly; the returned phase_out is rounded to f32, as
    grail_tpu's carrier_phase returns it (chained blocks round there)."""
    p0q = (torch.remainder(phase0, 1.0) * _Q32).to(torch.int64)
    phase, qf = q32_carrier(frequency.movedim(0, -1), p0q)
    return phase.movedim(-1, 0), qf.to(torch.float32) * _INV_Q32


def block_noise(seed0: torch.Tensor, T: int):
    """Lehmer noise [T, ...] continuing from the int64-held uint32 state
    `seed0` [...]; returns (noise f32 [T, ...], last state [...])."""
    states = lehmer_block_states(seed0, T)                    # [..., T]
    return (random_f32_from_state(states).movedim(-1, 0),
            states[..., -1])


__all__ = ["SynthState", "q32_carrier", "carrier_phase", "block_noise"]
