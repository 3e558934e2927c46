"""Jitter: the value-noise lattices (grail-rs src/lib.rs:213-307, 723-805).

Three value-noise generators (pitch scalar, formant-frequency and amplitude
8-wide) share one phase schedule (synth/schedule.py). Every lattice point is
a Lehmer draw at a known offset, so a whole utterance's lattices are built on
the host up front (`build_lattice`, a copy of grail_tpu's numpy half); the
fused kernel reads rows `cell` and `cell + 1` and lerps by `phi`.

`sched_slice`, `jitter_values` and `apply_jitter` are the tensor half, for
the round-1 core's prep: batched lattices [B, W(, 8)] of tensors, a schedule
shared by every lane ([T]) or one row per lane ([B, T]), and jitter deltas
that are one value or one per lane ([B]). Where grail_tpu selects lattice
rows with one-hot products over a window of MAX_JITTER_INC-bounded size
(the window exists only to bound the one-hot matrix), these gather rows
`cell` and `cell + 1` directly, clamped at W - 2 as JAX clamps: the same
rows, so the same bits.

Lattice layout (draw d_i = i-th Lehmer draw from the jitter seed):
  pitch    L[0]=d1, L[1]=d2,            L[i>=2]   = d_{i+1}
  formant  L[0][j]=d_{3+2j}, L[1][j]=d_{4+2j}, L[m>=2][j] = d_{19+8(m-2)+j}
  amp      L[0][j]=d_{19+2j}, L[1][j]=d_{20+2j}, L[m>=2][j] = d_{35+8(m-2)+j}
(the interleaved heads mirror ValueNoise::new / ArrayValueNoise::new).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.constants import NUM_FORMANTS
from ..core.rng import np_lehmer_draws
from .sequencer import take

# upper bound on the normalized jitter rate (88 Hz at 44.1 kHz); voices are
# validated against it at compile time
MAX_JITTER_INC = 0.002


class JitterLattice(NamedTuple):
    """Precomputed value-noise lattices for one (seed, max_samples)."""

    pitch: np.ndarray     # [W+2]
    formant: np.ndarray   # [W+2, 8]
    amp: np.ndarray       # [W+2, 8]


def build_lattice(seed: int, num_samples: int, jitter_frequency: float) -> JitterLattice:
    """Host-side lattice construction (cheap: ~16 Hz worth of points)."""
    W = int(np.floor(num_samples * float(jitter_frequency))) + 2
    n_draws = 34 + 8 * (W + 2)  # covers amp-lattice row W+1 (d_{35+8(W-1)..})
    d = np_lehmer_draws(seed, n_draws)  # d[i] == draw d_{i+1}

    def dr(i):  # 1-based draw index like the docstring
        return d[i - 1]

    pitch = np.empty(W + 2, np.float32)
    pitch[0], pitch[1] = dr(1), dr(2)
    pitch[2:] = d[2:W + 2]                     # rows m>=2: d_{m+1}
    formant = np.empty((W + 2, NUM_FORMANTS), np.float32)
    amp = np.empty((W + 2, NUM_FORMANTS), np.float32)
    formant[0] = d[2:18:2]                     # d_{3+2j}
    formant[1] = d[3:19:2]                     # d_{4+2j}
    amp[0] = d[18:34:2]                        # d_{19+2j}
    amp[1] = d[19:35:2]                        # d_{20+2j}
    formant[2:] = d[18:18 + 8 * W].reshape(W, NUM_FORMANTS)   # d_{19+8(m-2)+j}
    amp[2:] = d[34:34 + 8 * W].reshape(W, NUM_FORMANTS)       # d_{35+8(m-2)+j}

    return JitterLattice(pitch, formant, amp)


def lattice_to(lattice: JitterLattice, device) -> JitterLattice:
    """Batched numpy lattices -> float32 tensors on `device`."""
    return JitterLattice(*(torch.as_tensor(np.asarray(x, np.float32),
                                           device=device) for x in lattice))


def sched_slice(sched, start, length: int):
    """(phi, cell) of a schedule [N] at samples start .. start + length - 1:
    [length] views for one int `start`, or [B, length] rows for one start
    per lane (an int tensor [B], which the caller keeps inside [0, N -
    length]: checking it here would wait for the device). An int window
    outside the schedule raises (JAX's dynamic_slice would clamp it; no
    caller needs that)."""
    phi, cell = sched
    if isinstance(start, int):
        N = phi.shape[0]
        if start < 0 or start + length > N:
            raise ValueError(f"schedule window [{start}, {start + length}) "
                             f"outside [0, {N})")
        return phi[start:start + length], cell[start:start + length]
    idx = start.to(torch.int64)[:, None] + torch.arange(length,
                                                         device=phi.device)
    return phi[idx], cell[idx]


def jitter_values(lattice: JitterLattice, phi, cell):
    """Per-sample noise values (pitch [B, T], formant [B, T, 8], amp
    [B, T, 8]) from lattices [B, W(, 8)] and the exact schedule (phi f32,
    cell int, each [T] for every lane or [B, T]): rows cell and cell + 1,
    cell clamped to [0, W - 2], lerped by phi."""
    pitch, i, ph = _pitch(lattice, phi, cell)
    ph3 = ph[..., None]

    def lerp(win):
        return take(win, i) * (1.0 - ph3) + take(win, i + 1) * ph3

    return pitch, lerp(lattice.formant), lerp(lattice.amp)


def _pitch(lattice: JitterLattice, phi, cell):
    """(pitch noise [B, T], clamped cells int64 [B, T], phi [B, T]): the
    pitch part of jitter_values, which the split's pre-pass needs alone."""
    B, nlat = lattice.pitch.shape
    T = phi.shape[-1]
    i = cell.to(torch.int64).clamp(0, nlat - 2).expand(B, T)
    ph = phi.expand(B, T)
    pitch = (lattice.pitch.gather(1, i) * (1.0 - ph)
             + lattice.pitch.gather(1, i + 1) * ph)
    return pitch, i, ph


def pitch_values(lattice: JitterLattice, phi, cell) -> torch.Tensor:
    """The pitch noise [B, T] of jitter_values alone."""
    return _pitch(lattice, phi, cell)[0]


def per_lane(x, B: int, dims: int):
    """A jitter delta: one float32 value, or a [B] tensor shaped to
    broadcast over `dims` trailing dimensions."""
    if isinstance(x, torch.Tensor):
        if x.shape != (B,):
            raise ValueError(f"per-lane delta of shape {tuple(x.shape)}, "
                             f"expected ({B},)")
        return x.to(torch.float32).reshape((B,) + (1,) * dims)
    return float(np.float32(x))


def apply_jitter(elems, lattice: JitterLattice, delta_frequency,
                 delta_formant_freq, delta_amplitude, sched, mask=None):
    """The reference jitter update (src/lib.rs:753-777) of per-sample
    frames [B, T(, 8)], `sched` = (phi, cell) of the block's samples.
    `mask` (bool [B, T], optional) disables jitter on invalid samples, as
    the overlap-save split needs: its pre-roll carrier must stay at the
    silent frame's exact 0.25. Deltas are one value or one per lane."""
    B = elems.frequency.shape[0]
    pitch, formant, amp_n = jitter_values(lattice, *sched)
    if mask is not None:
        m = mask.to(torch.float32)
        m3 = m[..., None]
        pitch = pitch * m
        formant = formant * m3
        amp_n = amp_n * m3 - (1.0 - m3)   # masked -> n = -1 -> delta 0
    df = per_lane(delta_frequency, B, 1)
    dff = per_lane(delta_formant_freq, B, 2)
    da = per_lane(delta_amplitude, B, 2)
    frequency = elems.frequency + pitch * df
    formant_freq = elems.formant_freq + formant * dff
    # attenuate-only amplitude: amp *= 1 - (n+1)/2 * delta
    amp_delta = (amp_n + 1.0) * (0.5 * da)
    formant_amp = elems.formant_amp * (1.0 - amp_delta)
    return elems._replace(frequency=frequency, formant_freq=formant_freq,
                          formant_amp=formant_amp)


__all__ = ["MAX_JITTER_INC", "JitterLattice", "build_lattice", "lattice_to",
           "sched_slice", "jitter_values", "pitch_values", "per_lane",
           "apply_jitter"]
