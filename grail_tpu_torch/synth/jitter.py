"""Jitter: the value-noise lattices (grail-rs src/lib.rs:213-307, 723-805).

Three value-noise generators (pitch scalar, formant-frequency and amplitude
8-wide) share one phase schedule (synth/schedule.py). Every lattice point is
a Lehmer draw at a known offset, so a whole utterance's lattices are built on
the host up front; the kernel reads rows `cell` and `cell + 1` and lerps by
`phi`. A copy of grail_tpu/synth/jitter.py's numpy half.

Lattice layout (draw d_i = i-th Lehmer draw from the jitter seed):
  pitch    L[0]=d1, L[1]=d2,            L[i>=2]   = d_{i+1}
  formant  L[0][j]=d_{3+2j}, L[1][j]=d_{4+2j}, L[m>=2][j] = d_{19+8(m-2)+j}
  amp      L[0][j]=d_{19+2j}, L[1][j]=d_{20+2j}, L[m>=2][j] = d_{35+8(m-2)+j}
(the interleaved heads mirror ValueNoise::new / ArrayValueNoise::new).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..core.constants import NUM_FORMANTS
from ..core.rng import np_lehmer_draws

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


__all__ = ["MAX_JITTER_INC", "JitterLattice", "build_lattice"]
