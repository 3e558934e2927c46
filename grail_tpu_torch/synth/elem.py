"""SynthesisElem: the synthesis parameter frame (grail-rs src/lib.rs:316-460).

One scalar carrier frequency plus six 8-wide formant fields, all
frequency-valued fields normalized to the sample rate. The leaves are numpy
arrays on the host (voice tables, scores) and become tensors with `.to`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SynthesisElem(NamedTuple):
    """Synthesis parameters. Leading dims are free (phoneme, element, batch)."""

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


__all__ = ["SynthesisElem"]
