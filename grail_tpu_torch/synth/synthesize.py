"""Carried DSP state of the synthesizer (grail-rs src/lib.rs:470-488).

The block core and the scans come with the streaming slice; this module
holds only the state that the fused kernel reads and returns.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.constants import NUM_FORMANTS


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


__all__ = ["SynthState"]
