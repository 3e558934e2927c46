"""Carry the JAX package's objects into the port.

Each function takes the JAX package's leaves as numpy arrays (np.asarray of
each leaf), so this module imports neither package, and returns the port's
object. Both packages then compute from the same inputs.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .synth.elem import SynthesisElem
from .synth.jitter import JitterLattice
from .synth.score import Score
from .synth.synthesize import SynthState
from .voices.voice import Voice

_VOICE_SCALARS = ("sample_rate", "center_frequency", "jitter_frequency",
                  "jitter_delta_frequency", "jitter_delta_formant_frequency",
                  "jitter_delta_amplitude", "name")


def voice_from_numpy(table_fields: Sequence[np.ndarray], defined: np.ndarray,
                     scalars: Mapping) -> Voice:
    """A compiled Voice from its seven table fields (SynthesisElem order),
    its `defined` mask, and a mapping with the scalar fields
    (sample_rate, center_frequency, jitter_frequency,
    jitter_delta_frequency, jitter_delta_formant_frequency,
    jitter_delta_amplitude, name)."""
    missing = [k for k in _VOICE_SCALARS if k not in scalars]
    if missing:
        raise KeyError(f"voice scalars missing: {missing}")
    return Voice(table=SynthesisElem(*(np.asarray(f, np.float32)
                                       for f in table_fields)),
                 defined=np.asarray(defined, bool),
                 **{k: scalars[k] for k in _VOICE_SCALARS})


def score_from_numpy(elem_fields: Sequence[np.ndarray], has_sound, length,
                     blend_length, cum_length) -> Score:
    """A Score from the seven elem fields (SynthesisElem order) and the
    four other Score fields, as they are (cum_length is not recomputed)."""
    return Score(elem=SynthesisElem(*(np.asarray(f, np.float32)
                                      for f in elem_fields)),
                 has_sound=np.asarray(has_sound, bool),
                 length=np.asarray(length, np.float32),
                 blend_length=np.asarray(blend_length, np.float32),
                 cum_length=np.asarray(cum_length, np.float32))


def lattice_from_numpy(pitch, formant, amp) -> JitterLattice:
    return JitterLattice(np.asarray(pitch, np.float32),
                         np.asarray(formant, np.float32),
                         np.asarray(amp, np.float32))


def state_from_numpy(phase, filter_state_a, filter_state_b, filter_state_c,
                     seed, device="cpu") -> SynthState:
    """A SynthState from its five fields (phase [B], the three filter
    states [B, 8], the uint32 Lehmer seed [B]); the seed is held as int64."""
    def f32(x):
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    return SynthState(phase=f32(phase), filter_state_a=f32(filter_state_a),
                      filter_state_b=f32(filter_state_b),
                      filter_state_c=f32(filter_state_c),
                      seed=torch.from_numpy(np.asarray(seed, np.uint32)
                                            .astype(np.int64)).to(device))


def schedule_from_numpy(phi, cell, device="cpu"):
    """(phi f32 [T], cell int32 [T]) tensors, flattening the JAX kernel's
    shared-lane [T, 1] layout."""
    return (torch.from_numpy(np.asarray(phi, np.float32).reshape(-1).copy())
            .to(device),
            torch.from_numpy(np.asarray(cell, np.int32).reshape(-1).copy())
            .to(device))


__all__ = ["voice_from_numpy", "score_from_numpy", "lattice_from_numpy",
           "state_from_numpy", "schedule_from_numpy"]
