"""The oracle: the sequential NumPy port of the reference (reference.py) and
its native twin with the carrier pre-pass (native.py)."""

from .native import (
    carrier_phase_track_reference, gold_dsp_chain,
    native_carrier_phase_track, native_oracle_available,
    native_oracle_dsp_chain,
)
from .reference import (
    NpElem, NpSequenceElem, NpVoice,
    oracle_dsp_chain, oracle_intonate, oracle_jitter, oracle_pipeline,
    oracle_select, oracle_sequence, oracle_synthesize,
)

__all__ = [
    "NpElem", "NpSequenceElem", "NpVoice",
    "carrier_phase_track_reference", "gold_dsp_chain",
    "native_carrier_phase_track", "native_oracle_available",
    "native_oracle_dsp_chain",
    "oracle_dsp_chain", "oracle_intonate", "oracle_jitter",
    "oracle_pipeline", "oracle_select", "oracle_sequence",
    "oracle_synthesize",
]
