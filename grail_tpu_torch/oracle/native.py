"""The native oracle twin and the carrier pre-pass (native/grail_oracle.cpp).

Counterpart of grail_tpu/oracle/native.py, on the port's own loader
(runtime/native.py), which builds the library at first use: nothing here
returns None for a missing library.

`gn_oracle_dsp_chain` is the reference DSP chain downstream of selection
(sequencer -> jitter -> synthesize, grail-rs src/lib.rs:813-953, :723-805,
:467-600) written independently in C++ with strict per-op f32 rounding. It
is bit-identical to the pure-NumPy oracle (tests/test_torch_oracle.py) and
orders of magnitude faster, which is what makes a long-form fidelity gold
affordable. Selection itself (voice table lookup + GLIDE merge) stays in
Python: it is O(elements), not O(samples).

`gn_carrier_phase_track` runs the same frequency chain without the filter
tail and returns the carrier's f32 phase per sample: the host pre-pass of
the solo long-form route (api._carrier_track_for), whose track the fused
kernel reads in its 'host_track' mode. Its plain version,
`carrier_phase_track_reference`, is the NumPy oracle's chain followed by the
recurrence; the tests and chip_smoke.py hold the two equal bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from ..runtime.native import load_library
from ..synth.score import merge_glides
from ..voices.voice import VoiceSpec
from .reference import (NpVoice, oracle_jitter, oracle_select,
                        oracle_sequence)


def _marshal_and_run(fn, pelems: Sequence, spec: VoiceSpec,
                     jitter_seed: int) -> np.ndarray:
    """Select + marshal a PhonemeElem sequence into the native chain ABI
    and run `fn` (gn_oracle_dsp_chain or gn_carrier_phase_track: the same
    argument layout) with output-capacity retry."""
    voice = NpVoice.from_spec(spec)
    seq = oracle_select(merge_glides(list(pelems)), voice)
    e = len(seq)

    present = np.zeros(e, np.int32)
    length = np.zeros(e, np.float32)
    blend = np.zeros(e, np.float32)
    freq = np.zeros(e, np.float32)
    fields = [np.zeros((e, 8), np.float32) for _ in range(6)]
    for i, s in enumerate(seq):
        length[i] = s.length
        blend[i] = s.blend_length
        if s.elem is not None:
            present[i] = 1
            freq[i] = s.elem.frequency
            for j, a in enumerate((s.elem.formant_freq, s.elem.formant_bw,
                                   s.elem.formant_smooth,
                                   s.elem.formant_breath,
                                   s.elem.formant_turb, s.elem.formant_amp)):
                fields[j][i] = a

    bad = np.flatnonzero(~np.isfinite(length))
    if len(bad):
        i = int(bad[0])
        raise ValueError(
            f"element {i} has non-finite length {length[i]!r}; the "
            "reference sequencer would never terminate on it")

    sr = float(voice.sample_rate)
    # the countdown emits ~sum(lengths)*sr samples; drift moves boundaries
    # by single samples, so a per-element +1 margin is generous
    cap = int(np.ceil(float(np.sum(length.astype(np.float64))) * sr)) + e + 64

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    for _ in range(3):  # cap-retry belt (drift can only add O(E) samples)
        out = np.empty(cap, np.float32)
        n = fn(present.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
               fp(length), fp(blend), fp(freq),
               fp(fields[0]), fp(fields[1]), fp(fields[2]),
               fp(fields[3]), fp(fields[4]), fp(fields[5]),
               e, ctypes.c_float(sr),
               ctypes.c_uint32(int(jitter_seed) & 0xFFFFFFFF),
               ctypes.c_float(float(voice.jitter_frequency)),
               ctypes.c_float(float(voice.jitter_delta_frequency)),
               ctypes.c_float(float(voice.jitter_delta_formant_frequency)),
               ctypes.c_float(float(voice.jitter_delta_amplitude)),
               fp(out), cap)
        if n >= 0:
            return out[:n].copy()
        if n <= -2:
            i = -(n + 2)
            raise ValueError(
                f"element {i} has non-finite length {length[i]!r}; the "
                "reference sequencer would never terminate on it")
        cap *= 2  # n == -1: capacity exceeded
    raise RuntimeError("native oracle output capacity retry exhausted")


def native_oracle_dsp_chain(pelems: Sequence, spec: VoiceSpec,
                            jitter_seed: int = 0) -> np.ndarray:
    """Native twin of oracle_dsp_chain: timed PhonemeElems -> f32 samples,
    the same signature and (bit for bit) the same output as
    reference.oracle_dsp_chain."""
    return _marshal_and_run(load_library().gn_oracle_dsp_chain, pelems, spec,
                            jitter_seed)


def native_carrier_phase_track(pelems: Sequence, spec: VoiceSpec,
                               jitter_seed: int = 0) -> np.ndarray:
    """The reference's exact f32 carrier phase per sample (PRE-update, the
    value polyBLEP and the saw consume; grail-rs src/lib.rs:520-525), from
    the native frequency-chain pre-pass (gn_carrier_phase_track). The fused
    kernel's 'host_track' mode reads it in place of the Q32 fixed-point
    accumulator, whose rounding-free sum drifts from the reference's f32
    recurrence as the utterance grows."""
    return _marshal_and_run(load_library().gn_carrier_phase_track, pelems,
                            spec, jitter_seed)


def carrier_phase_track_reference(pelems: Sequence, spec: VoiceSpec,
                                  jitter_seed: int = 0) -> np.ndarray:
    """Plain version of native_carrier_phase_track: the NumPy oracle's
    frequency chain (select -> sequence -> jitter), then the reference's f32
    carrier recurrence: emit the phase, then `phase += f`, and `phase -= 1`
    once it reaches 1. A Python loop over samples: for tests and short
    utterances."""
    voice = NpVoice.from_spec(spec)
    seq = oracle_select(merge_glides(list(pelems)), voice)
    stream = oracle_sequence(seq, float(voice.sample_rate))
    phase = np.float32(0.0)
    out = []
    for e in oracle_jitter(stream, jitter_seed, voice):
        out.append(phase)
        phase = np.float32(phase + np.float32(e.frequency))
        if phase >= 1.0:
            phase = np.float32(phase - np.float32(1.0))
    return np.array(out, np.float32)


def gold_dsp_chain(pelems: Sequence, spec: VoiceSpec,
                   jitter_seed: int = 0) -> np.ndarray:
    """Fidelity gold: the native twin of the NumPy oracle. The two are
    bit-identical (tests/test_torch_oracle.py), so a fidelity verdict is the
    same against either."""
    return native_oracle_dsp_chain(pelems, spec, jitter_seed=jitter_seed)


__all__ = ["native_oracle_dsp_chain", "native_carrier_phase_track",
           "carrier_phase_track_reference", "gold_dsp_chain"]
