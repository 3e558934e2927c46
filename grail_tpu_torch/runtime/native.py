"""The native host library: built at first use, bound with ctypes.

Counterpart of grail_tpu/runtime/native.py and of the ctypes half of
grail_tpu/oracle/native.py. The library is the repository's C++ host tier,
native/grail_native.cpp (transcriber, the stepwise drift countdown, WAV
encoder) and native/grail_oracle.cpp (the oracle's DSP chain, the carrier
phase track, the jitter phase schedule), and the port's own
runtime/csrc/drift.cpp (the drift countdown in closed form) and
runtime/csrc/carrier_track.cpp (the carrier phase track from the frequency
chain alone). Where the JAX package looks for a library that someone built
with `make -C native` and carries on without it, this loader builds it
itself, from those sources, with the host compiler ($CXX, else g++) and the
Makefile's flags, into build/grail_tpu_torch/ under a name that hashes every
source and the flags: an edit to any is rebuilt, a stale library is never
loaded, and nothing is written into native/. A failed build raises with the compiler's output; no
binding returns None and no caller carries on without the library.

-ffp-contract=off is what the bit-exact twins rest on: every float32
operation of the oracle chain, the carrier track, the drift countdown and
the jitter phase rounds on its own, as numpy's does.

Bound here, with grail_tpu's names and signatures:
  * the host frontend's three loops: `native_transcribe` (`NativeRuleset`,
    gn_transcribe), behind text/transcribe.transcribe;
    `native_drift_boundaries` (gt_drift_boundaries, the closed form),
    behind synth/score._reference_boundary_samples; `native_jitter_schedule`
    (gn_jitter_phase_schedule), behind synth/schedule._simulate. Each is
    bit-equal to the Python or numpy version beside its caller, which
    stays as the tests' other side; so is
    `native_drift_boundaries_stepwise` (gn_drift_boundaries2, one float32
    subtract a sample), kept as the closed form's other side;
  * the solo long-form route's carrier pre-pass: `native_carrier_track`
    (gt_carrier_track), behind api._carrier_track_for, bit-equal to the
    oracle's carrier phase track, which stays as its other side;
  * the oracle's carrier phase track and DSP chain (oracle/native.py
    marshals their arguments) and the WAV encoder.
ctypes releases the GIL for the length of each foreign call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import List

import numpy as np

from ..synth._build import BUILD_DIR
from ..text.language import Language
from ..text.phonemes import Phoneme
from .trace import tally

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
CSRC_DIR = Path(__file__).resolve().parent / "csrc"
SOURCES = (NATIVE_DIR / "grail_native.cpp", NATIVE_DIR / "grail_oracle.cpp",
           CSRC_DIR / "drift.cpp", CSRC_DIR / "carrier_track.cpp")
# native/Makefile's flags (without its warnings)
CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-ffp-contract=off"]

_lock = threading.Lock()
_lib = None
build_info = {"seconds": None, "path": None}


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def _tag() -> str:
    """Hash of the sources (names and bytes) and the flags."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the host library into `build_dir` if it is not there yet;
    return its path. Raises RuntimeError with the compiler's output if the
    compiler cannot be run or fails."""
    out = Path(build_dir) / f"libgrail_native_{_tag()}.so"
    if out.exists():
        build_info.update(seconds=0.0, path=str(out))
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.stem}.{os.getpid()}.tmp"
    cmd = [_compiler(), *CXXFLAGS, "-shared", "-o", str(tmp),
           *(str(src) for src in SOURCES)]
    t0 = time.perf_counter()
    try:
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run the host compiler: "
                               f"{' '.join(cmd)}\n{e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"host library build failed "
                               f"({res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    build_info.update(seconds=time.perf_counter() - t0, path=str(out))
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    chain = [
        ctypes.POINTER(ctypes.c_int32),           # present [E]
        f32p, f32p, f32p,                         # length, blend, freq [E]
        f32p, f32p, f32p, f32p, f32p, f32p,       # 6 formant fields [E, 8]
        ctypes.c_int64,                           # E
        ctypes.c_float,                           # sample_rate
        ctypes.c_uint32,                          # jitter seed
        ctypes.c_float, ctypes.c_float,           # jf, jdf
        ctypes.c_float, ctypes.c_float,           # jdff, jda
        f32p, ctypes.c_int64,                     # out, out_cap
    ]
    for fn in (lib.gn_oracle_dsp_chain, lib.gn_carrier_phase_track):
        fn.restype = ctypes.c_int64
        fn.argtypes = chain
    lib.gn_encode_wav.restype = ctypes.c_int64
    lib.gn_encode_wav.argtypes = [f32p, ctypes.c_int64, ctypes.c_int32,
                                  ctypes.POINTER(ctypes.c_uint8)]
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.gn_ruleset_new.restype = ctypes.c_void_p
    lib.gn_ruleset_new.argtypes = [ctypes.POINTER(ctypes.c_char_p), i32p,
                                   i32p, ctypes.c_int32]
    lib.gn_ruleset_free.restype = None
    lib.gn_ruleset_free.argtypes = [ctypes.c_void_p]
    lib.gn_transcribe.restype = ctypes.c_int32
    lib.gn_transcribe.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int32, ctypes.c_int32, i32p,
                                  ctypes.c_int32]
    i64p = ctypes.POINTER(ctypes.c_int64)
    drift = [f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_float, i64p,
             f32p]
    lib.gn_drift_boundaries2.restype = ctypes.c_int64
    lib.gn_drift_boundaries2.argtypes = drift
    lib.gt_drift_boundaries.restype = ctypes.c_int64
    lib.gt_drift_boundaries.argtypes = drift + [i64p]
    lib.gn_jitter_phase_schedule.restype = ctypes.c_int64
    lib.gn_jitter_phase_schedule.argtypes = [
        ctypes.c_float, ctypes.c_float, ctypes.c_int64, f32p, i32p]
    lib.gt_carrier_track.restype = ctypes.c_int64
    lib.gt_carrier_track.argtypes = [
        i32p, f32p, f32p, f32p,                   # present, length, blend,
        ctypes.c_int64, ctypes.c_float,           # freq [E]; E, sample_rate
        ctypes.c_uint32,                          # jitter seed
        ctypes.c_float, ctypes.c_float,           # jf, jdf
        f32p, ctypes.c_int64]                     # out, out_cap
    return lib


def load_library() -> ctypes.CDLL:
    """The bound host library, built on first use (into BUILD_DIR)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build(BUILD_DIR))))
        return _lib


def available() -> bool:
    """Whether the host library builds and loads here. The one place that
    catches the build's error: it reports, and no caller falls back on its
    answer."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


class NativeRuleset:
    """Compiled native ruleset handle for a Language."""

    def __init__(self, language: Language):
        lib = load_library()
        self._lib = lib
        rules = language.rules
        strings = (ctypes.c_char_p * len(rules))(
            *[r.string.encode() for r in rules])
        flat: List[int] = []
        offsets = [0]
        for r in rules:
            flat.extend(int(p) for p in r.phonemes)
            offsets.append(len(flat))
        flat_arr = (ctypes.c_int32 * max(len(flat), 1))(*flat)
        off_arr = (ctypes.c_int32 * len(offsets))(*offsets)
        self._strings_keepalive = strings
        self._handle = lib.gn_ruleset_new(strings, flat_arr, off_arr,
                                          len(rules))
        if not self._handle:
            # the native layer rejects empty rule strings (they would spin
            # the automaton); Language validates this too, so reaching here
            # means a ruleset built around that validation
            raise ValueError("ruleset contains an empty rule string")
        self.case_sensitive = language.case_sensitive
        # worst-case phonemes emitted per consumed input byte: garbage
        # emits 1 (SILENCE); a matched rule emits len(phonemes) for
        # len(string) bytes. Sizes the output buffer exactly:
        # gn_transcribe stops writing at its capacity without a word.
        self._max_ratio = max(
            [1] + [-(-len(r.phonemes) // max(len(r.string), 1))
                   for r in rules])

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.gn_ruleset_free(self._handle)
            self._handle = None

    def transcribe(self, text: str) -> List[Phoneme]:
        """The automaton over text's UTF-8 bytes (gn_transcribe); an
        unmatched multi-byte character emits one SILENCE, as the Python
        automaton's does."""
        data = text.encode()
        cap = self._max_ratio * max(len(data), 1) + 16
        out = np.empty(cap, np.int32)
        n = self._lib.gn_transcribe(
            self._handle, data, len(data), 1 if self.case_sensitive else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        return [Phoneme(v) for v in out[:n].tolist()]


# content-keyed (an id() could be reused after a Language is collected);
# the lock covers serve mode's frontend thread and the caller, which both
# transcribe. gn_transcribe only reads its handle, so calls through one
# handle may overlap.
_ruleset_cache: dict = {}
_ruleset_lock = threading.Lock()


def _language_key(language: Language):
    return (language.case_sensitive,
            tuple((r.string, r.phonemes) for r in language.rules))


def native_transcribe(text: str, language: Language) -> List[Phoneme]:
    """Native transcription of a whole string (no leading SILENCE): the
    same phonemes as text/transcribe.transcribe_chars on ASCII text."""
    key = _language_key(language)
    with _ruleset_lock:
        rs = _ruleset_cache.get(key)
        if rs is None:
            if len(_ruleset_cache) > 64:  # bound the handles' lifetime
                _ruleset_cache.clear()
            rs = _ruleset_cache[key] = NativeRuleset(language)
    return rs.transcribe(text)


def native_encode_wav(data: np.ndarray, sample_rate: int) -> bytes:
    """16-bit mono PCM WAV bytes of `data` (gn_encode_wav; the same bytes
    as runtime/wav.encode_wav)."""
    lib = load_library()
    data = np.ascontiguousarray(data, np.float32)
    out = np.empty(44 + 2 * len(data), np.uint8)
    n = lib.gn_encode_wav(data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          len(data), int(sample_rate),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if n < 0:
        # RIFF sizes are uint32; the encoder refuses instead of writing a
        # wrapped header
        raise ValueError(
            f"{len(data)} samples exceed the WAV format's uint32 size "
            "limit (~2^31 samples); split the file")
    return out[:n].tobytes()


def _drift(fn, lengths, sample_rate, t0, *extra):
    lengths = np.ascontiguousarray(lengths, np.float32)
    e = len(lengths)
    counts = np.empty(e, np.int64)
    residuals = np.empty(e, np.float32)
    if e:
        stall = fn(
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), e,
            float(sample_rate), float(t0),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            residuals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            *extra)
        if stall >= 0:
            bad = float(lengths[stall])
            if np.isnan(bad):
                raise ValueError(
                    f"element length must be finite, got NaN "
                    f"(element {stall})")
            raise ValueError(
                f"element length {bad:.1f}s stalls the reference's f32 "
                "countdown (dt is below half an ulp); the reference "
                "sequencer would never advance past it — split the element")
    return counts, residuals


def native_drift_boundaries(lengths: np.ndarray, sample_rate: float,
                            t0: float = 0.0):
    """Reference-sequencer drift simulation in closed form
    (gt_drift_boundaries, runtime/csrc/drift.cpp: a float32 binade at a
    time, a few explicit steps an element): element end-samples of the
    per-sample f32 countdown, bit-equal to the stepwise loop
    (native_drift_boundaries_stepwise) and the numpy twin
    synth/score._reference_boundary_samples_np. Returns (counts_cum int64
    [E], residuals f32 [E]); raises ValueError on a NaN element and on one
    that stalls the countdown, as the twin does. Adds its explicit steps
    and the samples it counted to the innermost open span (trace.tally:
    `drift_steps`, `drift_samples`), if any."""
    steps = ctypes.c_int64(0)
    counts, residuals = _drift(load_library().gt_drift_boundaries, lengths,
                               sample_rate, t0, ctypes.byref(steps))
    tally(drift_steps=steps.value,
          drift_samples=int(counts[-1]) if len(counts) else 0)
    return counts, residuals


def native_drift_boundaries_stepwise(lengths: np.ndarray,
                                     sample_rate: float, t0: float = 0.0):
    """native_drift_boundaries through gn_drift_boundaries2
    (native/grail_native.cpp): one dependent float32 subtract per audio
    sample. The closed form's other side in the tests."""
    return _drift(load_library().gn_drift_boundaries2, lengths, sample_rate,
                  t0)


def native_jitter_schedule(inc, phase0, T: int, phi: np.ndarray,
                           cell: np.ndarray) -> int:
    """Reference value-noise phase recurrence (gn_jitter_phase_schedule):
    T steps of `phase = f32(phase + inc); if phase > 1: phase -= 1` from
    `phase0` into phi f32 [T] / cell i32 [T] (cell = wraps since this call,
    including a wrap at that sample). Returns the total wrap count;
    bit-equal to synth/schedule._np_simulate."""
    lib = load_library()
    assert phi.dtype == np.float32 and cell.dtype == np.int32
    assert phi.flags.c_contiguous and cell.flags.c_contiguous
    assert len(phi) >= T and len(cell) >= T
    return int(lib.gn_jitter_phase_schedule(
        float(np.float32(inc)), float(np.float32(phase0)), int(T),
        phi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cell.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))))


def _carrier_track_inputs(pelems, spec):
    """Selection for gt_carrier_track, which reads only the frequency:
    (present i32, length, blend, frequency f32 [E] of the glide-merged
    elements; sample rate, jitter rate, jitter depth as f32). An element is
    present iff the voice defines its phoneme; its frequency is the oracle
    selector's `min(frequency, 0.5)`. Raises ValueError on a non-finite
    length, as the oracle's marshalling does."""
    from ..synth.score import merge_glides
    from ..text.phonemes import is_sound

    defined = {int(Phoneme[name]) for name in spec.phonemes}
    merged = merge_glides(list(pelems))
    present = np.array([is_sound(pe.phoneme) and int(pe.phoneme) in defined
                        for pe in merged], np.int32)
    length = np.array([pe.length for pe in merged], np.float32)
    blend = np.array([pe.blend_length for pe in merged], np.float32)
    freq = np.minimum(np.array([pe.frequency for pe in merged], np.float32),
                      np.float32(0.5))
    bad = np.flatnonzero(~np.isfinite(length))
    if len(bad):
        i = int(bad[0])
        raise ValueError(
            f"element {i} has non-finite length {length[i]!r}; the "
            "reference sequencer would never terminate on it")
    sr = np.float32(spec.sample_rate)
    return (present, length, blend, freq, sr,
            np.float32(spec.jitter_frequency_hz) / sr,
            np.float32(spec.jitter_delta_frequency_hz) / sr)


def _carrier_track_chain(inputs, jitter_seed: int) -> np.ndarray:
    """gt_carrier_track on `_carrier_track_inputs`' arrays: the track, a
    view of the buffer it wrote."""
    present, length, blend, freq, sr, jf, jdf = inputs
    lib = load_library()
    fp = ctypes.POINTER(ctypes.c_float)
    # the countdown emits ~sum(lengths) * sr samples; drift moves boundaries
    # by single samples, so a per-element +1 margin is generous
    cap = int(np.ceil(float(np.sum(length.astype(np.float64)))
                      * float(sr))) + len(length) + 64
    for _ in range(3):
        out = np.empty(cap, np.float32)
        n = lib.gt_carrier_track(
            present.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            length.ctypes.data_as(fp), blend.ctypes.data_as(fp),
            freq.ctypes.data_as(fp), len(length), float(sr),
            int(jitter_seed) & 0xFFFFFFFF, float(jf), float(jdf),
            out.ctypes.data_as(fp), cap)
        if n >= 0:
            return out[:n]
        cap *= 2  # n == -1: capacity exceeded (lengths are finite)
    raise RuntimeError("carrier track output capacity retry exhausted")


def native_carrier_track(pelems, spec, jitter_seed: int = 0) -> np.ndarray:
    """The reference's exact f32 carrier phase per sample (PRE-update, the
    value polyBLEP and the saw consume; grail-rs src/lib.rs:520-525) for a
    PhonemeElem sequence in the VoiceSpec `spec`'s voice: the host pre-pass
    of the solo long-form route (api._carrier_track_for).

    gt_carrier_track (runtime/csrc/carrier_track.cpp) runs only the
    frequency chain (the sequencer, the crossfade of `frequency`, the
    frequency jitter) and the carrier recurrence: the same samples, bit for
    bit, as oracle/native.native_carrier_phase_track, which runs the whole
    oracle chain without its filter. Selection marshals only what the
    frequency reads (`_carrier_track_inputs`). Returns a view of the buffer
    it wrote; raises ValueError on a non-finite length, as the oracle's
    marshalling does. Adds the samples it produced to the innermost open
    span (trace.tally: `track_chain_samples`), if any."""
    track = _carrier_track_chain(_carrier_track_inputs(pelems, spec),
                                 jitter_seed)
    tally(track_chain_samples=len(track))
    return track


__all__ = ["NATIVE_DIR", "SOURCES", "CXXFLAGS", "build", "build_info",
           "load_library", "available", "NativeRuleset",
           "native_transcribe", "native_encode_wav",
           "native_drift_boundaries", "native_drift_boundaries_stepwise",
           "native_jitter_schedule", "native_carrier_track"]
