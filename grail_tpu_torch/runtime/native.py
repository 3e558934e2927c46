"""The native host library: built at first use, bound with ctypes.

Counterpart of grail_tpu/runtime/native.py and of the ctypes half of
grail_tpu/oracle/native.py. The library is the repository's C++ host tier,
native/grail_native.cpp (transcriber, drift simulation, WAV encoder) and
native/grail_oracle.cpp (the oracle's DSP chain, the carrier phase track,
the jitter phase schedule). Where the JAX package looks for a library that
someone built with `make -C native` and carries on without it, this loader
builds it itself, from those sources, with the host compiler ($CXX, else
g++) and the Makefile's flags, into build/grail_tpu_torch/ under a name
that hashes both sources and the flags: an edit to either is rebuilt, a
stale library is never loaded, and nothing is written into native/. A
failed build raises with the compiler's output; no caller carries on
without the library.

-ffp-contract=off is what the bit-exact twins rest on: every float32
operation of the oracle chain and of the carrier recurrence rounds on its
own, as numpy's does.

Bound here: the carrier phase track, the oracle DSP chain (oracle/native.py
marshals their arguments) and the WAV encoder. The library's other symbols
(gn_transcribe, gn_drift_boundaries2, gn_jitter_phase_schedule) are not
bound: the port's host frontend runs its numpy versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from ..synth._build import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
SOURCES = ("grail_native.cpp", "grail_oracle.cpp")
# native/Makefile's flags (without its warnings)
CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-ffp-contract=off"]

_lock = threading.Lock()
_lib = None
build_info = {"seconds": None, "path": None}


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def _tag() -> str:
    """Hash of both sources (names and bytes) and the flags."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for name in SOURCES:
        h.update(name.encode() + b"\0" + (NATIVE_DIR / name).read_bytes()
                 + b"\0")
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
           *(str(NATIVE_DIR / name) for name in SOURCES)]
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
    return lib


def load_library() -> ctypes.CDLL:
    """The bound host library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


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


__all__ = ["NATIVE_DIR", "SOURCES", "CXXFLAGS", "build", "build_info",
           "load_library", "native_encode_wav"]
