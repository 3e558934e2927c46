"""Build the kernels under synth/csrc/ with nvcc and bind them with ctypes.

The kernels have a plain C interface (no PyTorch headers), so nvcc builds
each source in seconds. At first use every `*.cu` under csrc/ is compiled,
one nvcc per source, all started together, and linked into one library in
build/grail_tpu_torch/ beside the package (the repository's build/
directory). The library's name is a hash of every file under csrc/ (sources
and shared headers) and of the flags, so an edit to any of them is rebuilt
and a stale library is never loaded. The compiler's log (ptxas registers
and shared memory per kernel) is kept beside the library and read back when
the library is already built.

It also holds what every kernel wrapper shares: the launch counts
(`LAUNCHES`), the check of a launch's CUDA error (`raise_on`) and the
occupancy queries (`resident`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "grail_tpu_torch"

# sm_90a: Hopper. -fmad=false keeps every a*b+c as two rounded ops, and no
# --use_fast_math keeps divisions IEEE, so the kernels round as the plain
# PyTorch versions do. -Xptxas=-v reports registers and shared memory.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_lib = None
build_info = {"seconds": None, "log": "", "path": None}

# launches of the library's kernels, counted by each wrapper where it
# launches its kernel and nowhere else (fused_synth.cu's carry mode, the
# serving tick, and its host_track mode, the solo long-form route, have
# counts of their own, as have seq_scan.cu's two entry points); callers that
# must show a path went through the kernels set the counts to 0 before it
# and read them after
LAUNCHES = {"fused_synth": 0, "fused_synth_carry": 0, "fused_synth_track": 0,
            "phase_q32_pre": 0, "kcar_seam": 0, "synth_core": 0,
            "fma_peak": 0, "carrier_scan": 0, "jsched_scan": 0}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.grail_fused_synth.argtypes = ([p] * 18 + [i] * 8 + [ctypes.c_float]
                                      + [p])
    lib.grail_fused_synth.restype = i
    lib.grail_fused_synth_chunk.argtypes = []
    lib.grail_fused_synth_chunk.restype = i
    lib.grail_fused_synth_slots.argtypes = [i, ctypes.POINTER(i)]
    lib.grail_fused_synth_slots.restype = i
    lib.grail_fused_synth_geometry.argtypes = [ctypes.POINTER(i)] * 5
    lib.grail_fused_synth_geometry.restype = i
    lib.grail_phase_q32_pre.argtypes = [p] * 7 + [i] * 4 + [p]
    lib.grail_phase_q32_pre.restype = i
    lib.grail_phase_q32_pre_chunk.argtypes = []
    lib.grail_phase_q32_pre_chunk.restype = i
    lib.grail_phase_q32_pre_geometry.argtypes = ([i] * 4
                                                 + [ctypes.POINTER(i)] * 4)
    lib.grail_phase_q32_pre_geometry.restype = i
    lib.grail_kcar_seam.argtypes = [p] * 7 + [i] * 6 + [p]
    lib.grail_kcar_seam.restype = i
    lib.grail_synth_core.argtypes = [p] * 14 + [i] * 2 + [p]
    lib.grail_synth_core.restype = i
    lib.grail_synth_core_geometry.argtypes = [i] + [ctypes.POINTER(i)] * 6
    lib.grail_synth_core_geometry.restype = i
    lib.grail_fma_peak.argtypes = ([p] * 2 + [i] * 3 + [ctypes.c_float] * 2
                                   + [i, p])
    lib.grail_fma_peak.restype = i
    lib.grail_fma_peak_block.argtypes = []
    lib.grail_fma_peak_block.restype = i
    lib.grail_carrier_scan.argtypes = [p] * 4 + [i] * 2 + [p]
    lib.grail_carrier_scan.restype = i
    lib.grail_jsched_scan.argtypes = ([p] * 2 + [ctypes.c_float] + [p] * 4
                                      + [i] * 2 + [p])
    lib.grail_jsched_scan.restype = i
    lib.grail_seq_scan_threads.argtypes = []
    lib.grail_seq_scan_threads.restype = i
    lib.grail_cuda_error_string.argtypes = [i]
    lib.grail_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _tag() -> str:
    """Hash of every file under csrc/ (names and bytes) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(p for p in CSRC.iterdir() if p.is_file()):
        h.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernel library if it is not built yet; return its path.
    Raises RuntimeError with the compiler's output if nvcc fails."""
    out = BUILD_DIR / f"libgrail_kernels_{_tag()}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        build_info.update(seconds=0.0, log=log, path=str(out))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = BUILD_DIR / f"{out.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objs = [Path(f"{stem}.{src.stem}.o") for src in sources]
    tmp = Path(f"{stem}.tmp")
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen(      # one nvcc per source, all at once
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        logs = [proc.communicate()[0].strip() for proc in procs]
        failed = [f"nvcc failed ({proc.returncode}): {' '.join(proc.args)}"
                  f"\n{text}" for proc, text in zip(procs, logs)
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        log = "\n".join(logs + [(res.stdout + res.stderr).strip()]).strip()
        log_path.write_text(log)
        os.replace(tmp, out)
    finally:
        for f in objs + [tmp]:
            f.unlink(missing_ok=True)
    build_info.update(seconds=time.perf_counter() - t0, log=log,
                      path=str(out))
    return out


def raise_on(lib: ctypes.CDLL, rc: int, what: str):
    """Raise RuntimeError naming the CUDA error if `rc` is not 0."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({lib.grail_cuda_error_string(rc).decode()})")


_resident = {}


def resident(query: str, device) -> int:
    """What the library's occupancy query `query` (grail_*_slots) reports
    for CUDA `device`: how many blocks or lanes of its kernel the card holds
    at once. Queried on first use and memoized per query and device."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"{query} needs a CUDA device, got {dev}")
    key = (query, str(dev))
    if key not in _resident:
        lib = load_library()
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = getattr(lib, query)(torch.cuda.current_device(),
                                     ctypes.byref(out))
        raise_on(lib, rc, "occupancy query")
        if out.value < 1:
            raise RuntimeError(f"{query}: the kernel fits no block on this "
                               "card")
        _resident[key] = out.value
    return _resident[key]


def load_library() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _bind(ctypes.CDLL(str(build())))
            from .kernel_fused import CHUNK, CHUNK_PRE

            if lib.grail_fused_synth_chunk() != CHUNK:
                raise RuntimeError("fused_synth.cu CHUNK differs from "
                                   "kernel_fused.CHUNK")
            if lib.grail_phase_q32_pre_chunk() != CHUNK_PRE:
                raise RuntimeError("phase_q32_pre.cu PRE_CHUNK differs from "
                                   "kernel_fused.CHUNK_PRE")
            _lib = lib
        return _lib
