"""Build synth/csrc/fused_synth.cu with nvcc and bind it with ctypes.

The kernel has a plain C interface (no PyTorch headers), so one nvcc call
builds it in seconds. It is built at first use from the package's own
source into build/grail_tpu_torch/ beside the package (the repository's
build/ directory), keyed by a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_synth.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "grail_tpu_torch"

# sm_90a: Hopper. -fmad=false keeps every a*b+c as two rounded ops, and no
# --use_fast_math keeps divisions IEEE, so the kernel rounds as the plain
# PyTorch version does. -Xptxas=-v reports registers and shared memory.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]

_lock = threading.Lock()
_lib = None
build_info = {"seconds": None, "log": "", "path": None}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.grail_fused_synth.argtypes = [p] * 15 + [i, i, i, i, i, p]
    lib.grail_fused_synth.restype = i
    lib.grail_fused_synth_chunk.argtypes = []
    lib.grail_fused_synth_chunk.restype = i
    lib.grail_cuda_error_string.argtypes = [i]
    lib.grail_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build() -> Path:
    """Compile the kernel library if it is not built yet; return its path.
    Raises RuntimeError with the compiler's output if nvcc fails."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libfused_synth_{tag}.so"
    if out.exists():
        build_info.update(seconds=0.0, path=str(out))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = (res.stdout + res.stderr).strip()
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}"
                           f"\n{log}")
    os.replace(tmp, out)
    build_info.update(seconds=seconds, log=log, path=str(out))
    return out


def load_library() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _bind(ctypes.CDLL(str(build())))
            from .kernel_fused import CHUNK

            if lib.grail_fused_synth_chunk() != CHUNK:
                raise RuntimeError("fused_synth.cu CHUNK differs from "
                                   "kernel_fused.CHUNK")
            _lib = lib
        return _lib

