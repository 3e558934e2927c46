"""The two sequential f32 recurrences of the xla core and the xla tick.

grail_tpu runs them as lax.scan loops (synth/synthesize.py::carrier_scan,
runtime/stream.py::_jsched_scan); each step rounds, so neither can be
reassociated into a parallel scan. Here each has a wrapper that runs:

  * on a CUDA tensor, the kernel synth/csrc/seq_scan.cu (one thread per
    lane, time-major rows, the state in registers), counted in LAUNCHES as
    'carrier_scan' or 'jsched_scan'; a failed launch raises, it never falls
    back;
  * on a CPU tensor, the plain versions kernel_fused.f32_carrier and
    kernel_fused.jitter_carry: runs of float32 adds in numpy, each cut at
    its first wrap, on the CPU; a float32 loop over samples, vectorized
    over lanes, on any other device.

Both wrappers keep the plain versions' layouts, so a caller sees one shape
whichever runs: `carrier_scan` is time-major (freq [T, B] -> track [T, B],
as grail_tpu's), `jsched_scan` lane-major (phi, cell [B, T], as
jitter_carry's; the kernel writes [T, B] rows and returns their transposed
views). `impl='plain'` asks for the plain version on any device (the
card's checks hold the kernel against it there); 'kernel' asks for the
kernel, which takes CUDA tensors only.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import LAUNCHES, raise_on


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on device {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def carrier_scan_reference(phase0: torch.Tensor, freq: torch.Tensor):
    """Plain version of carrier_scan: kernel_fused.f32_carrier over the
    time axis."""
    from .kernel_fused import f32_carrier

    track, pf = f32_carrier(freq.movedim(0, -1), phase0)
    return track.movedim(-1, 0), pf


def carrier_scan_cuda(phase0: torch.Tensor, freq: torch.Tensor):
    """Launch seq_scan.cu's carrier recurrence on the current stream:
    freq f32 [T, B] and phase0 f32 [B], CUDA tensors -> (track [T, B],
    final phase [B])."""
    import ctypes

    from ._build import load_library

    dev = freq.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    if freq.dim() != 2 or freq.shape[0] < 1 or freq.shape[1] < 1:
        raise ValueError(f"freq has shape {tuple(freq.shape)}, expected "
                         "(T >= 1, B >= 1)")
    T, B = freq.shape
    _check("freq", freq, torch.float32, (T, B), dev)
    _check("phase0", phase0, torch.float32, (B,), dev)
    lib = load_library()
    track = torch.empty_like(freq)
    p_out = torch.empty_like(phase0)
    p = ctypes.c_void_p
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.grail_carrier_scan(
            p(freq.data_ptr()), p(phase0.data_ptr()), p(track.data_ptr()),
            p(p_out.data_ptr()), T, B, p(stream))
        # a call under stream capture records the launch and launches
        # nothing: each replay is counted where it runs
        if not torch.cuda.is_current_stream_capturing():
            LAUNCHES["carrier_scan"] += 1
    raise_on(lib, rc, "carrier_scan kernel launch")
    return track, p_out


def _impl_for(t: torch.Tensor, impl) -> str:
    """'kernel' for a CUDA tensor, 'plain' for a CPU tensor, unless `impl`
    names one."""
    if impl is None:
        if t.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {t.device}")
        return "kernel" if t.device.type == "cuda" else "plain"
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    return impl


def carrier_scan(phase0: torch.Tensor, freq: torch.Tensor, impl=None):
    """The reference carrier recurrence, per lane (src/lib.rs:520-525):
    `pre = p; p = f32(p + f); if p >= 1: p -= 1`, emitting the pre-update
    phase (what the polyBLEP reads). freq f32 [T, B] time-major, phase0 f32
    [B]. Returns (track [T, B], final phase [B]), bit for bit grail_tpu's
    carrier_scan. The kernel for CUDA tensors, the plain loop for CPU
    tensors (or as `impl` says)."""
    phase0 = phase0.to(torch.float32).contiguous()
    freq = freq.contiguous()
    if _impl_for(freq, impl) == "kernel":
        return carrier_scan_cuda(phase0, freq)
    return carrier_scan_reference(phase0, freq)


def jsched_scan_cuda(jphi: torch.Tensor, jcell: torch.Tensor, inc, T: int):
    """Launch seq_scan.cu's jitter recurrence on the current stream:
    (jphi f32 [B], jcell int32 [B]) CUDA tensors -> (phi [B, T], cell
    [B, T], jphi [B], jcell [B]); phi and cell are transposed views of the
    kernel's time-major rows."""
    import ctypes

    from ._build import load_library

    dev = jphi.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    B = jphi.shape[0] if jphi.dim() == 1 else -1
    if B < 1 or T < 1:
        raise ValueError(f"need jphi [B >= 1] and T >= 1, got "
                         f"{tuple(jphi.shape)}, T={T}")
    _check("jphi", jphi, torch.float32, (B,), dev)
    _check("jcell", jcell, torch.int32, (B,), dev)
    lib = load_library()
    phi = torch.empty(T, B, dtype=torch.float32, device=dev)
    cell = torch.empty(T, B, dtype=torch.int32, device=dev)
    p_out = torch.empty_like(jphi)
    c_out = torch.empty_like(jcell)
    p = ctypes.c_void_p
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.grail_jsched_scan(
            p(jphi.data_ptr()), p(jcell.data_ptr()), float(np.float32(inc)),
            p(phi.data_ptr()), p(cell.data_ptr()), p(p_out.data_ptr()),
            p(c_out.data_ptr()), int(T), B, p(stream))
        if not torch.cuda.is_current_stream_capturing():
            LAUNCHES["jsched_scan"] += 1
    raise_on(lib, rc, "jsched_scan kernel launch")
    return phi.T, cell.T, p_out, c_out


def jsched_scan(jphi: torch.Tensor, jcell: torch.Tensor, inc, T: int,
                impl=None):
    """T steps of the reference jitter recurrence (src/lib.rs:236-249,
    287-300) from each lane's carried state, jphi f32 [B] and the absolute
    cell jcell int32 [B]: `p = f32(p + inc); if p > 1: p -= 1, cell += 1`.
    Returns the post-update (phi f32 [B, T], cell int32 [B, T]) and the
    final (jphi, jcell), bit for bit grail_tpu's _jsched_scan (lane-major
    here). The kernel for CUDA tensors, kernel_fused.jitter_carry for CPU
    tensors (or as `impl` says)."""
    jphi = jphi.to(torch.float32).contiguous()
    jcell = jcell.to(torch.int32).contiguous()
    if _impl_for(jphi, impl) == "kernel":
        return jsched_scan_cuda(jphi, jcell, inc, T)
    from .kernel_fused import jitter_carry

    return jitter_carry(jphi, jcell, inc, T)


__all__ = ["carrier_scan", "carrier_scan_reference", "carrier_scan_cuda",
           "jsched_scan", "jsched_scan_cuda"]
