"""The round-1 DSP core: coefficient prep + the sequential recurrence.

Counterpart of grail_tpu/synth/kernel.py (the `backend="pallas"` core).
Everything feed-forward in the chain (Q32 carrier phase, closed-form Lehmer
noise, polyBLEP saw, breath blend, filter coefficients: the only divisions
and polynomials) is vectorized PyTorch in `precompute_streams`, on whichever
device its inputs lie, as JAX computes it outside its Pallas kernel. It
yields seven [T, 8, B] f32 streams (alpha, d, q1, q2, m11, m21, m22). Only
the sequential part runs in the kernel:

    lp' = alpha * lp + d
    b'  = m11 * b - m21 * c + q1 * lp'
    c'  = m21 * b + m22 * c + q2 * lp'
    out = 0.25 * sum_f (b' + b)

Two implementations with one signature, (streams, lp, b, c) -> (audio
[T, B], lp, b, c) with the state [8, B]:

  * `synth_core_reference` — plain PyTorch, a Python loop over T in the
    kernel's exact operation order, the formants summed left to right. The
    CPU path and the tests use it; chip_smoke.py holds the kernel to it.
  * `synth_core_cuda` — the CUDA kernel synth/csrc/synth_core.cu.

`synth_core` (the counterpart of synth_core_pallas) runs the prep and the
one that `impl` names: 'kernel' takes CUDA tensors only and never falls
back; 'plain' runs anywhere. `CORE_MAX_LANES` is the lane capacity the
API's split decision uses for this backend on the card. The TPU kernel's
lane tiling (kernel_geometry, 128-lane padding) has no counterpart.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.approx import exp_approx
from ..core.constants import NUM_FORMANTS
from ._build import LAUNCHES, raise_on
from .elem import SynthesisElem
from .synthesize import (SynthState, _polyblep, _svf_coeffs, block_noise,
                         carrier_phase)

# Lanes the core program runs at once on the card: the `slots` of the API's
# split decision for this backend. The prep materializes its seven streams
# per 4096-sample block, 7 x 4096 x 8 x 4 B = 0.92 MB per lane, and its time
# grows with lanes x samples, pre-rolls included, and dominates the
# program: on an H100 the split program at 64 utterances was fastest at 512
# lanes (PERF.md), within the 1,056 lanes the kernel holds at once (4 lanes
# a block, 2 blocks per SM).
CORE_MAX_LANES = 512


def precompute_streams(elems: SynthesisElem, state: SynthState):
    """Feed-forward prep: time-major frames [T, B(, 8)] -> seven [T, 8, B]
    f32 streams (alpha, d, q1, q2, m11, m21, m22), contiguous, plus the
    advanced carrier phase and Lehmer seed ([B] each)."""
    T = elems.frequency.shape[0]
    f = elems.frequency
    phase, phase_out = carrier_phase(f, state.phase)
    pb = _polyblep(phase, f)
    saw = (2.0 * phase - 1.0 - pb)[..., None]

    noise, seed_out = block_noise(state.seed, T)
    noise = noise[..., None]

    breath, turb = elems.formant_breath, elems.formant_turb
    noise_wave = saw * (1.0 - breath) + noise * breath
    alpha = exp_approx(elems.formant_smooth)
    d = (1.0 - alpha) * noise_wave
    tamp = ((1.0 - turb) + noise * turb) * elems.formant_amp

    a1, a2, a3 = _svf_coeffs(elems)
    m11 = 2.0 * a1 - 1.0
    m21 = 2.0 * a2
    m22 = 1.0 - 2.0 * a3
    q1 = m21 * tamp
    q2 = (2.0 * a3) * tamp

    rows = (alpha, d, q1, q2, m11, m21, m22)
    streams = tuple(r.movedim(-1, 1).contiguous() for r in rows)
    return streams, phase_out, seed_out


def synth_core_reference(streams, lp: torch.Tensor, b: torch.Tensor,
                         c: torch.Tensor):
    """Plain PyTorch version of the kernel: streams [T, 8, B] x7, state
    [8, B] x3 -> (audio [T, B], lp, b, c)."""
    alpha, d, q1, q2, m11, m21, m22 = streams
    T = alpha.shape[0]
    ys = torch.empty_like(alpha)                           # b' + b [T, 8, B]
    for i in range(T):
        lp = alpha[i] * lp + d[i]
        nb = m11[i] * b - m21[i] * c + q1[i] * lp
        nc = m21[i] * b + m22[i] * c + q2[i] * lp
        ys[i] = nb + b
        b, c = nb, nc
    acc = ys[:, 0]
    for f in range(1, NUM_FORMANTS):                       # left to right,
        acc = acc + ys[:, f]                               # as the kernel
    return acc * 0.25, lp, b, c


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on device {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def synth_core_cuda(streams, lp: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor):
    """Launch synth/csrc/synth_core.cu on the current stream; same
    arguments and results as synth_core_reference."""
    import ctypes

    from ._build import load_library

    if len(streams) != 7:
        raise ValueError(f"need 7 streams, got {len(streams)}")
    dev = streams[0].device
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    T, F, B = streams[0].shape
    if T < 1 or B < 1 or F != NUM_FORMANTS:
        raise ValueError(f"streams of shape {(T, F, B)}: need T >= 1, "
                         f"B >= 1 and {NUM_FORMANTS} formants")
    for name, s in zip(("alpha", "d", "q1", "q2", "m11", "m21", "m22"),
                       streams):
        _check(name, s, (T, F, B), dev)
    for name, s in (("lp", lp), ("b", b), ("c", c)):
        _check(name, s, (F, B), dev)

    lib = load_library()
    audio = torch.empty(T, B, dtype=torch.float32, device=dev)
    outs = [torch.empty_like(lp) for _ in range(3)]
    p = ctypes.c_void_p
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.grail_synth_core(
            *(p(s.data_ptr()) for s in streams),
            p(lp.data_ptr()), p(b.data_ptr()), p(c.data_ptr()),
            p(audio.data_ptr()), *(p(o.data_ptr()) for o in outs),
            T, B, p(stream))
        LAUNCHES["synth_core"] += 1
    raise_on(lib, rc, "synth_core kernel launch")
    return (audio, *outs)


def synth_core_geometry(B: int, device) -> dict:
    """What synth_core_cuda launches on CUDA `device` for B lanes (streams
    16-byte aligned, as torch allocates them): blocks, threads per block,
    dynamic shared bytes, the compiled kernel's registers per thread,
    resident blocks per SM and whether the tensor memory accelerator feeds
    it (B % 4 == 0) or 4-byte cp.async copies do."""
    import ctypes

    from ._build import load_library

    lib = load_library()
    vals = [ctypes.c_int(0) for _ in range(6)]
    with torch.cuda.device(torch.device(device)):
        rc = lib.grail_synth_core_geometry(B, *map(ctypes.byref, vals))
    raise_on(lib, rc, "synth_core geometry query")
    geo = dict(zip(("blocks", "threads", "dynamic_smem", "registers",
                    "blocks_per_sm"), (v.value for v in vals)))
    geo["copies"] = "tma" if vals[5].value else "cp.async 4 B"
    return geo


IMPLEMENTATIONS = {"kernel": synth_core_cuda, "plain": synth_core_reference}


def synth_core(elems: SynthesisElem, state: SynthState,
               impl: str) -> Tuple[torch.Tensor, SynthState]:
    """Time-major frames [T, B(, 8)] and the carried state -> (audio
    [T, B], new SynthState): the prep, then the kernel ('kernel') or its
    plain version ('plain')."""
    if impl not in IMPLEMENTATIONS:
        raise ValueError(f"impl must be one of {sorted(IMPLEMENTATIONS)}, "
                         f"got {impl!r}")
    streams, phase_out, seed_out = precompute_streams(elems, state)
    lp, b, c = (x.T.contiguous() for x in (state.filter_state_a,
                                           state.filter_state_b,
                                           state.filter_state_c))
    audio, lp, b, c = IMPLEMENTATIONS[impl](streams, lp, b, c)
    return audio, SynthState(phase=phase_out, filter_state_a=lp.T,
                             filter_state_b=b.T, filter_state_c=c.T,
                             seed=seed_out)


__all__ = ["CORE_MAX_LANES", "precompute_streams", "synth_core_reference",
           "synth_core_cuda", "synth_core_geometry", "IMPLEMENTATIONS",
           "synth_core"]
