"""The fused synthesizer: Score tables -> audio in one pass per utterance.

Counterpart of grail_tpu/synth/kernel_fused.py. Per sample it runs the whole
reference chain (grail-rs src/lib.rs:813-953 sequencer, :723-805 jitter,
:497-578 synthesis):

  A. element index by boundary count over the int32 end samples `n`, then
     the cur/next element rows, blend alpha and the 4-case pick;
  B. value-noise jitter from the shared exact (phi, cell) schedule;
  C. carrier phase (Q32 fixed point, or the reference's exact f32
     recurrence), polyBLEP saw, closed-form Lehmer noise, and the seven
     one-pole + SVF coefficient streams (one division per formant);
  D. the sequential one-pole lowpass + 8-formant SVF recurrence; the output
     is 0.25 * sum_f (b'_f + b_f), zeroed past the utterance's end.

Two implementations with one signature, (tables, phi, cell, sf, si, T, kcar)
-> (audio [B, T], sf [B, 24], si [B, 3]):

  * `synth_fused_reference` — plain PyTorch: A-C vectorized over [B, T],
    the Q32 carrier as an int64 cumsum, the f32 carrier and D as Python
    loops over samples. Runs on any device; the CPU path and the tests use
    it, and chip_smoke.py holds the kernel against it on the card.
  * `fused_synth_cuda` — the CUDA kernel synth/csrc/fused_synth.cu, one
    thread block per utterance.

`synth_fused` runs the one that api.route chose: the kernel for a CUDA
device, the plain version for the CPU.

Carried state: sf rows are lp[8], b[8], c[8]; si holds uint32 bit patterns
as int32: 0 the Q32 carrier phase, 1 the Lehmer seed, 2 the f32 carrier
phase (exact mode). Audio is utterance-major [B, T] (the JAX kernel's is
[T, B]).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.approx import exp_approx, tan_approx_parts
from ..core.constants import NUM_FORMANTS
from ..core.rng import (MASK32, lehmer_block_states, lehmer_chunk_tables,
                        random_f32_from_state)
from .synthesize import SynthState

CHUNK = 128                  # samples per kernel chunk (= threads per block)
_MIN_LAT_ROWS = 16           # lattices padded to at least this many rows
_Q32 = 4294967296.0          # 2^32
_INV_Q32 = 1.0 / 4294967296.0

# kernel launches, counted by fused_synth_cuda where it launches and nowhere
# else; reset by callers that need to show the main path went through it
LAUNCHES = {"fused_synth": 0}


class FusedTables(NamedTuple):
    """Kernel-layout inputs, utterance-major (one block reads one row)."""

    n: torch.Tensor      # [B, E] int32 element end samples (non-decreasing)
    scal: torch.Tensor   # [B, E, 4] f32: frequency, cum_length,
                         #   blend_length, has_sound (0/1)
    vec: torch.Tensor    # [B, E, 6, 8] f32: formant freq, bw, smooth,
                         #   breath, turb, amp
    latp: torch.Tensor   # [B, W] f32 pitch value-noise lattice
    latf: torch.Tensor   # [B, W, 8] formant-frequency lattice
    lata: torch.Tensor   # [B, W, 8] amplitude lattice
    par: torch.Tensor    # [B, 4] f32: jdf, jdff, jda, dt


def build_tables(score, lattice, jparams, sample_rate,
                 device="cpu") -> FusedTables:
    """Batched numpy Score [B, E] + JitterLattice [B, W(, 8)] -> tables on
    `device`, built on the host and uploaded once.

    `jparams` = (jitter rate, jdf, jdff, jda); each delta is a scalar or one
    per utterance (multi-voice batches). The rate itself is not read here:
    the schedule (phi, cell) carries it."""
    _, jdf, jdff, jda = jparams
    sr = np.float32(sample_rate)
    C = np.asarray(score.cum_length, np.float32)             # [B, E]
    B, E = C.shape
    n = np.floor(C * sr).astype(np.int32)
    if np.any(np.diff(n, axis=-1) < 0):
        raise ValueError("element end samples must be non-decreasing "
                         "(a negative element length?)")
    el = score.elem
    scal = np.stack([np.asarray(el.frequency, np.float32), C,
                     np.asarray(score.blend_length, np.float32),
                     np.asarray(score.has_sound).astype(np.float32)],
                    axis=-1)                                   # [B, E, 4]
    vec = np.stack([np.asarray(f, np.float32) for f in (
        el.formant_freq, el.formant_bw, el.formant_smooth,
        el.formant_breath, el.formant_turb, el.formant_amp)],
        axis=-2)                                               # [B, E, 6, 8]

    def edge_pad(x):  # [B, W, ...] -> [B, max(W, 16), ...] repeating row W-1
        x = np.asarray(x, np.float32)
        k = _MIN_LAT_ROWS - x.shape[1]
        if k > 0:
            x = np.concatenate([x, np.repeat(x[:, -1:], k, axis=1)], axis=1)
        return x

    def row(x):
        return np.broadcast_to(np.asarray(x, np.float32), (B,))

    dt = np.float32(1.0) / sr
    par = np.stack([row(jdf), row(jdff), row(jda), row(dt)], axis=-1)

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return FusedTables(n=up(n), scal=up(scal), vec=up(vec),
                       latp=up(edge_pad(lattice.pitch)),
                       latf=up(edge_pad(lattice.formant)),
                       lata=up(edge_pad(lattice.amp)), par=up(par))


def _u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 value -> int32 with the same bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _i32_to_u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & MASK32


def q32_carrier(freq: torch.Tensor, p0: torch.Tensor):
    """Q32 fixed-point carrier phase over the last axis: the exclusive
    prefix sum of trunc(f * 2^32) from the uint32 phase `p0` (int64 [...]),
    mod 2^32, as f32 in [0, 1). Returns (phase f32 [..., T], final uint32
    phase int64 [...]). Same bits as grail_tpu's carrier_phase."""
    fq = (freq * _Q32).to(torch.int64)         # exact scale, then truncate
    csum = torch.cumsum(fq, dim=-1)
    q = (p0[..., None] + csum - fq) & MASK32
    return q.to(torch.float32) * _INV_Q32, (p0 + csum[..., -1]) & MASK32


def f32_carrier(freq: torch.Tensor, p0: torch.Tensor):
    """The reference carrier recurrence over the last axis (src/lib.rs:
    520-525): per sample `phase += f` (f32), `if phase >= 1: phase -= 1`.
    The saw reads the PRE-update phase. Returns (track [..., T], final
    phase [...])."""
    T = freq.shape[-1]
    track = torch.empty_like(freq)
    p = p0.clone()
    for i in range(T):
        track[..., i] = p
        p = p + freq[..., i]
        p = torch.where(p >= 1.0, p - 1.0, p)
    return track, p


def synth_fused_reference(tables: FusedTables, phi: torch.Tensor,
                          cell: torch.Tensor, sf: torch.Tensor,
                          si: torch.Tensor, T: int, kcar: bool):
    """Plain PyTorch version of the fused kernel (see the module doc)."""
    dev = tables.n.device
    n = tables.n
    B, E = n.shape
    W = tables.latp.shape[1]
    F = NUM_FORMANTS

    # ---- A: sequencer closed form ------------------------------------
    k1 = torch.arange(1, T + 1, dtype=torch.int32, device=dev)
    j = torch.searchsorted(n, k1.expand(B, T).contiguous())  # count(n < k1)
    jc = j.clamp(max=E - 1)
    jn = (jc + 1).clamp(max=E - 1)
    has_next = jc < E - 1
    valid = (k1 >= 1) & (k1 <= n[:, E - 1:E])                 # [B, T]
    vm = valid.to(torch.float32)

    def rows(tab, idx):   # tab [B, E, ...] -> [B, T, ...]
        flat = tab.reshape(B, E, -1)
        g = flat.gather(1, idx[..., None].expand(B, T, flat.shape[-1]))
        return g.reshape((B, T) + tab.shape[2:])

    sc_c, sc_n = rows(tables.scal, jc), rows(tables.scal, jn)
    k1f = k1.to(torch.float32)
    dt = tables.par[:, 3:4]
    alf = ((sc_c[..., 1] - k1f * dt) / sc_c[..., 2]).clamp(0.0, 1.0)
    one_m = 1.0 - alf
    hs_c = sc_c[..., 3] > 0.5
    hs_n = (sc_n[..., 3] > 0.5) & has_next
    both = hs_c & hs_n

    def pick(c, nx, sil, a, om, v, hc, hn, bo):
        blend = c * a + nx * om
        out = torch.where(bo, blend, torch.where(
            hc, c, torch.where(hn, nx, torch.full_like(c, sil))))
        return torch.where(v, out, torch.full_like(c, sil))

    fr_e = pick(sc_c[..., 0], sc_n[..., 0], 0.25, alf, one_m, valid,
                hs_c, hs_n, both)

    vc, vn = rows(tables.vec, jc), rows(tables.vec, jn)       # [B, T, 6, 8]
    a3, om3, v3 = alf[..., None], one_m[..., None], valid[..., None]
    hc3, hn3, bo3 = hs_c[..., None], hs_n[..., None], both[..., None]
    ff_e, bw_e, sm_e = (pick(vc[:, :, i], vn[:, :, i], 0.25, a3, om3, v3,
                             hc3, hn3, bo3) for i in range(3))
    br_e, tb_e = (pick(vc[:, :, i], vn[:, :, i], 0.0, a3, om3, v3,
                       hc3, hn3, bo3) for i in (3, 4))
    ac_, an_ = vc[:, :, 5], vn[:, :, 5]
    zero = torch.zeros_like(ac_)
    am_e = torch.where(v3, torch.where(bo3, ac_ * a3 + an_ * om3, torch.where(
        hc3, ac_ * a3, torch.where(hn3, an_ * om3, zero))), zero)
    del vc, vn, ac_, an_, zero            # the largest intermediates

    # ---- B: jitter from the exact shared schedule ----------------------
    ph = phi[:T]
    ic = cell[:T].to(torch.int64).clamp(0, W - 2)
    pitch = (tables.latp[:, ic] * (1.0 - ph)
             + tables.latp[:, ic + 1] * ph) * vm
    ph3 = ph[:, None]
    fc, fnx = tables.latf[:, ic], tables.latf[:, ic + 1]      # [B, T, 8]
    form = fc + (fnx - fc) * ph3
    acl, anl = tables.lata[:, ic], tables.lata[:, ic + 1]
    ampn = acl + (anl - acl) * ph3
    freq_j = fr_e + pitch * tables.par[:, 0:1]
    jdff_m = (vm * tables.par[:, 1:2])[..., None]
    jda_m = (vm * (0.5 * tables.par[:, 2:3]))[..., None]
    ff_j = ff_e + form * jdff_m
    am_j = am_e * (1.0 - (ampn + 1.0) * jda_m)

    # ---- C: carrier, polyBLEP, noise, coefficients ---------------------
    si_out = si.clone()
    if kcar:
        phase, pf = f32_carrier(freq_j, si[:, 2].view(torch.float32))
        si_out[:, 2] = pf.view(torch.int32)
    else:
        phase, qf = q32_carrier(freq_j, _i32_to_u32(si[:, 0]))
        si_out[:, 0] = _u32_to_i32(qf)
    t0 = phase / freq_j
    first = 2.0 * t0 - t0 * t0 - 1.0
    t1 = (phase - 1.0) / freq_j
    last = t1 * t1 + 2.0 * t1 + 1.0
    pb = torch.where(phase < freq_j, first,
                     torch.where(phase > 1.0 - freq_j, last,
                                 torch.zeros_like(phase)))
    saw = (2.0 * phase - 1.0 - pb)[..., None]

    states = lehmer_block_states(_i32_to_u32(si[:, 1]), T)    # [B, T]
    noise = random_f32_from_state(states)[..., None]
    si_out[:, 1] = _u32_to_i32(states[:, -1])

    nw = saw + (noise - saw) * br_e
    alpha = exp_approx(sm_e)
    tamp = (1.0 + (noise - 1.0) * tb_e) * am_j
    x = ff_j
    N_, D_ = tan_approx_parts(x)
    fD2 = x * (D_ * D_)
    fN2 = x * (N_ * N_)
    ND = N_ * D_
    r_ = 1.0 / (fD2 + fN2 + bw_e * ND)
    a1 = fD2 * r_
    m21 = 2.0 * ((x * ND) * r_)
    a3c = fN2 * r_

    def tm(*s):  # [B, T, 8] each -> [T, B, 8(, k)]: one slice per step
        x = s[0] if len(s) == 1 else torch.stack(s, dim=-1)
        return x.transpose(0, 1).contiguous()

    # ---- D: the sequential recurrence ---------------------------------
    #   lp' = alpha*lp + d
    #   b'  = (m11*b - m21*c) + q1*lp'
    #   c'  = (m21*b + m22*c) + q2*lp'
    # with (b, c) as one [B, 8, 2] state: the rows [m11, m21] * b plus
    # [-m21, m22] * c plus [q1, q2] * lp' round exactly as the three-term
    # sums above (x + (-y) == x - y), in fewer eager ops per step.
    s_alpha, s_d = tm(alpha), tm((1.0 - alpha) * nw)
    s_mb = tm(2.0 * a1 - 1.0, m21)
    s_mc = tm(-m21, 1.0 - 2.0 * a3c)
    s_q = tm(m21 * tamp, (2.0 * a3c) * tamp)
    lp = sf[:, :F]
    bc = torch.stack([sf[:, F:2 * F], sf[:, 2 * F:]], dim=-1)  # [B, 8, 2]
    b0 = bc[..., 0]
    bs = torch.empty(T, B, F, dtype=torch.float32, device=dev)
    for i in range(T):
        lp = s_alpha[i] * lp + s_d[i]
        bc = (s_mb[i] * bc[..., :1] + s_mc[i] * bc[..., 1:]
              + s_q[i] * lp[..., None])
        bs[i] = bc[..., 0]
    y = bs + torch.cat([b0[None], bs[:-1]], dim=0)            # b' + b
    acc = y[..., 0]
    for f in range(1, F):                                      # left fold,
        acc = acc + y[..., f]                                  # as the kernel
    audio = (acc * 0.25).transpose(0, 1) * vm
    sf_out = torch.cat([lp, bc[..., 0], bc[..., 1]], dim=1)
    return audio.contiguous(), sf_out, si_out


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

_leh_cache = {}


def _lehmer_table(device) -> torch.Tensor:
    key = str(device)
    t = _leh_cache.get(key)
    if t is None:
        t = torch.from_numpy(lehmer_chunk_tables(CHUNK).view(np.int32)
                             .copy()).to(device)
        _leh_cache[key] = t
    return t


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


def fused_synth_cuda(tables: FusedTables, phi: torch.Tensor,
                     cell: torch.Tensor, sf: torch.Tensor, si: torch.Tensor,
                     T: int, kcar: bool):
    """Launch synth/csrc/fused_synth.cu on the current stream."""
    import ctypes

    from ._build import load_library

    dev = tables.n.device
    if dev.type != "cuda":
        raise ValueError(f"fused_synth_cuda needs CUDA tensors, got {dev}")
    B, E = tables.n.shape
    W = tables.latp.shape[1]
    F = NUM_FORMANTS
    if T <= 0 or T % CHUNK:
        raise ValueError(f"T={T} must be a positive multiple of {CHUNK}")
    if E < 1 or W < 2:
        raise ValueError(f"need E >= 1 and W >= 2, got E={E}, W={W}")
    f32, i32 = torch.float32, torch.int32
    _check("n", tables.n, i32, (B, E), dev)
    _check("scal", tables.scal, f32, (B, E, 4), dev)
    _check("vec", tables.vec, f32, (B, E, 6, F), dev)
    _check("latp", tables.latp, f32, (B, W), dev)
    _check("latf", tables.latf, f32, (B, W, F), dev)
    _check("lata", tables.lata, f32, (B, W, F), dev)
    _check("par", tables.par, f32, (B, 4), dev)
    _check("phi", phi, f32, (T,), dev)
    _check("cell", cell, i32, (T,), dev)
    _check("sf", sf, f32, (B, 3 * F), dev)
    _check("si", si, i32, (B, 3), dev)

    lib = load_library()
    leh = _lehmer_table(dev)
    audio = torch.empty(B, T, dtype=f32, device=dev)
    sf_out = torch.empty_like(sf)
    si_out = torch.empty_like(si)
    p = ctypes.c_void_p
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.grail_fused_synth(
            p(tables.n.data_ptr()), p(tables.scal.data_ptr()),
            p(tables.vec.data_ptr()), p(tables.latp.data_ptr()),
            p(tables.latf.data_ptr()), p(tables.lata.data_ptr()),
            p(tables.par.data_ptr()), p(leh.data_ptr()),
            p(phi.data_ptr()), p(cell.data_ptr()),
            p(sf.data_ptr()), p(si.data_ptr()),
            p(audio.data_ptr()), p(sf_out.data_ptr()),
            p(si_out.data_ptr()),
            B, E, W, T, int(bool(kcar)), p(stream))
        LAUNCHES["fused_synth"] += 1
    if rc != 0:
        raise RuntimeError(f"fused_synth kernel launch failed: CUDA error "
                           f"{rc} ({lib.grail_cuda_error_string(rc).decode()})")
    return audio, sf_out, si_out


IMPLEMENTATIONS = {"kernel": fused_synth_cuda, "plain": synth_fused_reference}


def synth_fused(tables: FusedTables, T: int, impl: str,
                state: Optional[SynthState] = None, sched=None,
                exact_carrier: bool = False):
    """tables -> (audio [B, T], final SynthState).

    `impl` is 'kernel' (fused_synth_cuda, which takes CUDA tensors only) or
    'plain' (synth_fused_reference); api.route chooses it from the device.
    `sched` = (phi [T], cell [T]): the exact jitter schedule for samples
    1..T, shared by every utterance (schedule.device_window).
    `exact_carrier=True` runs the reference's f32 carrier recurrence from
    `state.phase` instead of the Q32 fixed-point accumulator; the returned
    phase is then the exact post-update reference phase."""
    if sched is None:
        raise ValueError("pass sched=(phi, cell)")
    if impl not in IMPLEMENTATIONS:
        raise ValueError(f"impl must be one of {sorted(IMPLEMENTATIONS)}, "
                         f"got {impl!r}")
    dev = tables.n.device
    B = tables.n.shape[0]
    F = NUM_FORMANTS
    if state is None:
        state = SynthState.init(B, dev)
    sf = torch.cat([state.filter_state_a, state.filter_state_b,
                    state.filter_state_c], dim=1).to(torch.float32)
    q0 = (torch.remainder(state.phase, 1.0) * _Q32).to(torch.int64) & MASK32
    si = torch.stack([_u32_to_i32(q0), _u32_to_i32(state.seed),
                      state.phase.to(torch.float32).view(torch.int32)],
                     dim=1)
    phi, cell = sched
    audio, sf_o, si_o = IMPLEMENTATIONS[impl](
        tables, phi, cell, sf.contiguous(), si.contiguous(), T, exact_carrier)
    if exact_carrier:
        phase = si_o[:, 2].view(torch.float32)
    else:
        phase = _i32_to_u32(si_o[:, 0]).to(torch.float32) * _INV_Q32
    return audio, SynthState(phase=phase, filter_state_a=sf_o[:, :F],
                             filter_state_b=sf_o[:, F:2 * F],
                             filter_state_c=sf_o[:, 2 * F:],
                             seed=_i32_to_u32(si_o[:, 1]))


__all__ = ["CHUNK", "LAUNCHES", "FusedTables", "build_tables",
           "q32_carrier", "f32_carrier", "synth_fused_reference",
           "fused_synth_cuda", "IMPLEMENTATIONS", "synth_fused"]
