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

The jitter schedule (phi, cell) comes in one of two modes, as in the JAX
kernel: 'host', a schedule computed on the host (synth/schedule.py) and
shared by the lanes or given per lane group; or 'carry' (the serving tick,
runtime/stream.py), where each lane steps the reference recurrence itself
from a carried (phase, absolute cell) in si, so that a tick uploads no
schedule. In 'carry' mode a lane's lattice holds a sliding window whose row
0 is the absolute cell `lat_base`; cells read rows `cell - lat_base`,
clamped to the window as the host mode's cells are.

The carrier phase comes in one of three modes: the Q32 fixed-point
accumulator, the reference's f32 recurrence stepped in the kernel (`kcar`),
or, in the 'host_track' mode, a per-sample f32 track built on the host
(`carrier`: the native pre-pass, oracle/native.py), laid out and addressed
as the schedule is. A track gives every lane its exact phase at any offset,
so the solo long-form route keeps the overlap-save split with it, which the
in-kernel recurrence cannot (it has no phase to start a segment from).

Two implementations with one signature, (tables, phi, cell, sf, si, T, kcar,
g0, lat_base, inc, carrier) -> (audio [B, T], sf [B, 24], si [B, 3 or 5]);
phi and cell are None in 'carry' mode:

  * `synth_fused_reference` — plain PyTorch: A-C vectorized over [B, T],
    the Q32 carrier as an int64 cumsum, the f32 carrier and D as Python
    loops over samples. Runs on any device; the CPU path and the tests use
    it, and chip_smoke.py holds the kernel against it on the card.
  * `fused_synth_cuda` — the CUDA kernel synth/csrc/fused_synth.cu, one
    thread block per utterance (or per segment of one, on the split).

`synth_fused` runs the one that api.route chose: the kernel for a CUDA
device, the plain version for the CPU. A lane may start at a sample offset
`g0` and read its own schedule row, which is how the overlap-save split
(api._synthesize_split) runs S segments of each utterance as S lanes.

The split's seam phases come from the pre-pass `phase_q32_pre_block`: the
Q32 integral of the same frequency stream (phases A-B, `freq_chain`), from
the kernel synth/csrc/phase_q32_pre.cu or its plain version
`phase_q32_pre_reference`.

Carried state: sf rows are lp[8], b[8], c[8]; si holds uint32 bit patterns
as int32: 0 the Q32 carrier phase, 1 the Lehmer seed, 2 the f32 carrier
phase (exact mode), and in 'carry' mode 3 the f32 jitter phase and 4 the
absolute jitter cell. Audio is utterance-major [B, T] (the JAX kernel's is
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
from ._build import LAUNCHES, raise_on, resident
from .synthesize import _INV_Q32, _Q32, SynthState, q32_carrier

CHUNK = 128                  # samples per kernel chunk (= producer threads)
CHUNK_PRE = 1024             # samples per pre-pass chunk sum
_MIN_LAT_ROWS = 16           # lattices padded to at least this many rows


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
    the schedule (phi, cell), or the carry mode's `inc`, carries it."""
    n, scal, vec, par = score_tables(score, jparams, sample_rate)
    latp, latf, lata = lattice_tables(lattice)

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return FusedTables(n=up(n), scal=up(scal), vec=up(vec), latp=up(latp),
                       latf=up(latf), lata=up(lata), par=up(par))


def score_tables(score, jparams, sample_rate):
    """The score's tables of build_tables, as numpy arrays: (n [B, E],
    scal [B, E, 4], vec [B, E, 6, 8], par [B, 4])."""
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

    def row(x):
        return np.broadcast_to(np.asarray(x, np.float32), (B,))

    dt = np.float32(1.0) / sr
    par = np.stack([row(jdf), row(jdff), row(jda), row(dt)], axis=-1)
    return n, scal, vec, par


def lattice_tables(lattice):
    """The lattices of build_tables, as numpy arrays (latp [B, W'], latf and
    lata [B, W', 8]), W' = max(W, 16): short lattices repeat their last
    row."""
    def edge_pad(x):
        x = np.asarray(x, np.float32)
        k = _MIN_LAT_ROWS - x.shape[1]
        if k > 0:
            x = np.concatenate([x, np.repeat(x[:, -1:], k, axis=1)], axis=1)
        return x

    return tuple(edge_pad(x) for x in lattice)


def _u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 value -> int32 with the same bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _i32_to_u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & MASK32


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


class FreqChain(NamedTuple):
    """Phases A-B of the fused chain, one value per lane and sample
    ([B, T] each): what the carrier's frequency stream needs, and the
    intermediates the rest of the chain reuses."""

    jc: torch.Tensor      # int64 current element row
    jn: torch.Tensor      # int64 next element row
    valid: torch.Tensor   # bool: 1 <= k1 <= the utterance's last sample
    vm: torch.Tensor      # valid as f32
    alf: torch.Tensor     # blend alpha
    one_m: torch.Tensor   # 1 - alpha
    hs_c: torch.Tensor    # current element sounds
    hs_n: torch.Tensor    # next element sounds (and exists)
    both: torch.Tensor
    ph: torch.Tensor      # jitter phase phi
    ic: torch.Tensor      # int64 lattice cell, clamped to [0, W-2]
    freq_j: torch.Tensor  # jittered carrier frequency (cycles/sample)


def _pick(c, nx, sil, a, om, v, hc, hn, bo):
    """The 4-case pick: the blend of cur and next when both sound, else
    whichever sounds, else the silent default; silent where not valid."""
    blend = c * a + nx * om
    out = torch.where(bo, blend, torch.where(
        hc, c, torch.where(hn, nx, torch.full_like(c, sil))))
    return torch.where(v, out, torch.full_like(c, sil))


def _lane_rows(x: torch.Tensor, B: int, T: int) -> torch.Tensor:
    """Schedule [T] or [Ss, >=T] -> one row per lane [B, T]. Lanes are
    s-major (lane = s * (B // Ss) + b), so lane l reads row l // (B // Ss)."""
    x = x.reshape(-1, x.shape[-1])[:, :T]
    Ss = x.shape[0]
    if B % Ss:
        raise ValueError(f"{Ss} schedule rows for {B} lanes")
    return x.expand(B, T) if Ss == 1 else x.repeat_interleave(B // Ss, 0)


def freq_chain(tables: FusedTables, k1: torch.Tensor, phi: torch.Tensor,
               cell: torch.Tensor) -> FreqChain:
    """Phases A-B for every lane: the sequencer closed form, fr_e, the pitch
    jitter and freq_j. `k1` is the 1-based absolute sample index per lane
    (int32 [B, T], offsets applied); (phi, cell) the schedule as
    `_lane_rows` takes it. The fused plain version and the plain pre-pass
    both run this one function, as the CUDA kernels share seq_freq.cuh: the
    split's seams are exact only if both integrate one frequency stream."""
    n = tables.n
    B, E = n.shape
    T = k1.shape[1]
    W = tables.latp.shape[1]

    # ---- A: sequencer closed form ------------------------------------
    j = torch.searchsorted(n, k1)                              # count(n < k1)
    jc = j.clamp(max=E - 1)
    jn = (jc + 1).clamp(max=E - 1)
    has_next = jc < E - 1
    valid = (k1 >= 1) & (k1 <= n[:, E - 1:E])                 # [B, T]
    vm = valid.to(torch.float32)
    sc_c, sc_n = _rows(tables.scal, jc), _rows(tables.scal, jn)
    k1f = k1.to(torch.float32)
    dt = tables.par[:, 3:4]
    alf = ((sc_c[..., 1] - k1f * dt) / sc_c[..., 2]).clamp(0.0, 1.0)
    one_m = 1.0 - alf
    hs_c = sc_c[..., 3] > 0.5
    hs_n = (sc_n[..., 3] > 0.5) & has_next
    both = hs_c & hs_n
    fr_e = _pick(sc_c[..., 0], sc_n[..., 0], 0.25, alf, one_m, valid,
                 hs_c, hs_n, both)

    # ---- B: pitch jitter from the exact schedule -------------------------
    ph = _lane_rows(phi, B, T)
    ic = _lane_rows(cell, B, T).to(torch.int64).clamp(0, W - 2)
    pitch = (tables.latp.gather(1, ic) * (1.0 - ph)
             + tables.latp.gather(1, ic + 1) * ph) * vm
    freq_j = fr_e + pitch * tables.par[:, 0:1]
    return FreqChain(jc, jn, valid, vm, alf, one_m, hs_c, hs_n, both, ph,
                     ic, freq_j)


def _rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tab [B, R, ...] gathered at rows idx [B, T] -> [B, T, ...]."""
    B, R = tab.shape[:2]
    flat = tab.reshape(B, R, -1)
    g = flat.gather(1, idx[..., None].expand(*idx.shape, flat.shape[-1]))
    return g.reshape(tuple(idx.shape) + tuple(tab.shape[2:]))


def _k1(B: int, T: int, g0: Optional[torch.Tensor], device) -> torch.Tensor:
    """int32 [B, T]: 1-based absolute sample index g0 + k + 1 per lane."""
    k1 = torch.arange(1, T + 1, dtype=torch.int32, device=device)
    if g0 is None:
        return k1.expand(B, T).contiguous()
    return (g0.to(torch.int32)[:, None] + k1).contiguous()


def jitter_carry(jphi: torch.Tensor, jcell: torch.Tensor, inc, T: int):
    """T steps of the reference jitter recurrence (src/lib.rs:236-249,
    287-300) from each lane's carried state, jphi f32 [B] and the absolute
    cell jcell int32 [B]: per sample `phase = f32(phase + inc)`, and if
    phase > 1, `phase -= 1` (exact) and the cell advances. A float32 loop
    over samples, vectorized over lanes (torch's CPU cumsum would add in
    double). Returns the post-update (phi f32 [B, T], cell int32 [B, T])
    and the final (jphi, jcell)."""
    inc = float(np.float32(inc))
    p, c = jphi.clone(), jcell.clone()
    B = p.shape[0]
    phi = torch.empty(B, T, dtype=torch.float32, device=p.device)
    cell = torch.empty(B, T, dtype=torch.int32, device=p.device)
    for i in range(T):
        p = p + inc
        wrap = p > 1.0
        p = torch.where(wrap, p - 1.0, p)
        c = c + wrap.to(torch.int32)
        phi[:, i] = p
        cell[:, i] = c
    return phi, cell, p, c


def synth_fused_reference(tables: FusedTables, phi: Optional[torch.Tensor],
                          cell: Optional[torch.Tensor], sf: torch.Tensor,
                          si: torch.Tensor, T: int, kcar: bool,
                          g0: Optional[torch.Tensor] = None,
                          lat_base: Optional[torch.Tensor] = None,
                          inc: Optional[float] = None,
                          carrier: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the fused kernel (see the module doc).
    `g0` (int32 [B] or None for zeros): each lane's sample offset, so lane b
    renders absolute samples g0[b] + 1 .. g0[b] + T. With phi and cell None
    it runs the 'carry' mode: the jitter rate `inc`, si [B, 5] with the
    carried jitter state in columns 3-4, and `lat_base` (int32 [B] or None
    for zeros) the absolute cell of each lane's lattice row 0. `carrier`
    (f32, the schedule's shape: [T] or [Ss, >=T]) is the 'host_track' mode:
    the per-sample carrier phase, read in place of both accumulators; the
    Q32 and f32 phase columns of si then pass through unchanged."""
    dev = tables.n.device
    B = tables.n.shape[0]
    F = NUM_FORMANTS
    _check_carrier_mode(carrier, kcar, phi is None)

    jfinal = None
    if phi is None:
        phi, cell_abs, *jfinal = jitter_carry(si[:, 3].view(torch.float32),
                                              si[:, 4], inc, T)
        cell = (cell_abs if lat_base is None
                else cell_abs - lat_base.to(torch.int32)[:, None])

    # ---- A-B: sequencer, pitch jitter, frequency -----------------------
    fc_ = freq_chain(tables, _k1(B, T, g0, dev), phi, cell)
    valid, vm, alf, one_m = fc_.valid, fc_.vm, fc_.alf, fc_.one_m
    freq_j = fc_.freq_j

    vc, vn = _rows(tables.vec, fc_.jc), _rows(tables.vec, fc_.jn)  # [B,T,6,8]
    a3, om3, v3 = alf[..., None], one_m[..., None], valid[..., None]
    hc3, hn3 = fc_.hs_c[..., None], fc_.hs_n[..., None]
    bo3 = fc_.both[..., None]
    ff_e, bw_e, sm_e = (_pick(vc[:, :, i], vn[:, :, i], 0.25, a3, om3, v3,
                              hc3, hn3, bo3) for i in range(3))
    br_e, tb_e = (_pick(vc[:, :, i], vn[:, :, i], 0.0, a3, om3, v3,
                        hc3, hn3, bo3) for i in (3, 4))
    ac_, an_ = vc[:, :, 5], vn[:, :, 5]
    zero = torch.zeros_like(ac_)
    am_e = torch.where(v3, torch.where(bo3, ac_ * a3 + an_ * om3, torch.where(
        hc3, ac_ * a3, torch.where(hn3, an_ * om3, zero))), zero)
    del vc, vn, ac_, an_, zero            # the largest intermediates

    # ---- B: formant and amplitude jitter -------------------------------
    ic, ph3 = fc_.ic, fc_.ph[..., None]
    fc, fnx = _rows(tables.latf, ic), _rows(tables.latf, ic + 1)  # [B,T,8]
    form = fc + (fnx - fc) * ph3
    acl, anl = _rows(tables.lata, ic), _rows(tables.lata, ic + 1)
    ampn = acl + (anl - acl) * ph3
    jdff_m = (vm * tables.par[:, 1:2])[..., None]
    jda_m = (vm * (0.5 * tables.par[:, 2:3]))[..., None]
    ff_j = ff_e + form * jdff_m
    am_j = am_e * (1.0 - (ampn + 1.0) * jda_m)

    # ---- C: carrier, polyBLEP, noise, coefficients ---------------------
    si_out = si.clone()
    if carrier is not None:
        phase = _lane_rows(carrier, B, T)
    elif kcar:
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
    if jfinal is not None:
        si_out[:, 3] = jfinal[0].view(torch.int32)
        si_out[:, 4] = jfinal[1]

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


def phase_q32_pre_reference(tables: FusedTables, phi: torch.Tensor,
                            cell: torch.Tensor, T: int) -> torch.Tensor:
    """Plain PyTorch version of the pre-pass kernel: per utterance and
    CHUNK_PRE-sample chunk of samples 1..T, the mod-2^32 sum of
    trunc(freq_j * 2^32) over the fused chain's own frequency stream.
    Returns uint32 values held in int64 [B, T // CHUNK_PRE]."""
    B = tables.n.shape[0]
    fc_ = freq_chain(tables, _k1(B, T, None, tables.n.device), phi, cell)
    fq = (fc_.freq_j * _Q32).to(torch.int64)  # exact scale, then truncate
    return fq.view(B, T // CHUNK_PRE, CHUNK_PRE).sum(-1) & MASK32


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


def _check_tables(tables: FusedTables, dev, W_min: int = 2):
    """Check the tables the kernels read; returns (B, E, W)."""
    if dev.type != "cuda":
        raise ValueError(f"the kernels need CUDA tensors, got {dev}")
    B, E = tables.n.shape
    W = tables.latp.shape[1]
    F = NUM_FORMANTS
    if E < 1 or W < W_min:
        raise ValueError(f"need E >= 1 and W >= {W_min}, got E={E}, W={W}")
    f32, i32 = torch.float32, torch.int32
    _check("n", tables.n, i32, (B, E), dev)
    _check("scal", tables.scal, f32, (B, E, 4), dev)
    _check("vec", tables.vec, f32, (B, E, 6, F), dev)
    _check("latp", tables.latp, f32, (B, W), dev)
    _check("latf", tables.latf, f32, (B, W, F), dev)
    _check("lata", tables.lata, f32, (B, W, F), dev)
    _check("par", tables.par, f32, (B, 4), dev)
    return B, E, W


def _check_carrier_mode(carrier, kcar: bool, carry: bool):
    """The host_track mode excludes the in-kernel carrier recurrence and the
    carry mode: a track with either is a caller's error, raised before any
    launch."""
    if carrier is not None and (kcar or carry):
        raise ValueError(
            "a carrier track replaces the carrier accumulator: it cannot be "
            "combined with the in-kernel exact carrier (kcar) or with the "
            "carry mode (phi=cell=None)")


def _check_sched(phi, cell, T: int, dev):
    """Check the kernel's schedule: contiguous [T], or [Ss, T] rows with unit
    sample stride that may overlap (the split's segment windows are strided
    views of one window). Returns (Ss, row stride in elements)."""
    if phi.dim() == 1:
        _check("phi", phi, torch.float32, (T,), dev)
        _check("cell", cell, torch.int32, (T,), dev)
        return 1, 0
    for name, t, dtype in (("phi", phi, torch.float32),
                           ("cell", cell, torch.int32)):
        if t.dim() != 2 or t.shape[0] < 1:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"(Ss, {T})")
        _check(name, t[0], dtype, (T,), dev)
    if phi.shape != cell.shape or phi.stride() != cell.stride():
        raise ValueError(f"phi and cell differ in shape or strides: "
                         f"{tuple(phi.shape)}/{phi.stride()} vs "
                         f"{tuple(cell.shape)}/{cell.stride()}")
    return phi.shape[0], phi.stride(0)


def fused_synth_cuda(tables: FusedTables, phi: Optional[torch.Tensor],
                     cell: Optional[torch.Tensor], sf: torch.Tensor,
                     si: torch.Tensor, T: int, kcar: bool,
                     g0: Optional[torch.Tensor] = None,
                     lat_base: Optional[torch.Tensor] = None,
                     inc: Optional[float] = None,
                     carrier: Optional[torch.Tensor] = None):
    """Launch synth/csrc/fused_synth.cu on the current stream. (phi, cell)
    is [T] (shared by every lane) or [Ss, T] (one row per group of B // Ss
    s-major lanes; rows may be overlapping views, see _check_sched); `g0`
    int32 [B] or None, as in synth_fused_reference. With phi and cell None
    it launches the 'carry' mode (si [B, 5], `lat_base` int32 [B] or None,
    the jitter rate `inc`), counted as LAUNCHES['fused_synth_carry']. With
    `carrier` (f32, the shape and strides of phi) it launches the
    'host_track' mode, counted as LAUNCHES['fused_synth_track']."""
    import ctypes

    from ._build import load_library

    carry = phi is None
    _check_carrier_mode(carrier, kcar, carry)
    dev = tables.n.device
    B, E, W = _check_tables(tables, dev)
    if T <= 0 or T % CHUNK:
        raise ValueError(f"T={T} must be a positive multiple of {CHUNK}")
    f32, i32 = torch.float32, torch.int32
    if carry:
        if cell is not None or inc is None:
            raise ValueError("the carry mode takes phi=cell=None and inc")
        Ss, row_stride = 1, 0
        if lat_base is not None:
            _check("lat_base", lat_base, i32, (B,), dev)
    else:
        if lat_base is not None or inc is not None:
            raise ValueError("lat_base and inc belong to the carry mode "
                             "(phi=cell=None)")
        Ss, row_stride = _check_sched(phi, cell, T, dev)
        if B % Ss:
            raise ValueError(f"{Ss} schedule rows for {B} lanes")
        if carrier is not None:
            if carrier.shape != phi.shape or carrier.stride() != phi.stride():
                raise ValueError(
                    f"carrier and phi differ in shape or strides: "
                    f"{tuple(carrier.shape)}/{carrier.stride()} vs "
                    f"{tuple(phi.shape)}/{phi.stride()}")
            _check("carrier", carrier if carrier.dim() == 1 else carrier[0],
                   f32, (T,), dev)
    _check("sf", sf, f32, (B, 3 * NUM_FORMANTS), dev)
    _check("si", si, i32, (B, 5 if carry else 3), dev)
    if g0 is not None:
        _check("g0", g0, i32, (B,), dev)

    lib = load_library()
    leh = _lehmer_table(dev)
    audio = torch.empty(B, T, dtype=f32, device=dev)
    sf_out = torch.empty_like(sf)
    si_out = torch.empty_like(si)
    p = ctypes.c_void_p

    def ptr(t):
        return p(None if t is None else t.data_ptr())

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.grail_fused_synth(
            ptr(tables.n), ptr(tables.scal), ptr(tables.vec),
            ptr(tables.latp), ptr(tables.latf), ptr(tables.lata),
            ptr(tables.par), ptr(leh), ptr(phi), ptr(cell), ptr(carrier),
            ptr(g0), ptr(lat_base), ptr(sf), ptr(si), ptr(audio),
            ptr(sf_out), ptr(si_out), B, E, W, T, B // Ss, row_stride,
            int(bool(kcar)), int(carry), float(np.float32(inc or 0.0)),
            p(stream))
        LAUNCHES["fused_synth_carry" if carry else
                 "fused_synth_track" if carrier is not None else
                 "fused_synth"] += 1
    raise_on(lib, rc, "fused_synth kernel launch")
    return audio, sf_out, si_out


def phase_q32_pre_cuda(tables: FusedTables, phi: torch.Tensor,
                       cell: torch.Tensor, T: int) -> torch.Tensor:
    """Launch synth/csrc/phase_q32_pre.cu on the current stream: the chunk
    sums of phase_q32_pre_reference, uint32 values held in int64
    [B, T // CHUNK_PRE]. (phi, cell) is the schedule of samples 1..T, [T]."""
    import ctypes

    from ._build import load_library

    dev = tables.n.device
    B, E, W = _check_tables(tables, dev)
    if T <= 0 or T % CHUNK_PRE:
        raise ValueError(f"T={T} must be a positive multiple of {CHUNK_PRE}")
    if B > 65535:
        raise ValueError(f"B={B} exceeds the grid's 65,535 utterances")
    _check("phi", phi, torch.float32, (T,), dev)
    _check("cell", cell, torch.int32, (T,), dev)

    lib = load_library()
    sums = torch.empty(B, T // CHUNK_PRE, dtype=torch.int32, device=dev)
    p = ctypes.c_void_p
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.grail_phase_q32_pre(
            p(tables.n.data_ptr()), p(tables.scal.data_ptr()),
            p(tables.latp.data_ptr()), p(tables.par.data_ptr()),
            p(phi.data_ptr()), p(cell.data_ptr()), p(sums.data_ptr()),
            B, E, W, T, p(stream))
        LAUNCHES["phase_q32_pre"] += 1
    raise_on(lib, rc, "phase_q32_pre kernel launch")
    return _i32_to_u32(sums)


def fused_synth_slots(device) -> int:
    """Thread blocks of the fused kernel the card holds at once: the
    occupancy API's resident blocks per SM, at the launch's own thread count
    and dynamic shared memory, times the SM count, queried from the card on
    first use and memoized per device."""
    return resident("grail_fused_synth_slots", device)


def fused_synth_geometry(device) -> dict:
    """The fused kernel's launch geometry on CUDA `device`: threads per
    block, dynamic and static shared bytes per block, registers per thread
    (the compiled kernel's), resident blocks per SM, and the shared memory
    of one SM."""
    import ctypes

    from ._build import load_library

    dev = torch.device(device)
    lib = load_library()
    vals = [ctypes.c_int(0) for _ in range(5)]
    with torch.cuda.device(dev):
        rc = lib.grail_fused_synth_geometry(*map(ctypes.byref, vals))
    raise_on(lib, rc, "fused_synth geometry query")
    threads, dyn, regs, static, sm_smem = (v.value for v in vals)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return {"threads": threads, "dynamic_smem": dyn, "static_smem": static,
            "registers": regs, "sm_smem": sm_smem,
            "blocks_per_sm": fused_synth_slots(dev) // sms}


def phase_q32_pre_geometry(B: int, E: int, W: int, T: int, device) -> dict:
    """What phase_q32_pre_cuda launches on CUDA `device` for B utterances
    of T samples with E elements and W lattice cells: blocks, threads per
    block, dynamic shared bytes (0: the tables are read from global memory,
    not staged) and the compiled kernel's registers per thread."""
    import ctypes

    from ._build import load_library

    lib = load_library()
    vals = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(torch.device(device)):
        rc = lib.grail_phase_q32_pre_geometry(B, E, W, T,
                                              *map(ctypes.byref, vals))
    raise_on(lib, rc, "phase_q32_pre geometry query")
    return dict(zip(("blocks", "threads", "dynamic_smem", "registers"),
                    (v.value for v in vals)))


IMPLEMENTATIONS = {"kernel": fused_synth_cuda, "plain": synth_fused_reference}
PRE_IMPLEMENTATIONS = {"kernel": phase_q32_pre_cuda,
                       "plain": phase_q32_pre_reference}


def phase_q32_pre_block(tables: FusedTables, sched, T: int, blk: int,
                        impl: str) -> torch.Tensor:
    """Q32 carrier-phase accumulator before each `blk`-sample block of
    samples 1..T: the exclusive prefix sum of trunc(freq_j * 2^32) mod 2^32,
    uint32 values held in int64 [T // blk, B]. Counterpart of
    grail_tpu's phase_q32_pre_block: per-CHUNK_PRE chunk sums (the kernel,
    or its plain version), then the exclusive cumsum over chunks, sampled
    every blk // CHUNK_PRE. `sched` = (phi [T], cell [T]) for samples 1..T;
    `impl` is 'kernel' or 'plain', as for synth_fused."""
    if impl not in PRE_IMPLEMENTATIONS:
        raise ValueError(f"impl must be one of {sorted(PRE_IMPLEMENTATIONS)}"
                         f", got {impl!r}")
    if blk % CHUNK_PRE or T % blk:
        raise ValueError(f"need blk % {CHUNK_PRE} == 0 and T % blk == 0, "
                         f"got blk={blk}, T={T}")
    phi, cell = sched
    sums = PRE_IMPLEMENTATIONS[impl](tables, phi, cell, T)     # [B, nt]
    excl = (torch.cumsum(sums, dim=1) - sums) & MASK32
    return excl[:, ::blk // CHUNK_PRE].T.contiguous()


def state_rows(state: SynthState,
               phase_q32: Optional[torch.Tensor] = None):
    """SynthState -> the kernels' carried-state rows (sf f32 [B, 24],
    si int32 [B, 3]; see the module doc). `phase_q32` (uint32 values in
    int64 [B]) sets the Q32 phase exactly, in place of state.phase."""
    sf = torch.cat([state.filter_state_a, state.filter_state_b,
                    state.filter_state_c], dim=1).to(torch.float32)
    q0 = (torch.remainder(state.phase, 1.0) * _Q32).to(torch.int64) & MASK32
    if phase_q32 is not None:
        q0 = phase_q32.to(torch.int64) & MASK32
    si = torch.stack([_u32_to_i32(q0), _u32_to_i32(state.seed),
                      state.phase.to(torch.float32).view(torch.int32)],
                     dim=1)
    return sf.contiguous(), si.contiguous()


def synth_fused(tables: FusedTables, T: int, impl: str,
                state: Optional[SynthState] = None, sched=None,
                exact_carrier: bool = False,
                phase_q32: Optional[torch.Tensor] = None,
                g0: Optional[torch.Tensor] = None,
                carrier: Optional[torch.Tensor] = None):
    """tables -> (audio [B, T], final SynthState).

    `impl` is 'kernel' (fused_synth_cuda, which takes CUDA tensors only) or
    'plain' (synth_fused_reference); api.route chooses it from the device.
    `sched` = (phi, cell): the exact jitter schedule, [T] for samples 1..T
    shared by every utterance (schedule.device_window), or [Ss, T] rows for
    s-major lane groups (the split's per-segment windows).
    `exact_carrier=True` runs the reference's f32 carrier recurrence from
    `state.phase` instead of the Q32 fixed-point accumulator; the returned
    phase is then the exact post-update reference phase.
    `phase_q32` (uint32 values in int64 [B]) sets each lane's initial Q32
    phase exactly, in place of state.phase; `g0` (int [B]) offsets each
    lane's samples (the split's segments). `carrier` (f32, shaped and
    strided as phi) is the host-built carrier phase track of the
    'host_track' mode: it replaces the carrier accumulator (not with
    exact_carrier=True), and the returned phase is the one passed in. The
    'carry' mode has one entry,
    the serving tick (runtime/stream._tick), which keeps the carried rows
    on the card between launches."""
    if sched is None:
        raise ValueError("pass sched=(phi, cell)")
    if impl not in IMPLEMENTATIONS:
        raise ValueError(f"impl must be one of {sorted(IMPLEMENTATIONS)}, "
                         f"got {impl!r}")
    dev = tables.n.device
    F = NUM_FORMANTS
    if state is None:
        state = SynthState.init(tables.n.shape[0], dev)
    sf, si = state_rows(state, phase_q32)
    if g0 is not None:
        g0 = g0.to(device=dev, dtype=torch.int32).contiguous()
    phi, cell = sched
    audio, sf_o, si_o = IMPLEMENTATIONS[impl](
        tables, phi, cell, sf, si, T, exact_carrier, g0=g0, carrier=carrier)
    if exact_carrier:
        phase = si_o[:, 2].view(torch.float32)
    else:
        phase = _i32_to_u32(si_o[:, 0]).to(torch.float32) * _INV_Q32
    return audio, SynthState(phase=phase, filter_state_a=sf_o[:, :F],
                             filter_state_b=sf_o[:, F:2 * F],
                             filter_state_c=sf_o[:, 2 * F:],
                             seed=_i32_to_u32(si_o[:, 1]))


__all__ = ["CHUNK", "CHUNK_PRE", "LAUNCHES", "FusedTables", "FreqChain",
           "build_tables", "score_tables", "lattice_tables", "jitter_carry",
           "freq_chain", "q32_carrier", "f32_carrier",
           "synth_fused_reference", "fused_synth_cuda", "IMPLEMENTATIONS",
           "synth_fused", "state_rows", "phase_q32_pre_reference", "phase_q32_pre_cuda",
           "PRE_IMPLEMENTATIONS", "phase_q32_pre_block", "fused_synth_slots",
           "fused_synth_geometry", "phase_q32_pre_geometry"]
