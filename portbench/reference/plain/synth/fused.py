"""The fused chain in plain PyTorch, in blocks of samples.

A frozen copy of the port's plain fused chain (grail_tpu_torch/synth/
kernel_fused.py: `build_tables`, `freq_chain`, the carriers and
`synth_fused_reference`'s phases A-C, op for op), with two changes:

  * the sequential one-pole + SVF recurrence (phase D) runs as the
    associative scans of grail_tpu_torch/synth/synthesize.py (the odd/even
    combination tree of jax.lax.associative_scan), so a block of L samples
    costs O(log L) tensor ops instead of L Python steps;
  * the whole chain runs over `block` samples at a time with the carried
    state (carrier phase, Lehmer seed, filter rows), so an utterance of
    millions of samples fits.

The carriers: Q32 fixed point (an int64 cumsum masked to 32 bits) or the
reference's f32 recurrence (`phase += f; if phase >= 1: phase -= 1`), run
in numpy on the host as sequential float32 adds, cut at each wrap.

`dtype` is the precision of phases A-D (the tables, the streams, the
scans): float32 is the reference; a lower one (bfloat16) is the control,
whose f32 carrier recurrence then integrates the lower-precision
frequency stream.
"""

from __future__ import annotations

from typing import NamedTuple

import struct

import numpy as np
import torch

from ..core.approx import exp_approx, tan_approx_parts
from ..core.constants import NUM_FORMANTS
from ..core.rng import MASK32, lehmer_block_states, random_f32_from_state

_Q32 = 4294967296.0
_INV_Q32 = 1.0 / 4294967296.0
_MIN_LAT_ROWS = 16
_RUN = 1024
_F32 = struct.Struct("f")
_FAST = 0.02     # increments that wrap within 50 samples
_CONST = 256     # runs of one increment this long repeat a cycle


class FusedTables(NamedTuple):
    n: torch.Tensor      # [B, E] int32 element end samples
    scal: torch.Tensor   # [B, E, 4]: frequency, cum_length, blend, sound
    vec: torch.Tensor    # [B, E, 6, 8]: formant freq, bw, smooth, breath,
                         #   turb, amp
    latp: torch.Tensor   # [B, W] pitch lattice
    latf: torch.Tensor   # [B, W, 8] formant-frequency lattice
    lata: torch.Tensor   # [B, W, 8] amplitude lattice
    par: torch.Tensor    # [B, 4]: jdf, jdff, jda, dt


def build_tables(score, lattice, jparams, sample_rate, device="cpu",
                 dtype=torch.float32) -> FusedTables:
    """Batched numpy Score [B, E] + lattices [B, W(, 8)] -> tables."""
    _, jdf, jdff, jda = jparams
    sr = np.float32(sample_rate)
    C = np.asarray(score.cum_length, np.float32)
    B, E = C.shape
    n = np.floor(C * sr).astype(np.int32)
    el = score.elem
    scal = np.stack([np.asarray(el.frequency, np.float32), C,
                     np.asarray(score.blend_length, np.float32),
                     np.asarray(score.has_sound).astype(np.float32)],
                    axis=-1)
    vec = np.stack([np.asarray(f, np.float32) for f in (
        el.formant_freq, el.formant_bw, el.formant_smooth,
        el.formant_breath, el.formant_turb, el.formant_amp)], axis=-2)

    def row(x):
        return np.broadcast_to(np.asarray(x, np.float32), (B,))

    dt = np.float32(1.0) / sr
    par = np.stack([row(jdf), row(jdff), row(jda), row(dt)], axis=-1)

    def edge_pad(x):
        x = np.asarray(x, np.float32)
        k = _MIN_LAT_ROWS - x.shape[1]
        if k > 0:
            x = np.concatenate([x, np.repeat(x[:, -1:], k, axis=1)], axis=1)
        return x

    def up(x, dt_=dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, dt_)

    latp, latf, lata = (edge_pad(x) for x in lattice)
    return FusedTables(n=up(n, torch.int32), scal=up(scal), vec=up(vec),
                       latp=up(latp), latf=up(latf), lata=up(lata),
                       par=up(par))


def _const_lane(x: np.float32, f: np.float32, n: int, out: np.ndarray):
    """n steps of the carrier at a constant increment f from x: the map
    x -> wrap(f32(x + f)) runs until a state repeats, and the cycle it
    found fills the rest. Returns the state after n steps."""
    one = np.float32(1.0)
    seen, seq = {}, []
    for i in range(n):
        key = float(x)
        if key in seen:
            start = seen[key]
            cyc = np.asarray(seq[start:], np.float32)
            out[i:n] = np.resize(cyc, n - i)
            return seq[start + (n - start) % len(cyc)]
        seen[key] = i
        seq.append(x)
        out[i] = x
        x = x + f
        if x >= one:
            x = x - one
    return x


def _carrier_lane(f: np.ndarray, x: np.float32):
    """The f32 carrier of one lane (see f32_carrier)."""
    T = len(f)
    out = np.empty(T, np.float32)
    one = np.float32(1.0)
    fast = f >= _FAST                     # a wrap every few samples
    # pieces: long runs of one increment, then the rest cut where `fast`
    # changes
    edges = np.flatnonzero(f[1:] != f[:-1]) + 1
    starts = np.concatenate([[0], edges])
    ends = np.concatenate([edges, [T]])
    long_ = ends - starts >= _CONST
    const = list(zip(starts[long_].tolist(), ends[long_].tolist()))
    pieces, t = [], 0
    for a, b in const + [(T, T)]:
        if a > t:
            sw = np.flatnonzero(fast[t + 1:a] != fast[t:a - 1]) + t + 1
            cuts = [t, *sw.tolist(), a]
            pieces += [("fast" if fast[c] else "runs", c, d)
                       for c, d in zip(cuts[:-1], cuts[1:])]
        if b > a:
            pieces.append(("const", a, b))
        t = b
    buf = np.empty(_RUN + 1, np.float32)
    for kind, a, b in pieces:
        if kind == "const":
            x = _const_lane(x, f[a], b - a, out[a:b])
        elif kind == "fast":
            # Python floats: the double sum of two float32 values in [0, 2)
            # is exact, and packing it as 'f' rounds it to float32 (to
            # nearest, ties to even), as the float32 add does
            xs, seg = float(x), []
            pack, unpack = _F32.pack, _F32.unpack
            for fi in f[a:b].tolist():
                seg.append(xs)
                xs = unpack(pack(xs + fi))[0]
                if xs >= 1.0:
                    xs -= 1.0
            out[a:b] = seg
            x = np.float32(xs)
        else:
            t = a
            while t < b:
                w = min(b - t, _RUN)
                buf[0] = x
                buf[1:w + 1] = f[t:t + w]
                cs = np.cumsum(buf[:w + 1], dtype=np.float32)
                hit = np.flatnonzero(cs[1:w + 1] >= one)
                k = int(hit[0]) + 1 if len(hit) else w
                out[t:t + k] = cs[:k]
                x = cs[k] - one if len(hit) else cs[w]
                t += k
    return out, np.float32(x)


def f32_carrier(freq: torch.Tensor, p0: np.ndarray):
    """The reference's f32 carrier over [B, T] from phases p0 (numpy f32
    [B]), the saw reading the pre-update phase, each lane on the host:
    where the increment is small, runs of sequential float32 adds
    (np.cumsum in float32) cut at each wrap, where the exact `- 1` starts
    the next run; where it wraps every few samples (silence's 0.25), one
    float32 step at a time; over a long run of one increment, the cycle
    that the steps fall into. Returns (phase [B, T] on freq's device,
    final phases)."""
    f = freq.detach().to("cpu", torch.float32).numpy()
    p0 = np.asarray(p0, np.float32)
    runs = [_carrier_lane(f[i], np.float32(p0[i])) for i in range(len(f))]
    track = np.stack([r[0] for r in runs])
    return (torch.from_numpy(track).to(freq.device),
            np.array([r[1] for r in runs], np.float32))


def q32_carrier(freq: torch.Tensor, p0: torch.Tensor):
    """Q32 fixed-point carrier over the last axis from the uint32 phase p0
    (int64); returns (phase f32 [..., T], final uint32 phase)."""
    fq = (freq.to(torch.float32) * _Q32).to(torch.int64)
    csum = torch.cumsum(fq, dim=-1)
    q = (p0[..., None] + csum - fq) & MASK32
    return q.to(torch.float32) * _INV_Q32, (p0 + csum[..., -1]) & MASK32


def _pick(c, nx, sil, a, om, v, hc, hn, bo):
    blend = c * a + nx * om
    out = torch.where(bo, blend, torch.where(
        hc, c, torch.where(hn, nx, torch.full_like(c, sil))))
    return torch.where(v, out, torch.full_like(c, sil))


def _rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    B, R = tab.shape[:2]
    flat = tab.reshape(B, R, -1)
    g = flat.gather(1, idx[..., None].expand(*idx.shape, flat.shape[-1]))
    return g.reshape(tuple(idx.shape) + tuple(tab.shape[2:]))


def _interleave(a, b):
    out = a.new_empty((a.shape[0] + b.shape[0],) + tuple(a.shape[1:]))
    out[0::2] = a
    out[1::2] = b
    return out


def associative_scan(combine, elems):
    """Inclusive scan along axis 0 with jax.lax.associative_scan's tree."""
    elems = tuple(elems)
    n = elems[0].shape[0]
    if n < 2:
        return elems
    odd = associative_scan(combine, combine(tuple(e[0:-1:2] for e in elems),
                                            tuple(e[1::2] for e in elems)))
    if n % 2 == 0:
        even = combine(tuple(e[:-1] for e in odd),
                       tuple(e[2::2] for e in elems))
    else:
        even = combine(odd, tuple(e[2::2] for e in elems))
    even = tuple(torch.cat([e[:1], r]) for e, r in zip(elems, even))
    return tuple(_interleave(a, b) for a, b in zip(even, odd))


def _affine_combine(x, y):
    ax, bx = x
    ay, by = y
    return ax * ay, ay * bx + by


def _svf_combine(x, y):
    x11, x12, x21, x22, xw1, xw2 = x
    y11, y12, y21, y22, yw1, yw2 = y
    return (y11 * x11 + y12 * x21, y11 * x12 + y12 * x22,
            y21 * x11 + y22 * x21, y21 * x12 + y22 * x22,
            y11 * xw1 + y12 * xw2 + yw1, y21 * xw1 + y22 * xw2 + yw2)


class ChainState(NamedTuple):
    """Carried per lane: Q32 phase (int64), f32 phase (numpy), Lehmer
    state (int64), lp / b / c rows [B, 8]."""

    q32: torch.Tensor
    f32: np.ndarray
    seed: torch.Tensor
    lp: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor

    @staticmethod
    def init(B: int, device, dtype) -> "ChainState":
        z = torch.zeros(B, NUM_FORMANTS, dtype=dtype, device=device)
        zi = torch.zeros(B, dtype=torch.int64, device=device)
        return ChainState(zi, np.zeros(B, np.float32), zi.clone(), z,
                          z.clone(), z.clone())


def chain_block(tables: FusedTables, start: int, phi: torch.Tensor,
                cell: torch.Tensor, state: ChainState, kcar: bool):
    """Samples start+1 .. start+L of every lane: (audio [B, L], state).
    (phi, cell) [L] is the shared jitter schedule of those samples."""
    dev, dtype = tables.scal.device, tables.scal.dtype
    n = tables.n
    B, E = n.shape
    L = phi.shape[0]
    W = tables.latp.shape[1]

    # ---- A: sequencer closed form ------------------------------------
    k1 = torch.arange(start + 1, start + L + 1, dtype=torch.int32,
                      device=dev).expand(B, L).contiguous()
    j = torch.searchsorted(n, k1)
    jc = j.clamp(max=E - 1)
    jn = (jc + 1).clamp(max=E - 1)
    has_next = jc < E - 1
    valid = (k1 >= 1) & (k1 <= n[:, E - 1:E])
    vm = valid.to(dtype)
    sc_c, sc_n = _rows(tables.scal, jc), _rows(tables.scal, jn)
    k1f = k1.to(dtype)
    dt = tables.par[:, 3:4]
    alf = ((sc_c[..., 1] - k1f * dt) / sc_c[..., 2]).clamp(0.0, 1.0)
    one_m = 1.0 - alf
    hs_c = sc_c[..., 3] > 0.5
    hs_n = (sc_n[..., 3] > 0.5) & has_next
    both = hs_c & hs_n
    fr_e = _pick(sc_c[..., 0], sc_n[..., 0], 0.25, alf, one_m, valid,
                 hs_c, hs_n, both)

    # ---- B: jitter from the shared schedule ----------------------------
    ph = phi.to(dtype).expand(B, L)
    ic = cell.to(torch.int64).clamp(0, W - 2).expand(B, L)
    pitch = (tables.latp.gather(1, ic) * (1.0 - ph)
             + tables.latp.gather(1, ic + 1) * ph) * vm
    freq_j = fr_e + pitch * tables.par[:, 0:1]

    vc, vn = _rows(tables.vec, jc), _rows(tables.vec, jn)
    a3, om3, v3 = alf[..., None], one_m[..., None], valid[..., None]
    hc3, hn3, bo3 = hs_c[..., None], hs_n[..., None], both[..., None]
    ff_e, bw_e, sm_e = (_pick(vc[:, :, i], vn[:, :, i], 0.25, a3, om3, v3,
                              hc3, hn3, bo3) for i in range(3))
    br_e, tb_e = (_pick(vc[:, :, i], vn[:, :, i], 0.0, a3, om3, v3,
                        hc3, hn3, bo3) for i in (3, 4))
    ac_, an_ = vc[:, :, 5], vn[:, :, 5]
    zero = torch.zeros_like(ac_)
    am_e = torch.where(v3, torch.where(bo3, ac_ * a3 + an_ * om3, torch.where(
        hc3, ac_ * a3, torch.where(hn3, an_ * om3, zero))), zero)
    del vc, vn, ac_, an_, zero
    ph3 = ph[..., None]
    fc, fnx = _rows(tables.latf, ic), _rows(tables.latf, ic + 1)
    form = fc + (fnx - fc) * ph3
    acl, anl = _rows(tables.lata, ic), _rows(tables.lata, ic + 1)
    ampn = acl + (anl - acl) * ph3
    jdff_m = (vm * tables.par[:, 1:2])[..., None]
    jda_m = (vm * (0.5 * tables.par[:, 2:3]))[..., None]
    ff_j = ff_e + form * jdff_m
    am_j = am_e * (1.0 - (ampn + 1.0) * jda_m)

    # ---- C: carrier, polyBLEP, noise, coefficients ---------------------
    q32, f32 = state.q32, state.f32
    if kcar:
        phase, f32 = f32_carrier(freq_j, state.f32)
        phase = phase.to(dtype)
    else:
        phase, q32 = q32_carrier(freq_j, state.q32)
        phase = phase.to(dtype)
    t0 = phase / freq_j
    first = 2.0 * t0 - t0 * t0 - 1.0
    t1 = (phase - 1.0) / freq_j
    last = t1 * t1 + 2.0 * t1 + 1.0
    pb = torch.where(phase < freq_j, first,
                     torch.where(phase > 1.0 - freq_j, last,
                                 torch.zeros_like(phase)))
    saw = (2.0 * phase - 1.0 - pb)[..., None]
    states = lehmer_block_states(state.seed, L)
    noise = random_f32_from_state(states).to(dtype)[..., None]
    seed = states[:, -1]

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

    def tm(t):  # [B, L, 8] -> [L, B, 8]
        return t.transpose(0, 1).contiguous()

    # ---- D: the recurrences as scans over time --------------------------
    #   lp' = alpha*lp + (1-alpha)*nw
    #   b'  = (2a1-1)*b - m21*c + m21*tamp*lp'
    #   c'  = m21*b + (1-2a3)*c + 2a3*tamp*lp'
    A, Bc = associative_scan(_affine_combine, (tm(alpha),
                                               tm((1.0 - alpha) * nw)))
    lp = A * state.lp + Bc                                   # [L, B, 8]
    m11, m21t, m22 = tm(2.0 * a1 - 1.0), tm(m21), tm(1.0 - 2.0 * a3c)
    w1, w2 = tm(m21 * tamp) * lp, tm((2.0 * a3c) * tamp) * lp
    c11, c12, c21, c22, cw1, cw2 = associative_scan(
        _svf_combine, (m11, -m21t, m21t, m22, w1, w2))
    b_post = c11 * state.b + c12 * state.c + cw1
    c_post = c21 * state.b + c22 * state.c + cw2
    b_pre = torch.cat([state.b[None], b_post[:-1]])
    y = b_post + b_pre
    acc = y[..., 0]
    for f in range(1, NUM_FORMANTS):
        acc = acc + y[..., f]
    audio = (acc * 0.25).transpose(0, 1) * vm
    return audio, ChainState(q32, f32, seed, lp[-1], b_post[-1], c_post[-1])
