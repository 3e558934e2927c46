"""The formant-synthesis DSP core (grail-rs src/lib.rs:467-600),
counterpart of grail_tpu/synth/synthesize.py.

Per sample the reference runs a polyBLEP anti-aliased saw carrier, a white-
noise breath blend, a one-pole lowpass, turbulence and amplitude, and a bank
of 8 SVF resonators (cytomic SvfLinearTrapOptimised2), summed and halved.
Three implementations of it live in the port: the fused kernel (synth/
kernel_fused.py), the round-1 core (synth/kernel.py) and the two here,
grail_tpu's `xla` and `scan` cores:

  * `synthesize_block` / `_block_core` — the parallel block: the Q32 carrier
    (`carrier_phase`, or an exact f32 track), closed-form Lehmer noise
    (`block_noise`), and the one-pole and SVF recurrences as affine
    associative scans (`affine_scan_cum`, `svf_scan_cum`). torch has no
    associative scan: `associative_scan` is JAX's odd/even recursion written
    out (pairs combined, the half scanned, the evens combined, interleaved),
    so the same tree rounds the same way;
  * `synthesize_scan` — one step per sample of the recurrent part (carrier,
    one-pole, SVF) in the reference's operation order; the elementwise
    streams (noise, alpha, turbulence, SVF coefficients) are computed for
    the whole block first, which rounds the same. grail_tpu's slow
    reference core; a Python loop here, on the card too.

The carrier's f32 recurrence (`carrier_scan`) is the kernel synth/csrc/
seq_scan.cu on a CUDA tensor and a plain loop on a CPU tensor
(synth/seq_scan.py). Everything else here is plain PyTorch on whichever
device its inputs lie, as grail_tpu runs it outside any Pallas kernel.

Time-major layouts follow the JAX functions: frames [T, B(, 8)], the state
[B(, 8)]. `q32_carrier`, `_polyblep` and `_svf_coeffs` are shared with the
other cores.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.approx import exp_approx, tan_approx
from ..core.constants import NUM_FORMANTS
from ..core.rng import MASK32, lehmer_block_states, random_f32_from_state
from .seq_scan import carrier_scan

_Q32 = 4294967296.0          # 2^32
_INV_Q32 = 1.0 / 4294967296.0


class SynthState(NamedTuple):
    """Per-utterance carried state. `seed` holds the uint32 Lehmer state as
    int64 in [0, 2^32)."""

    phase: torch.Tensor           # [B] f32 carrier phase
    filter_state_a: torch.Tensor  # [B, 8] one-pole lowpass
    filter_state_b: torch.Tensor  # [B, 8] SVF ic1eq
    filter_state_c: torch.Tensor  # [B, 8] SVF ic2eq
    seed: torch.Tensor            # [B] int64 noise state

    @staticmethod
    def init(batch: int, device) -> "SynthState":
        """Reference IntoSynthesize::synthesize init (src/lib.rs:587-596)."""
        z8 = torch.zeros(batch, NUM_FORMANTS, dtype=torch.float32,
                         device=device)
        return SynthState(
            phase=torch.zeros(batch, dtype=torch.float32, device=device),
            filter_state_a=z8, filter_state_b=z8.clone(),
            filter_state_c=z8.clone(),
            seed=torch.zeros(batch, dtype=torch.int64, device=device))


def _polyblep(phase, f):
    """Anti-aliasing offset for the saw discontinuity (src/lib.rs:503-514)."""
    t0 = phase / f
    first = 2.0 * t0 - t0 * t0 - 1.0
    t1 = (phase - 1.0) / f
    last = t1 * t1 + 2.0 * t1 + 1.0
    return torch.where(phase < f, first,
                       torch.where(phase > 1.0 - f, last,
                                   torch.zeros_like(phase)))


def _svf_coeffs(elem):
    """SVF coefficients (a1, a2, a3) of the cytomic trapezoidal resonator
    from the formant frequency and bandwidth fields."""
    g = tan_approx(elem.formant_freq)
    k = elem.formant_bw / elem.formant_freq
    a1 = 1.0 / (1.0 + g * (g + k))
    a2 = g * a1
    a3 = g * a2
    return a1, a2, a3


def q32_carrier(freq: torch.Tensor, p0: torch.Tensor):
    """Q32 fixed-point carrier phase over the last axis: the exclusive
    prefix sum of trunc(f * 2^32) from the uint32 phase `p0` (int64 [...]),
    mod 2^32, as f32 in [0, 1). Returns (phase f32 [..., T], final uint32
    phase int64 [...]). torch has no uint32 cumsum, so the sum runs in int64
    and is masked to 32 bits; the u32 -> f32 conversion rounds to nearest
    even, as numpy's does."""
    fq = (freq * _Q32).to(torch.int64)         # exact scale, then truncate
    csum = torch.cumsum(fq, dim=-1)
    q = (p0[..., None] + csum - fq) & MASK32
    return q.to(torch.float32) * _INV_Q32, (p0 + csum[..., -1]) & MASK32


def carrier_phase(frequency: torch.Tensor, phase0: torch.Tensor):
    """Closed-form polyBLEP phase track over axis 0 (time): frequency
    [T, ...], phase0 f32 [...]. Returns (phase [T, ...], phase_out [...]),
    both f32. The accumulator is Q32 fixed point, so uint32 wraparound is
    the mod 1, exactly; the returned phase_out is rounded to f32, as
    grail_tpu's carrier_phase returns it (chained blocks round there)."""
    p0q = (torch.remainder(phase0, 1.0) * _Q32).to(torch.int64)
    phase, qf = q32_carrier(frequency.movedim(0, -1), p0q)
    return phase.movedim(-1, 0), qf.to(torch.float32) * _INV_Q32


def block_noise(seed0: torch.Tensor, T: int):
    """Lehmer noise [T, ...] continuing from the int64-held uint32 state
    `seed0` [...]; returns (noise f32 [T, ...], last state [...])."""
    states = lehmer_block_states(seed0, T)                    # [..., T]
    return (random_f32_from_state(states).movedim(-1, 0),
            states[..., -1])


def _sample_v0(elem, saw, noise, state_a):
    """Shared per-sample front half: breath blend, lowpass input,
    turbulence, amplitude. Returns (v0, new_state_a)."""
    breath = elem.formant_breath
    noise_wave = saw * (1.0 - breath) + noise * breath
    alpha = exp_approx(elem.formant_smooth)
    new_a = state_a + (1.0 - alpha) * (noise_wave - state_a)
    turb = (1.0 - elem.formant_turb) + noise * elem.formant_turb
    v0 = (new_a * turb) * elem.formant_amp
    return v0, new_a


# ---------------------------------------------------------------------------
# Associative scans
# ---------------------------------------------------------------------------

def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along axis 0 (len(a) - len(b) in {0, 1})."""
    out = a.new_empty((a.shape[0] + b.shape[0],) + tuple(a.shape[1:]))
    out[0::2] = a
    out[1::2] = b
    return out


def associative_scan(combine, elems):
    """Inclusive scan of the tuple of tensors `elems` along axis 0 under the
    associative `combine(earlier, later)`, with the combination tree of
    jax.lax.associative_scan: combine adjacent pairs, scan the half by
    recursion (the odd outputs), combine each odd output with the next even
    input (the even outputs), interleave. Strided slices and one interleave
    per level; a Hillis-Steele doubling scan would round another tree."""
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


def affine_scan_cum(a, b):
    """Cumulative transfer operators of s_k = a_k * s_{k-1} + b_k: returns
    (A_k, B_k) with s_k = A_k * s_0 + B_k. Composition of (a2, b2) after
    (a1, b1) is (a2*a1, a2*b1 + b2), over axis 0 (time)."""
    return associative_scan(_affine_combine, (a, b))


def _affine_scan(a, b, s0):
    """Inclusive scan of s_k = a_k * s_{k-1} + b_k from the state s0."""
    A, B = affine_scan_cum(a, b)
    return A * s0 + B


def _svf_combine(x, y):
    x11, x12, x21, x22, xw1, xw2 = x
    y11, y12, y21, y22, yw1, yw2 = y
    z11 = y11 * x11 + y12 * x21
    z12 = y11 * x12 + y12 * x22
    z21 = y21 * x11 + y22 * x21
    z22 = y21 * x12 + y22 * x22
    zw1 = y11 * xw1 + y12 * xw2 + yw1
    zw2 = y21 * xw1 + y22 * xw2 + yw2
    return z11, z12, z21, z22, zw1, zw2


def svf_scan_cum(m11, m12, m21, m22, w1, w2):
    """Cumulative transfer operators of the 2-state recurrence S_k = M_k
    S_{k-1} + w_k: returns the 6-tuple (M_k^cum..., W_k^cum...) with
    S_k = M_k^cum S_0 + W_k^cum. Composition of (M, w) pairs: (My*Mx,
    My*wx + wy), the 2x2 products written out."""
    return associative_scan(_svf_combine, (m11, m12, m21, m22, w1, w2))


def _svf_scan(m11, m12, m21, m22, w1, w2, b0, c0):
    """Inclusive SVF scan from the state (b0, c0); returns the post-update
    states (b_k, c_k)."""
    c11, c12, c21, c22, cw1, cw2 = svf_scan_cum(m11, m12, m21, m22, w1, w2)
    return c11 * b0 + c12 * c0 + cw1, c21 * b0 + c22 * c0 + cw2


# ---------------------------------------------------------------------------
# The cores
# ---------------------------------------------------------------------------

def _block_core(elems, state: SynthState, carrier=None):
    """One fully parallel block: frames [T, B(, 8)] and the state -> (audio
    [T, B], new SynthState).

    `carrier` (optional f32 [T, B]): the exact f32 carrier phase per sample
    (a host track, or carrier_scan's) in place of the Q32 accumulator; the
    state's phase then passes through unchanged (callers that pass a track
    set the phase they need)."""
    T = elems.frequency.shape[0]
    f = elems.frequency
    if carrier is None:
        phase, phase_out = carrier_phase(f, state.phase)
    else:
        phase, phase_out = carrier, state.phase
    pb = _polyblep(phase, f)
    saw = (2.0 * phase - 1.0 - pb)[..., None]

    noise, seed_out = block_noise(state.seed, T)
    noise = noise[..., None]

    # one-pole lowpass: s' = alpha*s + (1-alpha)*x (an affine scan)
    breath = elems.formant_breath
    noise_wave = saw * (1.0 - breath) + noise * breath
    alpha = exp_approx(elems.formant_smooth)
    state_a = _affine_scan(alpha, (1.0 - alpha) * noise_wave,
                           state.filter_state_a)
    del noise_wave, saw

    turb = (1.0 - elems.formant_turb) + noise * elems.formant_turb
    v0 = (state_a * turb) * elems.formant_amp
    del turb

    # SVF bank: S_k = M_k S_{k-1} + u_k * v0_k with
    #   M = [[2a1-1, -2a2], [2a2, 1-2a3]],  u = [2a2, 2a3];
    # the output needs the PRE-update state: v1_k = a1*b_{k-1} +
    # a2*(v0_k - c_{k-1})
    a1, a2, a3 = _svf_coeffs(elems)
    m11 = 2.0 * a1 - 1.0
    m12 = -2.0 * a2
    m21 = 2.0 * a2
    m22 = 1.0 - 2.0 * a3
    b_post, c_post = _svf_scan(m11, m12, m21, m22, m21 * v0, 2.0 * a3 * v0,
                               state.filter_state_b, state.filter_state_c)
    del m11, m12, m21, m22

    b_pre = torch.cat([state.filter_state_b[None], b_post[:-1]])
    c_pre = torch.cat([state.filter_state_c[None], c_post[:-1]])
    v1 = a1 * b_pre + a2 * (v0 - c_pre)
    out = torch.sum(v1, dim=-1) * 0.5

    return out, SynthState(phase=phase_out, filter_state_a=state_a[-1],
                           filter_state_b=b_post[-1],
                           filter_state_c=c_post[-1], seed=seed_out)


def synthesize_block(elems, state=None, block_size: int = 4096):
    """Blocked parallel synthesis: frames [T, B(, 8)] -> (audio [T, B],
    state). A loop over blocks carries the state; within each block
    everything is parallel (_block_core). T must be a multiple of
    block_size, or at most block_size."""
    T, B = elems.frequency.shape[:2]
    if state is None:
        state = SynthState.init(B, elems.frequency.device)
    if T <= block_size:
        return _block_core(elems, state)
    if T % block_size:
        raise ValueError(f"T={T} not a multiple of block_size={block_size}")
    outs = []
    for i in range(0, T, block_size):
        out, state = _block_core(type(elems)(*(x[i:i + block_size]
                                               for x in elems)), state)
        outs.append(out)
    return torch.cat(outs), state


def synthesize_scan(elems, state=None, carrier=None):
    """One step per sample of the recurrent part, in the reference's
    operation order: frames [T, B(, 8)] -> (audio [T, B], state).

    The carrier phase is the reference's f32 recurrence from state.phase
    (carrier_scan), or the exact track `carrier` (f32 [T, B]) when given;
    the returned phase is then the post-update phase after the track's last
    sample. Noise, the polyBLEP saw, alpha, turbulence and the SVF
    coefficients are elementwise and computed for the whole block; the
    one-pole and SVF recurrences step sample by sample."""
    T, B = elems.frequency.shape[:2]
    dev = elems.frequency.device
    if state is None:
        state = SynthState.init(B, dev)
    f = elems.frequency
    if carrier is None:
        ph, phase = carrier_scan(state.phase, f)
    else:
        ph = carrier
        phase = ph[-1] + f[-1]
        phase = torch.where(phase >= 1.0, phase - 1.0, phase)
    saw = (2.0 * ph - 1.0 - _polyblep(ph, f))[..., None]
    noise, seed = block_noise(state.seed, T)
    noise = noise[..., None]
    breath = elems.formant_breath
    noise_wave = saw * (1.0 - breath) + noise * breath
    om = 1.0 - exp_approx(elems.formant_smooth)
    turb = (1.0 - elems.formant_turb) + noise * elems.formant_turb
    amp = elems.formant_amp
    a1, a2, a3 = _svf_coeffs(elems)

    xs = (noise_wave, om, turb, amp, a1, a2, a3, state.filter_state_a,
          state.filter_state_b, state.filter_state_c)
    if dev.type == "cpu":      # the same float32 ops, at numpy's call cost
        xs = tuple(x.numpy() for x in xs)
    noise_wave, om, turb, amp, a1, a2, a3, a, b, c = xs
    v1s = a1 * 0.0
    for i in range(T):
        a = a + om[i] * (noise_wave[i] - a)
        v3 = (a * turb[i]) * amp[i] - c
        v1 = a1[i] * b + a2[i] * v3
        v2 = c + a2[i] * b + a3[i] * v3
        b = 2.0 * v1 - b
        c = 2.0 * v2 - c
        v1s[i] = v1
    v1s, a, b, c = (torch.as_tensor(x, device=dev) for x in (v1s, a, b, c))
    out = torch.sum(v1s, dim=-1) * 0.5
    return out, SynthState(phase=phase, filter_state_a=a, filter_state_b=b,
                           filter_state_c=c, seed=seed)


__all__ = ["SynthState", "q32_carrier", "carrier_phase", "carrier_scan",
           "block_noise", "associative_scan", "affine_scan_cum",
           "svf_scan_cum", "synthesize_block", "synthesize_scan"]
