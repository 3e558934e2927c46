"""Vectorized sequencer: Score -> per-sample SynthesisElem frames.

Counterpart of grail_tpu/synth/sequencer.py. The reference Sequencer
(grail-rs src/lib.rs:838-953) is a pull-based state machine, but given the
cumulative element end-times it is stateless: for the 1-based sample index
k1 of an utterance,

    j(k1)  = count of element end samples n_m < k1   (n_m = floor(C_m * sr))
    t      = C_j - k1 * dt                           (the reference's `time`)
    alpha  = clip(t / blend_length_j, 0, 1)

and the frame is a 4-case blend of elements j and j + 1. Samples outside
1 .. n_last are invalid: they get the silent frame and a false mask.

The JAX functions take one utterance and are vmapped; these take a batched
Score [B, E] of tensors (Score.to) and return [B, T, ...] frames, with a
per-lane `offset` ([B] ints, or one int): lane b renders samples
offset_b + 1 .. offset_b + T, so the overlap-save split runs its segments
(offset = s*Ts - WARMUP, negative for the first pre-roll) as lanes. The
one-hot matrix products that select element rows on the TPU are index
gathers here: a one-hot product at f32 HIGHEST selects exactly, so the
gather gives the same bits.

`expand_score` and `expand_frequency` share one `_selection_prelude`: the
split's seam phases integrate expand_frequency's stream, so it must equal
expand_score's frequency field bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .elem import SynthesisElem
from .score import Score

_SIL_FREQ = 0.25   # the reference's silent frame: 0.25 frequencies,
                   # zero breath, turbulence and amplitude


class _Prelude(NamedTuple):
    jc: torch.Tensor       # int64 [B, T] current element row
    jn: torch.Tensor       # int64 [B, T] next element row (clamped)
    a: torch.Tensor        # f32 [B, T] blend alpha
    one_m: torch.Tensor    # f32 [B, T] 1 - alpha
    hs_cur: torch.Tensor   # bool [B, T] current element sounds
    hs_nxt: torch.Tensor   # bool [B, T] next element sounds (and exists)
    valid: torch.Tensor    # bool [B, T] 1 <= k1 <= the last sample


def take(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of tab [B, R, ...] at idx [B, T] -> [B, T, ...]."""
    if tab.dim() == 2:
        return tab.gather(1, idx)
    flat = tab.reshape(tab.shape[0], tab.shape[1], -1)
    g = flat.gather(1, idx[..., None].expand(*idx.shape, flat.shape[-1]))
    return g.reshape(tuple(idx.shape) + tuple(tab.shape[2:]))


def _selection_prelude(score: Score, sample_rate, num_samples: int,
                       offset) -> _Prelude:
    """The per-sample selection shared by expand_score and
    expand_frequency: element rows by boundary count, blend alpha, sound
    flags and validity, for samples offset + 1 .. offset + num_samples."""
    C = score.cum_length                                     # [B, E] f32
    B, E = C.shape
    dev = C.device
    sr = float(np.float32(sample_rate))
    dt = float(np.float32(1.0) / np.float32(sample_rate))
    n = torch.floor(C * sr).to(torch.int32)                  # end samples

    T = int(num_samples)
    if isinstance(offset, torch.Tensor):      # one offset per lane
        k1 = (torch.arange(1, T + 1, dtype=torch.int32, device=dev)
              + offset.to(torch.int32)[:, None])
    else:
        k1 = torch.arange(int(offset) + 1, int(offset) + T + 1,
                          dtype=torch.int32, device=dev).expand(B, T)
    k1 = k1.contiguous()                                     # [B, T]
    valid = (k1 >= 1) & (k1 <= n[:, E - 1:E])   # k1 < 1: split pre-roll

    j = torch.searchsorted(n.contiguous(), k1)              # count(n < k1)
    jc = j.clamp(max=E - 1)
    has_next = (jc + 1) < E
    jn = (jc + 1).clamp(max=E - 1)

    s = k1.to(torch.float32) * dt
    t = C.gather(1, jc) - s                                  # reference `time`
    # lower clamp: f32(k1)*dt can round above the element's f32 end time
    # while the integer boundary test still selects the element, making t a
    # spurious -1 ulp; a zero-blend element's 1e-12 epsilon would blow that
    # up into a full-scale click. alpha = 0 (emit the next element) is the
    # benign corner.
    a = (t / score.blend_length.gather(1, jc)).clamp(0.0, 1.0)
    hs_cur = score.has_sound.gather(1, jc)
    hs_nxt = score.has_sound.gather(1, jn) & has_next
    return _Prelude(jc, jn, a, 1.0 - a, hs_cur, hs_nxt, valid)


def _pick(cur, nxt, sil: float, p: _Prelude, vec: bool):
    """The reference's 4-case match (src/lib.rs:891-931): lerp when both
    sound, else whichever sounds, else the silent default; silent where
    not valid."""
    a, om, hc, hn, v = p.a, p.one_m, p.hs_cur, p.hs_nxt, p.valid
    if vec:
        a, om, hc, hn, v = (x[..., None] for x in (a, om, hc, hn, v))
    both = cur * a + nxt * om
    fill = torch.full_like(cur, sil)
    out = torch.where(hc & hn, both,
                      torch.where(hc, cur, torch.where(hn, nxt, fill)))
    return torch.where(v, out, fill)


def expand_score(score: Score, sample_rate, num_samples: int, offset=0):
    """Per-sample frames of a batched Score: (SynthesisElem of [B, T(, 8)]
    f32 tensors, valid bool [B, T]) for samples offset + 1 .. offset + T of
    each lane. `offset` is one int or one per lane (an int tensor [B] on
    the score's device)."""
    p = _selection_prelude(score, sample_rate, num_samples, offset)
    el = score.elem
    fields = {"frequency": _pick(take(el.frequency, p.jc),
                                 take(el.frequency, p.jn), _SIL_FREQ, p,
                                 False)}
    for name, sil in (("formant_freq", _SIL_FREQ), ("formant_bw", _SIL_FREQ),
                      ("formant_smooth", _SIL_FREQ), ("formant_breath", 0.0),
                      ("formant_turb", 0.0)):
        tab = getattr(el, name)
        fields[name] = _pick(take(tab, p.jc), take(tab, p.jn), sil, p, True)

    # amplitude: lerp when both sound; fade out (amp*a) into a silent next;
    # fade in (amp*(1-a)) out of a silent cur; zero when both silent
    ac, an = take(el.formant_amp, p.jc), take(el.formant_amp, p.jn)
    af, om = p.a[..., None], p.one_m[..., None]
    mc, mn = p.hs_cur[..., None], p.hs_nxt[..., None]
    zero = torch.zeros_like(ac)
    amp = torch.where(mc & mn, ac * af + an * om,
                      torch.where(mc, ac * af,
                                  torch.where(mn, an * om, zero)))
    fields["formant_amp"] = torch.where(p.valid[..., None], amp, zero)
    return SynthesisElem(**fields), p.valid


def expand_frequency(score: Score, sample_rate, num_samples: int, offset=0):
    """Carrier frequency [B, T] and valid [B, T] only: expand_score's
    frequency field, from the same prelude and the same pick."""
    p = _selection_prelude(score, sample_rate, num_samples, offset)
    f = score.elem.frequency
    return _pick(take(f, p.jc), take(f, p.jn), _SIL_FREQ, p, False), p.valid


__all__ = ["expand_score", "expand_frequency", "take"]
