// seq_freq.cuh — the frequency chain shared by fused_synth.cu and
// phase_q32_pre.cu: the sequencer's closed form (element index by boundary
// count, cur/next rows, blend alpha, the 4-case pick) and the pitch jitter,
// for one 1-based absolute sample index k1 of one utterance.
//
// It comes in two parts: elem_index (the count of element ends below k1, a
// binary search) and seq_freq_at (everything after it, given that count).
// seq_freq is the two in a row, as fused_synth.cu calls it. phase_q32_pre.cu
// searches once per run of samples and then walks the count forward by
// comparison, which gives the same count because the ends are
// non-decreasing; both call the one seq_freq_at, so its rounding is the
// same in each.
//
// Counterpart of grail_tpu/synth/kernel_fused.py::_seq_chunk_core, which the
// JAX package shares between its two kernels for the same reason: the
// overlap-save split's segment seams are exact only if the pre-pass
// integrates the very frequency stream the synthesizer renders. Both kernels
// are built with -fmad=false, so this code rounds the same in each.

#pragma once

#include <stdint.h>

#define NSCAL 4  // scal row: frequency, cum_length, blend_length, has_sound

// The 4-case pick of the sequencer: the blend of cur and next when both
// sound, else whichever sounds, else the silent default; silent past the
// utterance's end.
static __device__ __forceinline__ float pick(float c, float n, float sil,
                                             float alf, float one_m,
                                             bool valid, bool hs_c,
                                             bool hs_n) {
  if (!valid) return sil;
  if (hs_c && hs_n) return c * alf + n * one_m;
  if (hs_c) return c;
  if (hs_n) return n;
  return sil;
}

struct SeqFreq {
  int jc, jn;        // current and next element rows
  bool valid;        // 1 <= k1 <= the utterance's last sample
  bool hs_c, hs_n;   // current / next element sounds
  float vm;          // valid as 0/1
  float alf, one_m;  // blend alpha and 1 - alpha
  int cl;            // lattice cell, clamped to [0, W-2]
  float freq_j;      // jittered carrier frequency (cycles per sample)
};

// The element index of 1-based sample k1: the count of the utterance's E
// end samples nb (non-decreasing) that lie below k1.
static __device__ __forceinline__ int elem_index(int k1,
                                                 const int* __restrict__ nb,
                                                 int E) {
  int lo = 0, hi = E;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (nb[mid] < k1) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The chain at sample k1 given its element index lo (elem_index). nb: the
// utterance's E int32 element end samples (non-decreasing); scb its
// [E][NSCAL] rows; lpb its W-row pitch lattice; (ph, cell) the exact jitter
// schedule at this sample.
static __device__ __forceinline__ SeqFreq seq_freq_at(
    int k1, int lo, const int* __restrict__ nb,
    const float* __restrict__ scb, int E, float dt,
    const float* __restrict__ lpb, int W, float jdf, float ph, int cell) {
  SeqFreq s;
  s.jc = min(lo, E - 1);
  s.jn = min(s.jc + 1, E - 1);
  const bool has_next = s.jc < E - 1;
  const float* rc = scb + s.jc * NSCAL;
  const float* rn = scb + s.jn * NSCAL;
  s.valid = (k1 >= 1) && (k1 <= nb[E - 1]);
  s.vm = s.valid ? 1.f : 0.f;
  const float k1f = (float)k1;
  s.alf = fminf(fmaxf((rc[1] - k1f * dt) / rc[2], 0.f), 1.f);
  s.one_m = 1.f - s.alf;
  s.hs_c = rc[3] > 0.5f;
  s.hs_n = (rn[3] > 0.5f) && has_next;
  const float fr_e = pick(rc[0], rn[0], 0.25f, s.alf, s.one_m, s.valid,
                          s.hs_c, s.hs_n);

  // pitch jitter: lattice cells cl and cl + 1, lerped by ph
  s.cl = min(max(cell, 0), W - 2);
  const float pitch = (lpb[s.cl] * (1.f - ph) + lpb[s.cl + 1] * ph) * s.vm;
  s.freq_j = fr_e + pitch * jdf;
  return s;
}

// The chain at sample k1: elem_index, then seq_freq_at.
static __device__ __forceinline__ SeqFreq seq_freq(int k1,
                                                   const int* __restrict__ nb,
                                                   const float* __restrict__ scb,
                                                   int E, float dt,
                                                   const float* __restrict__ lpb,
                                                   int W, float jdf, float ph,
                                                   int cell) {
  return seq_freq_at(k1, elem_index(k1, nb, E), nb, scb, E, dt, lpb, W, jdf,
                     ph, cell);
}
