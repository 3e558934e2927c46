// kcar_seam.cu — the exact carrier's seam pre-pass for the overlap-save
// split, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. grail_tpu never splits its exact carrier: its
// in-kernel f32 recurrence (kcar) runs one lane per utterance, because a
// segment of the split has no phase to start from. This kernel gives it
// one, as phase_q32_pre.cu does for the Q32 carrier. Per utterance it steps
// the reference's f32 carrier (src/lib.rs:520-525) in kernel 1's order,
//
//     pre-update phase read; p = p + f; if (p >= 1) p = p - 1,
//
// from phase 0 before sample 1, over the fused chain's own frequency stream
// (seq_freq.cuh, the call fused_synth.cu makes at every sample), and writes
// the phase after first + i * stride steps, i < count: the split's segment
// starts g0 = s * Ts - W, s = 1 .. S - 1. A split kcar lane that starts
// there (si column 2) steps the same frequencies in the same order as the
// unsplit lane, so its carrier is the unsplit lane's bit for bit. It steps
// only as far as the last seam.
//
// What bounds it on this card: neither bytes (8 a sample of a schedule that
// every utterance shares, L2-resident across the blocks) nor operations
// (~80-90 instructions a sample for the frequency, parallel over samples),
// but the dependent chain: the last seam's depth times the latency of a
// step. Stepped as written, a step is three dependent instructions (the
// add, the compare, the select of p - 1).
//
// Design: one block per utterance. Four producer warps compute the
// frequencies ahead of the chain into a ring of four 2,048-sample buffers
// in shared memory, each thread every 128th sample, its element index
// searched once and then walked forward by comparison (the ends are
// non-decreasing), as phase_q32_pre.cu walks it; with each warp's 32
// frequencies they store two bit masks (a ballot each): which are exactly
// 0.25, which are not >= 0. One thread of a fifth warp, the walker, steps
// the chain from the ring, the next 16 frequencies loaded (16 B at a time)
// while 16 steps compute. Named barriers hand each buffer over ("full":
// producers arrive, walker waits; "empty": the other way), as in
// fused_synth.cu. The walker takes 16 steps at a time in one of three
// ways, each exact, with one branch a group on the common paths:
//   * rising: no frequency below 0 and no seam inside: the 16 adds alone,
//     one dependent add a step, kept when the last sum is below 1; with
//     f >= 0 every partial sum is then below 1 too (rounding is monotone),
//     so no step wraps and the adds are the steps;
//   * still: all 16 frequencies exactly 0.25 (the silence the sequencer
//     gives before sample 1 and past an utterance's end, where a short
//     utterance of the batch spends much of its walk) and p in [0, 1) on
//     the 2^-23 grid: every add and every subtract is then exact, so the
//     16 steps add exactly 4, wrap four times and leave p as it was; the
//     test is two dependent adds and a compare, beside the adds;
//   * otherwise (a wrap, silence inside speech, where f is 0.25 plus the
//     jitter): one step at a time; and where a seam lies inside or at the
//     ragged end, one step at a time recording p when the step count
//     reaches a seam.
// At the sentences mix's shape (64 utterances to ~131 s, S = 8: a depth of
// 5.07 M steps) it measured 5.2 ns a step on an H100, against 14.5 with
// every step taken one at a time as written above (PERF.md).
//
// Numerics: built with -fmad=false and no fast math like fused_synth.cu, so
// freq_j is bit for bit kernel 1's, and every add and subtract is one IEEE
// round-to-nearest f32 operation (__fadd_rn, __fsub_rn), as kernel 1's.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "seq_freq.cuh"

#define SEAM_CHUNK 2048                    // samples per ring buffer
#define SEAM_RING 4                        // ring buffers
#define SEAM_PROD (4 * 32)                 // producer threads (warps 0-3)
#define SEAM_THREADS (SEAM_PROD + 32)      // + the walker's warp
#define SEAM_PER (SEAM_CHUNK / SEAM_PROD)  // a producer's samples a buffer
#define SEAM_GROUP 16                      // steps the walker takes together
#define SEAM_WORDS (SEAM_CHUNK / 32)       // mask words per buffer

// named barriers (0 is __syncthreads): per ring buffer its "full" and
// "empty" hand-over
#define BAR_FULL 1
#define BAR_EMPTY (1 + SEAM_RING)

static __device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

static __device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// SEAM_GROUP steps of f from p, one at a time, with no branch: the add,
// then the subtract of 1 or 0 by the compare. p - 0 is p (also -0 and
// NaN), so this is kernel 1's step; on an H100 it measured 10.4 ns a step
// against 14.5 for a select of p - 1 (PERF.md).
static __device__ __forceinline__ float step_group(
    float p, const float (&f)[SEAM_GROUP]) {
#pragma unroll
  for (int i = 0; i < SEAM_GROUP; ++i) {
    p = __fadd_rn(p, f[i]);
    p = __fsub_rn(p, p >= 1.f ? 1.f : 0.f);
  }
  return p;
}

// The first m (<= SEAM_GROUP) steps of f from p, one at a time, as kernel 1
// takes them; whenever the step count k + i reaches the next seam ns, p is
// written to ob[si * B] and ns moves on to seam si + 1.
static __device__ __forceinline__ float step_each(
    float p, const float (&f)[SEAM_GROUP], int k, int m, int& ns, int& si,
    int first, int stride, int count, float* __restrict__ ob, int B) {
#pragma unroll
  for (int i = 0; i < SEAM_GROUP; ++i) {
    if (i < m) {
      if (k + i == ns) {
        ob[(size_t)si * B] = p;
        ++si;
        ns = si < count ? first + si * stride : INT_MAX;
      }
      p = __fadd_rn(p, f[i]);
      if (p >= 1.f) p = __fsub_rn(p, 1.f);
    }
  }
  return p;
}

__global__ void __launch_bounds__(SEAM_THREADS)
kcar_seam_kernel(const int* __restrict__ n, const float* __restrict__ scal,
                 const float* __restrict__ latp,
                 const float* __restrict__ par,
                 const float* __restrict__ phi, const int* __restrict__ cell,
                 float* __restrict__ out, int B, int E, int W, int first,
                 int stride, int count) {
  __shared__ __align__(16) float ring[SEAM_RING][SEAM_CHUNK];
  // per buffer and 32 samples, a bit a sample: exactly 0.25; not >= 0
  __shared__ uint32_t s_quarter[SEAM_RING][SEAM_WORDS];
  __shared__ uint32_t s_below[SEAM_RING][SEAM_WORDS];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int L = first + (count - 1) * stride;   // steps walked: the last seam
  const int nch = (L + SEAM_CHUNK - 1) / SEAM_CHUNK;

  if (t >= SEAM_PROD) {
    // ---- the walker's warp: lane 0 steps the chain ---------------------
    const int lane = t - SEAM_PROD;
    float p = 0.f;
    int si = 0;
    int ns = first;   // the step count of the next seam
    float* ob = out + b;
    for (int c = 0; c < nch; ++c) {
      const int slot = c % SEAM_RING;
      bar_sync(BAR_FULL + slot, SEAM_THREADS);
      if (lane == 0) {
        const float4* r4 = reinterpret_cast<const float4*>(ring[slot]);
        const int base = c * SEAM_CHUNK;
        const int nst = min(SEAM_CHUNK, L - base);   // steps in this buffer
        float4 x0 = r4[0], x1 = r4[1], x2 = r4[2], x3 = r4[3];
#pragma unroll 2
        for (int j = 0; j < nst; j += SEAM_GROUP) {
          const float f[SEAM_GROUP] = {x0.x, x0.y, x0.z, x0.w,
                                       x1.x, x1.y, x1.z, x1.w,
                                       x2.x, x2.y, x2.z, x2.w,
                                       x3.x, x3.y, x3.z, x3.w};
          // the next group's frequencies, loaded while these steps compute
          const int jn =
              (j + SEAM_GROUP < SEAM_CHUNK ? j + SEAM_GROUP : j) / 4;
          x0 = r4[jn];
          x1 = r4[jn + 1];
          x2 = r4[jn + 2];
          x3 = r4[jn + 3];
          const int k = base + j;
          const int m = min(SEAM_GROUP, nst - j);
          // what does not depend on p: a whole group with no seam inside;
          // its frequencies' bits, all exactly 0.25, none below 0
          const bool whole = m == SEAM_GROUP && k + SEAM_GROUP <= ns;
          const uint32_t all = (1u << SEAM_GROUP) - 1u;
          const uint32_t quarter = (s_quarter[slot][j >> 5] >> (j & 31)) & all;
          const uint32_t below = (s_below[slot][j >> 5] >> (j & 31)) & all;
          // rising: the adds alone; still: p on the 2^-23 grid in [0, 1)
          float a = p;
#pragma unroll
          for (int i = 0; i < SEAM_GROUP; ++i) a = __fadd_rn(a, f[i]);
          const bool rising = below == 0u && a < 1.f;
          const bool still = quarter == all && p >= 0.f && p < 1.f &&
                             __fsub_rn(__fadd_rn(p, 1.f), 1.f) == p;
          const float pn = rising ? a : p;
          if (whole && (rising || still))
            p = pn;
          else if (whole)
            p = step_group(p, f);
          else
            p = step_each(p, f, k, m, ns, si, first, stride, count, ob, B);
        }
      }
      __syncwarp();
      // the producers wait for this buffer only if a buffer c + RING follows
      if (c + SEAM_RING < nch) bar_arrive(BAR_EMPTY + slot, SEAM_THREADS);
    }
    if (lane == 0)
      for (; si < count; ++si) ob[(size_t)si * B] = p;   // the seams at L
    return;
  }

  // ---- the producers: the frequency of every sample up to L -------------
  const int* nb = n + (size_t)b * E;
  const float* scb = scal + (size_t)b * E * NSCAL;
  const float* lpb = latp + (size_t)b * W;
  const float jdf = par[b * 4 + 0];
  const float dt = par[b * 4 + 3];
  int lo = elem_index(t + 1, nb, E);
  int next = lo < E ? nb[lo] : INT_MAX;   // the end the walk compares with
  for (int c = 0; c < nch; ++c) {
    const int slot = c % SEAM_RING;
    if (c >= SEAM_RING) bar_sync(BAR_EMPTY + slot, SEAM_THREADS);
#pragma unroll 2
    for (int i = 0; i < SEAM_PER; ++i) {
      const int j = i * SEAM_PROD + t;   // the sample's place in the buffer
      const int kk = c * SEAM_CHUNK + j;   // 0-based sample
      float f = 0.f;
      if (kk < L) {
        const int k1 = kk + 1;
        while (next < k1) {   // the count of ends below k1
          ++lo;
          next = lo < E ? nb[lo] : INT_MAX;
        }
        f = seq_freq_at(k1, lo, nb, scb, E, dt, lpb, W, jdf, phi[kk],
                        cell[kk]).freq_j;
      }
      ring[slot][j] = f;
      const uint32_t quarter = __ballot_sync(0xffffffffu, f == 0.25f);
      const uint32_t below = __ballot_sync(0xffffffffu, !(f >= 0.f));
      if ((t & 31) == 0) {
        s_quarter[slot][j >> 5] = quarter;
        s_below[slot][j >> 5] = below;
      }
    }
    bar_arrive(BAR_FULL + slot, SEAM_THREADS);
  }
}

extern "C" {

// Launches one block per utterance on `stream`: out [count][B] f32, the
// carrier phase after first + i * stride steps (i < count) of each
// utterance's f32 recurrence from phase 0. phi/cell hold the schedule of
// samples 1 .. first + (count - 1) * stride at least. The wrapper checks
// B >= 1, count >= 1, first >= 0, stride >= 1 and that the last seam fits
// in an int. Returns cudaGetLastError().
int grail_kcar_seam(const int* n, const float* scal, const float* latp,
                    const float* par, const float* phi, const int* cell,
                    float* out, int B, int E, int W, int first, int stride,
                    int count, void* stream) {
  kcar_seam_kernel<<<B, SEAM_THREADS, 0, (cudaStream_t)stream>>>(
      n, scal, latp, par, phi, cell, out, B, E, W, first, stride, count);
  return (int)cudaGetLastError();
}

}  // extern "C"
