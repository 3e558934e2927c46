// phase_q32_pre.cu — the overlap-save split's Q32 seam pre-pass for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `kern` inside
// grail_tpu/synth/kernel_fused.py::phase_q32_pre_block. Per utterance and
// 1024-sample chunk of samples 1..T it sums trunc(freq_j * 2^32) with
// wrapping uint32 adds, where freq_j is the fused synthesizer's own
// frequency stream (seq_freq.cuh, shared with fused_synth.cu). The caller
// takes the exclusive prefix sum over chunks, which gives the Q32 carrier
// phase at every block boundary: the exact initial phase of each split
// segment.
//
// What bounds it on this card: latency of the per-sample binary search and
// table loads, not bytes (a few KB of tables per utterance, an 8 B/sample
// schedule shared by all utterances, 4 B out per 1024 samples) and not
// FLOPs. The design is the simple one: one block of 256 threads per
// (chunk, utterance), so B * T / 1024 blocks fill the card at any batch
// size; each thread sums 4 samples, then a warp-shuffle reduction and a
// block reduction through shared memory give the chunk's sum. The sum is
// modular, so its order does not matter and the result is bit-exact.
//
// Numerics: built with -fmad=false and no fast math like fused_synth.cu, so
// freq_j and its Q32 conversion are bit for bit the synthesizer's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "seq_freq.cuh"

#define PRE_CHUNK 1024   // samples per chunk sum
#define PRE_THREADS 256  // threads per block

__global__ void __launch_bounds__(PRE_THREADS)
phase_q32_pre_kernel(const int* __restrict__ n,
                     const float* __restrict__ scal,
                     const float* __restrict__ latp,
                     const float* __restrict__ par,
                     const float* __restrict__ phi,
                     const int* __restrict__ cell,
                     uint32_t* __restrict__ sums, int E, int W, int T) {
  __shared__ uint32_t s_warp[PRE_THREADS / 32];
  const int c = blockIdx.x;   // chunk
  const int b = blockIdx.y;   // utterance
  const int t = threadIdx.x;
  const int* nb = n + (size_t)b * E;
  const float* scb = scal + (size_t)b * E * NSCAL;
  const float* lpb = latp + (size_t)b * W;
  const float jdf = par[b * 4 + 0];
  const float dt = par[b * 4 + 3];

  uint32_t acc = 0;
  for (int i = t; i < PRE_CHUNK; i += PRE_THREADS) {
    const int k = c * PRE_CHUNK + i;   // 0-based sample; k1 = k + 1
    const SeqFreq sq = seq_freq(k + 1, nb, scb, E, dt, lpb, W, jdf, phi[k],
                                cell[k]);
    acc += __float2uint_rz(sq.freq_j * 4294967296.0f);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((t & 31) == 0) s_warp[t >> 5] = acc;
  __syncthreads();
  if (t == 0) {
    uint32_t tot = 0;
#pragma unroll
    for (int w = 0; w < PRE_THREADS / 32; ++w) tot += s_warp[w];
    sums[(size_t)b * (T / PRE_CHUNK) + c] = tot;
  }
}

extern "C" {

// Launches one block per (chunk, utterance) on `stream`: sums [B][T / 1024]
// uint32. T must be a multiple of 1024 and B at most 65,535. Returns
// cudaGetLastError().
int grail_phase_q32_pre(const int* n, const float* scal, const float* latp,
                        const float* par, const float* phi, const int* cell,
                        uint32_t* sums, int B, int E, int W, int T,
                        void* stream) {
  const dim3 grid(T / PRE_CHUNK, B);
  phase_q32_pre_kernel<<<grid, PRE_THREADS, 0, (cudaStream_t)stream>>>(
      n, scal, latp, par, phi, cell, sums, E, W, T);
  return (int)cudaGetLastError();
}

int grail_phase_q32_pre_chunk(void) { return PRE_CHUNK; }

}  // extern "C"
