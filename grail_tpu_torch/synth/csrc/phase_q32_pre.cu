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
// What bounds it on this card: issue slots, not bytes. It reads a few KB of
// tables per utterance and an 8 B/sample schedule shared by every
// utterance (L2-resident across them), and writes 4 B per 1024 samples.
// The function needs ~23 operations a sample (~18 for the chain, a compare
// and a select that keep the element index, 3 for the Q32 sum), but
// the shared frequency chain compiles to some 80-90 instructions a sample:
// the IEEE division with its slow-path check, the 4-case pick's branches,
// six row and two lattice reads. On an H100 (benchmarks/kernels23_ab.py)
// a warp spends ~915 cycles a sample with ~12 warps per scheduler, ~76
// issue cycles each: 0.076 ms at B = 64, T = 360,448, a fifth of the
// operations bound. A branch-free walk (three compares a sample) and runs
// of 4 chunks measured slower.
//
// Design: the block first stages its utterance's element ends, scal rows
// and pitch lattice into shared memory. Each thread sums a contiguous run
// of samples: it searches the element index once, at its first sample, and
// walks it forward by comparison with the next end, which gives the count
// of ends below k1 that the search would, since the ends are
// non-decreasing. The schedule (phi, cell) is read 16 bytes at a time. A
// warp's sum is a shuffle reduction. When the batch gives many chunks
// (B = 64: 22,528), one warp sums a chunk, 32 samples a thread, and a block
// holds a run of 8 chunks (256 threads; the run halves while the grid
// would give fewer than 2 blocks per SM): the only barrier is the staging.
// When it gives few (B = 1, the 2 s "aea": 128), 2-8 warps share a chunk,
// down to 4 samples a thread, so that the card still holds ~8 warps per
// SM, and the warps' sums meet in shared memory after a second barrier.
// Tables larger than PRE_STAGE_MAX bytes (a lattice past ~12,000 cells,
// some 12 minutes of audio at 44.1 kHz) are read from global memory
// instead, by the same code.
//
// Numerics: built with -fmad=false and no fast math like fused_synth.cu, so
// freq_j and its Q32 conversion are bit for bit the synthesizer's. The sum
// is modular, so its order does not matter and the result is bit-exact.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "seq_freq.cuh"

#define PRE_CHUNK 1024               // samples per chunk sum
#define PRE_PER_THREAD (PRE_CHUNK / 32)   // samples a thread of one warp sums
#define PRE_MAX_WARPS 8              // warps per block at most
#define PRE_STAGE_MAX (48 * 1024)    // staged table bytes at most

// The element ends, scal rows and pitch lattice a block reads: staged in
// shared memory (STAGED) or the utterance's rows in global memory.
// A block sums `run` chunks with one warp each, or one chunk with `wpc`
// warps (wpc > 1 only with run == 1).
template <bool STAGED>
__global__ void __launch_bounds__(32 * PRE_MAX_WARPS)
phase_q32_pre_kernel(const int* __restrict__ n,
                     const float* __restrict__ scal,
                     const float* __restrict__ latp,
                     const float* __restrict__ par,
                     const float* __restrict__ phi,
                     const int* __restrict__ cell,
                     uint32_t* __restrict__ sums, int E, int W, int T,
                     int run, int wpc, int vec) {
  extern __shared__ __align__(16) float s_tab[];
  __shared__ uint32_t s_part[PRE_MAX_WARPS];
  const int b = blockIdx.y;
  const int nc = T / PRE_CHUNK;
  const int w = threadIdx.x >> 5;
  const int c = blockIdx.x * run + w / wpc;   // this warp's chunk
  const int lane = threadIdx.x & 31;
  const int* nb = n + (size_t)b * E;
  const float* scb = scal + (size_t)b * E * NSCAL;
  const float* lpb = latp + (size_t)b * W;
  if (STAGED) {
    float* s_scal = s_tab;                    // [E][NSCAL]
    float* s_lat = s_scal + E * NSCAL;        // [W]
    int* s_n = (int*)(s_lat + W);             // [E]
    for (int i = threadIdx.x; i < E * NSCAL; i += blockDim.x)
      s_scal[i] = scb[i];
    for (int i = threadIdx.x; i < W; i += blockDim.x) s_lat[i] = lpb[i];
    for (int i = threadIdx.x; i < E; i += blockDim.x) s_n[i] = nb[i];
    __syncthreads();
    nb = s_n;
    scb = s_scal;
    lpb = s_lat;
  }
  if (c >= nc) return;   // the last run's missing chunks (wpc == 1)
  const float jdf = par[b * 4 + 0];
  const float dt = par[b * 4 + 3];

  const int per = PRE_PER_THREAD / wpc;   // this thread's samples
  const int k0 = c * PRE_CHUNK + ((w % wpc) * 32 + lane) * per;   // 0-based
  int lo = elem_index(k0 + 1, nb, E);
  int next = lo < E ? nb[lo] : INT_MAX;   // the end the walk compares with
  uint32_t acc = 0;
#pragma unroll 2
  for (int j = 0; j < per; j += 4) {
    float ph[4];
    int ce[4];
    if (vec) {
      const float4 p = *reinterpret_cast<const float4*>(phi + k0 + j);
      const int4 q = *reinterpret_cast<const int4*>(cell + k0 + j);
      ph[0] = p.x; ph[1] = p.y; ph[2] = p.z; ph[3] = p.w;
      ce[0] = q.x; ce[1] = q.y; ce[2] = q.z; ce[3] = q.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ph[i] = phi[k0 + j + i];
        ce[i] = cell[k0 + j + i];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k1 = k0 + j + i + 1;
      while (next < k1) {   // the count of ends below k1
        ++lo;
        next = lo < E ? nb[lo] : INT_MAX;
      }
      const SeqFreq sq = seq_freq_at(k1, lo, nb, scb, E, dt, lpb, W, jdf,
                                     ph[i], ce[i]);
      acc += __float2uint_rz(sq.freq_j * 4294967296.0f);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if (wpc == 1) {
    if (lane == 0) sums[(size_t)b * nc + c] = acc;
    return;
  }
  if (lane == 0) s_part[w] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t tot = 0;
    for (int i = 0; i < wpc; ++i) tot += s_part[i];
    sums[(size_t)b * nc + c] = tot;
  }
}

// The launch geometry for B utterances of T samples, E elements and W
// lattice cells on the current device: warps per chunk (`wpc`, 1-8) while
// the chunks give fewer than 8 warps per SM, else chunks per block (`run`,
// 8 halving while the grid gives fewer than 2 blocks per SM), the grid and
// the staged bytes (0: the tables are read from global memory).
static cudaError_t pre_geometry(int B, int E, int W, int T, int* run,
                                int* wpc, dim3* grid, size_t* smem) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int nc = T / PRE_CHUNK;
  const long long chunks = (long long)B * nc;
  int q = 1, r = 1;
  while (q < PRE_MAX_WARPS && chunks * q < 8LL * sms) q <<= 1;
  if (q == 1) {
    r = PRE_MAX_WARPS;
    while (r > 1 && (long long)B * ((nc + r - 1) / r) < 2LL * sms) r >>= 1;
  }
  *run = r;
  *wpc = q;
  *grid = dim3((nc + r - 1) / r, B);
  const size_t bytes = ((size_t)E * (NSCAL + 1) + W) * 4;
  *smem = bytes <= PRE_STAGE_MAX ? bytes : 0;
  return cudaSuccess;
}

extern "C" {

// Launches one block per (run of chunks, utterance) on `stream`: sums
// [B][T / 1024] uint32. T must be a multiple of 1024 and B at most 65,535.
// Returns cudaGetLastError() (or the error of the device query).
int grail_phase_q32_pre(const int* n, const float* scal, const float* latp,
                        const float* par, const float* phi, const int* cell,
                        uint32_t* sums, int B, int E, int W, int T,
                        void* stream) {
  int run, wpc;
  dim3 grid;
  size_t smem;
  const cudaError_t err =
      pre_geometry(B, E, W, T, &run, &wpc, &grid, &smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = ((uintptr_t)phi % 16 == 0) && ((uintptr_t)cell % 16 == 0);
  const int threads = 32 * run * wpc;
  if (smem)
    phase_q32_pre_kernel<true><<<grid, threads, smem, (cudaStream_t)stream>>>(
        n, scal, latp, par, phi, cell, sums, E, W, T, run, wpc, vec);
  else
    phase_q32_pre_kernel<false><<<grid, threads, 0, (cudaStream_t)stream>>>(
        n, scal, latp, par, phi, cell, sums, E, W, T, run, wpc, vec);
  return (int)cudaGetLastError();
}

int grail_phase_q32_pre_chunk(void) { return PRE_CHUNK; }

// What grail_phase_q32_pre launches for these sizes on the current device:
// blocks, threads per block, dynamic shared bytes (0: the tables are not
// staged) and the compiled kernel's registers per thread. Returns 0 or a
// CUDA error.
int grail_phase_q32_pre_geometry(int B, int E, int W, int T, int* blocks,
                                 int* threads, int* smem, int* regs) {
  int run, wpc;
  dim3 grid;
  size_t bytes;
  cudaError_t err = pre_geometry(B, E, W, T, &run, &wpc, &grid, &bytes);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = bytes ? cudaFuncGetAttributes(&attr, phase_q32_pre_kernel<true>)
              : cudaFuncGetAttributes(&attr, phase_q32_pre_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  *blocks = (int)(grid.x * grid.y);
  *threads = 32 * run * wpc;
  *smem = (int)bytes;
  *regs = attr.numRegs;
  return 0;
}

}  // extern "C"
