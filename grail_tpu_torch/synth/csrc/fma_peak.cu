// fma_peak.cu — the FP32 issue-rate probe for Hopper (sm_90a).
//
// Replaces benchmarks/vpu_peak.py::measure's `kernel` (the Pallas TPU kernel
// that the JAX package's roofline was held against). It computes what that
// kernel computes: every element of an f32 tile ([256, 8, 128] there), per
// grid step, is updated `iters` times by x = x * a + b, carried in
// registers, and the result is stored so that nothing folds away. Every grid
// step reads the same tile, as the TPU kernel's index map does; here each
// step's result is stored in its own row of out [grid, n], so that no two
// blocks write one address.
//
// What it is for: the kernels of this library are built with -fmad=false,
// so they issue a multiply and an add where a data sheet counts one fused
// multiply-add as two operations. The rate that bounds them is the card's
// peak FP32 instruction rate, half the data sheet's FLOP/s; this probe
// measures how close unfused instructions come to it (variant mul_add:
// __fmul_rn then __fadd_rn, which no flag can contract) beside the fused
// rate (variant fma: __fmaf_rn).
//
// What bounds it on this card: operations, by construction: 4 bytes in and
// 4 bytes out per element against 2 * iters instructions. The TPU's grid (8
// sequential steps over one core's vector unit) is not carried over. An SM
// has four schedulers, each issuing one warp instruction per cycle to 32
// FP32 lanes, and a dependent FP32 chain can issue only every ~4 cycles; so
// a block is 128 threads (one warp per scheduler) and each thread carries 4
// independent accumulators, which alone keep a scheduler's pipe full; up to
// 16 blocks are resident per SM on top of that. The grid * n elements are
// cut into blocks of 512 consecutive elements (thread t takes t, t + 128,
// t + 256, t + 384: coalesced), 4,096 blocks at the default shape, about 31
// per SM, handed out as blocks finish, so that all 132 SMs stay busy until
// the last percent of the run. The loop is unrolled 16 times: its counter
// and branch issue from the same schedulers and would otherwise take a
// share of the slots.

#include <cuda_runtime.h>

#define FP_THREADS 128   // one warp per scheduler
#define FP_ACC 4         // independent accumulators per thread

template <bool FMA>
__global__ void __launch_bounds__(FP_THREADS)
fma_peak_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                int iters, float a, float b) {
  const size_t base = (size_t)blockIdx.x * (FP_THREADS * FP_ACC) + threadIdx.x;
  float v[FP_ACC];
#pragma unroll
  for (int j = 0; j < FP_ACC; ++j)
    v[j] = x[(base + (size_t)j * FP_THREADS) % (size_t)n];
#pragma unroll 16
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < FP_ACC; ++j)
      v[j] = FMA ? __fmaf_rn(v[j], a, b) : __fadd_rn(__fmul_rn(v[j], a), b);
  }
#pragma unroll
  for (int j = 0; j < FP_ACC; ++j) out[base + (size_t)j * FP_THREADS] = v[j];
}

extern "C" {

// out [grid, n] <- `iters` updates of x [n] per grid step, on `stream`.
// grid * n must be a multiple of grail_fma_peak_block(). fma != 0 issues
// one fused multiply-add per update, fma == 0 a multiply and an add.
// Returns cudaGetLastError().
int grail_fma_peak(const float* x, float* out, int n, int grid, int iters,
                   float a, float b, int fma, void* stream) {
  const unsigned blocks =
      (unsigned)(((size_t)grid * n) / (FP_THREADS * FP_ACC));
  if (fma)
    fma_peak_kernel<true><<<blocks, FP_THREADS, 0, (cudaStream_t)stream>>>(
        x, out, n, iters, a, b);
  else
    fma_peak_kernel<false><<<blocks, FP_THREADS, 0, (cudaStream_t)stream>>>(
        x, out, n, iters, a, b);
  return (int)cudaGetLastError();
}

// elements per block: grid * n must be a multiple of it
int grail_fma_peak_block(void) { return FP_THREADS * FP_ACC; }

}  // extern "C"
