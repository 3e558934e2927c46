// seq_scan.cu — the two sequential f32 recurrences of the xla core and the
// xla tick, for Hopper (sm_90a).
//
// Not a port of a Pallas kernel: grail_tpu runs these as lax.scan loops
// outside any kernel, and they cannot be reassociated, since each step
// rounds (the reference's phase accumulators are f32, src/lib.rs:236-249,
// 520-525). As a loop of torch ops they would cost ~4-6 launches a sample.
//
//  * carrier_scan_kernel replaces grail_tpu/synth/synthesize.py::
//    carrier_scan (:182): per lane `pre = p; p = p + f; if (p >= 1) p -= 1`,
//    emitting the PRE-update phase (the polyBLEP reads it) and the final
//    phase.
//  * jsched_scan_kernel replaces grail_tpu/runtime/stream.py::_jsched_scan
//    (:207): per lane `p = p + inc; if (p > 1) { p -= 1; cell++; }`,
//    emitting the POST-update (phase, absolute cell) and the final state.
//    The carrier wraps at >= 1, the jitter phase at > 1, as the reference
//    does; the two are not interchangeable.
//
// Layout: time-major [T, B] (element t * B + b), grail_tpu's own layout for
// both streams, read and written by one thread per lane with its state in
// registers. At each step the 32 lanes of a warp touch 32 consecutive
// floats, so every load and store is one coalesced 128-byte row; a
// lane-major [B, T] layout would make each warp access 32 rows T floats
// apart. The carrier's frequencies do not depend on the chain, so each
// thread loads the next PF of them into registers while it steps through
// the current PF: the loads' latency overlaps the chain.
//
// What bounds it: neither bytes (8 per lane-sample) nor operations (4-5 per
// lane-sample) but the dependent chain: T steps of an add, a compare and a
// select, each waiting for the last, per lane, whatever the lane count. A
// tick of 441 samples is ~441 x 3 dependent instructions, a few
// microseconds; a 4,096-sample block of the xla core ~10 times that.
// Built with -fmad=false, and every add and subtract is __fadd_rn /
// __fsub_rn, so each step rounds once as the plain PyTorch loop does.

#include <cuda_runtime.h>

#define SS_THREADS 128   // lanes per block
#define SS_PF 16         // carrier frequencies prefetched ahead of the chain

__global__ void __launch_bounds__(SS_THREADS)
carrier_scan_kernel(const float* __restrict__ freq,
                    const float* __restrict__ p0, float* __restrict__ track,
                    float* __restrict__ p_out, int T, int B) {
  const int b = blockIdx.x * SS_THREADS + threadIdx.x;
  if (b >= B) return;
  const size_t ld = (size_t)B;
  const float* f = freq + b;
  float* out = track + b;
  float p = p0[b];
  const int Tg = T - T % SS_PF;   // samples in whole prefetch groups
  float cur[SS_PF], nxt[SS_PF];
  if (Tg > 0) {
#pragma unroll
    for (int j = 0; j < SS_PF; ++j) cur[j] = __ldg(f + (size_t)j * ld);
  }
  for (int t0 = 0; t0 < Tg; t0 += SS_PF) {
    const bool more = t0 + SS_PF < Tg;
#pragma unroll
    for (int j = 0; j < SS_PF; ++j)
      nxt[j] = more ? __ldg(f + (size_t)(t0 + SS_PF + j) * ld) : 0.0f;
#pragma unroll
    for (int j = 0; j < SS_PF; ++j) {
      out[(size_t)(t0 + j) * ld] = p;
      p = __fadd_rn(p, cur[j]);
      if (p >= 1.0f) p = __fsub_rn(p, 1.0f);
    }
#pragma unroll
    for (int j = 0; j < SS_PF; ++j) cur[j] = nxt[j];
  }
  for (int t = Tg; t < T; ++t) {
    const float x = __ldg(f + (size_t)t * ld);
    out[(size_t)t * ld] = p;
    p = __fadd_rn(p, x);
    if (p >= 1.0f) p = __fsub_rn(p, 1.0f);
  }
  p_out[b] = p;
}

__global__ void __launch_bounds__(SS_THREADS)
jsched_scan_kernel(const float* __restrict__ jphi,
                   const int* __restrict__ jcell, float inc,
                   float* __restrict__ phi, int* __restrict__ cell,
                   float* __restrict__ jphi_out, int* __restrict__ jcell_out,
                   int T, int B) {
  const int b = blockIdx.x * SS_THREADS + threadIdx.x;
  if (b >= B) return;
  const size_t ld = (size_t)B;
  float p = jphi[b];
  unsigned c = (unsigned)jcell[b];   // unsigned: no signed-overflow UB
#pragma unroll 8
  for (int t = 0; t < T; ++t) {
    p = __fadd_rn(p, inc);
    const bool w = p > 1.0f;
    if (w) p = __fsub_rn(p, 1.0f);
    c += w ? 1u : 0u;
    phi[(size_t)t * ld + b] = p;
    cell[(size_t)t * ld + b] = (int)c;
  }
  jphi_out[b] = p;
  jcell_out[b] = (int)c;
}

extern "C" {

// track [T, B] <- the pre-update carrier phase of each lane's recurrence
// over freq [T, B] from p0 [B]; p_out [B] <- the final phase. On `stream`;
// returns cudaGetLastError().
int grail_carrier_scan(const float* freq, const float* p0, float* track,
                       float* p_out, int T, int B, void* stream) {
  const unsigned blocks = (unsigned)((B + SS_THREADS - 1) / SS_THREADS);
  carrier_scan_kernel<<<blocks, SS_THREADS, 0, (cudaStream_t)stream>>>(
      freq, p0, track, p_out, T, B);
  return (int)cudaGetLastError();
}

// phi, cell [T, B] <- the post-update jitter phase and absolute cell of T
// steps of each lane's recurrence at rate `inc` from (jphi, jcell) [B];
// jphi_out, jcell_out [B] <- the final state. On `stream`; returns
// cudaGetLastError().
int grail_jsched_scan(const float* jphi, const int* jcell, float inc,
                      float* phi, int* cell, float* jphi_out, int* jcell_out,
                      int T, int B, void* stream) {
  const unsigned blocks = (unsigned)((B + SS_THREADS - 1) / SS_THREADS);
  jsched_scan_kernel<<<blocks, SS_THREADS, 0, (cudaStream_t)stream>>>(
      jphi, jcell, inc, phi, cell, jphi_out, jcell_out, T, B);
  return (int)cudaGetLastError();
}

// lanes per block of both kernels
int grail_seq_scan_threads(void) { return SS_THREADS; }

}  // extern "C"
