// synth_core.cu — the round-1 DSP core's recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel grail_tpu/synth/kernel.py::_synth_kernel
// (launched by synth_core_pallas). The feed-forward part of the chain runs
// before it as plain PyTorch (synth/kernel.precompute_streams): seven
// coefficient streams alpha, d, q1, q2, m11, m21, m22, each f32 [T][8][B].
// This kernel runs the part that is sequential in time, for every lane b
// and formant f, from the carried state (lp, b, c) [8][B]:
//
//     lp' = alpha * lp + d                     (one-pole lowpass)
//     b'  = (m11 * b - m21 * c) + q1 * lp'     (SVF, v0 folded into q1/q2)
//     c'  = (m21 * b + m22 * c) + q2 * lp'
//     audio[t][b] = 0.25 * (y_0 + y_1 + ... + y_7),  y_f = b' + b,
//
// and writes audio [T][B] and the final state [8][B].
//
// What bounds it on this card: bytes. It reads 7 x 8 x 4 = 224 B and writes
// 4 B per lane-sample for ~112 float ops, so at 3.35 TB/s the bytes take
// ~30x longer than the ops at 67 TFLOP/s. What holds a run back from that
// bound is latency: every (lane, formant) recurrence is a chain of T
// dependent steps, and a batch gives only 8 B of them (512 at B = 64), so
// the card is mostly idle unless the overlap-save split multiplies lanes.
//
// Design, the simple one: one thread per (lane, formant); a block is 16
// lanes x 8 formants, threadIdx.x the lane, so a warp's loads of one
// stream are two 64-byte runs of neighbouring lanes. The TPU kernel's
// sequential time grid, with the state in revisited output blocks, becomes
// a loop over time in each thread with the state in registers. Per chunk of
// 16 steps a thread first issues all 7 x 16 loads (independent of the
// recurrence, so one memory latency per chunk instead of per step), then
// runs the 16 steps and leaves b' + b in shared memory; after a barrier the
// block sums the 8 formants of each (step, lane) in a fixed left-to-right
// order and writes the audio, one coalesced row per step.
//
// Numerics: built with -fmad=false and no fast math, so each product and
// sum rounds on its own, left to right as written above; with the same
// order in synth_core_reference the two agree bit for bit in audio and
// state.

#include <cuda_runtime.h>

#define NF 8        // formants
#define LANES 16    // lanes per block; blockDim = (LANES, NF)
#define CT 16       // time steps per register chunk

__global__ void __launch_bounds__(LANES * NF)
synth_core_kernel(const float* __restrict__ alpha, const float* __restrict__ d,
                  const float* __restrict__ q1, const float* __restrict__ q2,
                  const float* __restrict__ m11,
                  const float* __restrict__ m21,
                  const float* __restrict__ m22,
                  const float* __restrict__ lp_in,
                  const float* __restrict__ b_in,
                  const float* __restrict__ c_in, float* __restrict__ audio,
                  float* __restrict__ lp_out, float* __restrict__ b_out,
                  float* __restrict__ c_out, int T, int B) {
  __shared__ float s_y[CT][NF][LANES];   // b' + b by step, formant, lane
  const int l = threadIdx.x;             // lane within the block
  const int f = threadIdx.y;             // formant
  const int b = blockIdx.x * LANES + l;
  const bool on = b < B;
  const size_t si = (size_t)f * B + b;   // [8][B] state; offset in a step
  const size_t step = (size_t)NF * B;    // stream stride of one time step
  float lp = 0.f, bs = 0.f, cs = 0.f;
  if (on) {
    lp = lp_in[si];
    bs = b_in[si];
    cs = c_in[si];
  }

  for (int t0 = 0; t0 < T; t0 += CT) {
    const int n = min(CT, T - t0);
    float al[CT], dv[CT], v1[CT], v2[CT], a11[CT], a21[CT], a22[CT];
    const size_t base = (size_t)t0 * step + si;
#pragma unroll
    for (int k = 0; k < CT; ++k) {
      if (on && k < n) {
        const size_t o = base + (size_t)k * step;
        al[k] = alpha[o];
        dv[k] = d[o];
        v1[k] = q1[o];
        v2[k] = q2[o];
        a11[k] = m11[o];
        a21[k] = m21[o];
        a22[k] = m22[o];
      } else {
        al[k] = dv[k] = v1[k] = v2[k] = a11[k] = a21[k] = a22[k] = 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < CT; ++k) {
      if (k < n) {
        const float lpn = al[k] * lp + dv[k];
        const float nb = a11[k] * bs - a21[k] * cs + v1[k] * lpn;
        const float nc = a21[k] * bs + a22[k] * cs + v2[k] * lpn;
        s_y[k][f][l] = nb + bs;
        lp = lpn;
        bs = nb;
        cs = nc;
      }
    }
    __syncthreads();
    for (int i = f * LANES + l; i < n * LANES; i += NF * LANES) {
      const int k = i / LANES, lo = i % LANES;
      const int bo = blockIdx.x * LANES + lo;
      if (bo < B) {
        float acc = s_y[k][0][lo];
#pragma unroll
        for (int g = 1; g < NF; ++g) acc = acc + s_y[k][g][lo];
        audio[(size_t)(t0 + k) * B + bo] = acc * 0.25f;
      }
    }
    __syncthreads();   // s_y is rewritten by the next chunk
  }
  if (on) {
    lp_out[si] = lp;
    b_out[si] = bs;
    c_out[si] = cs;
  }
}

extern "C" {

// Launches ceil(B / 16) blocks of 16 x 8 threads on `stream`. Streams are
// [T][8][B], state [8][B], audio [T][B], all f32 and contiguous; T >= 1.
// Returns cudaGetLastError().
int grail_synth_core(const float* alpha, const float* d, const float* q1,
                     const float* q2, const float* m11, const float* m21,
                     const float* m22, const float* lp_in, const float* b_in,
                     const float* c_in, float* audio, float* lp_out,
                     float* b_out, float* c_out, int T, int B,
                     void* stream) {
  const dim3 block(LANES, NF);
  const dim3 grid((B + LANES - 1) / LANES);
  synth_core_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      alpha, d, q1, q2, m11, m21, m22, lp_in, b_in, c_in, audio, lp_out,
      b_out, c_out, T, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
