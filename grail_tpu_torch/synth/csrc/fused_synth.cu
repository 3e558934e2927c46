// fused_synth.cu — the fused formant synthesizer for Hopper (sm_90a).
//
// Replaces grail_tpu/synth/kernel_fused.py::_fused_kernel (the Pallas TPU
// kernel behind synth_fused_pallas) in its 'host' mode, with the Q32
// fixed-point carrier or the in-kernel exact f32 carrier (kcar), in its
// 'host_track' mode (car: the carrier phase read from a host-built track),
// and in its 'carry' mode (jcarry: the serving tick of runtime/stream.py).
// Per sample
// it runs the whole reference chain: element index by boundary count, the
// cur/next rows, blend alpha and the 4-case pick; value-noise jitter from
// the shared exact (phi, cell) schedule; the carrier phase; polyBLEP saw;
// closed-form Lehmer noise; the seven one-pole + SVF coefficient streams;
// and the sequential one-pole lowpass + 8-formant SVF recurrence. Each
// lane may start at a sample offset g0 and read its own row of the
// schedule: the overlap-save split runs S time segments of each utterance
// as S lanes (s-major), seeded with exact phases by phase_q32_pre.cu.
//
// In 'host_track' mode (car != null) the per-sample carrier phase is not
// integrated here at all: it is the reference's own f32 recurrence, run once
// on the host over the whole utterance (the native pre-pass), and each lane
// reads its window of that track, addressed exactly as the schedule is (row
// b / lanes_per_row, row_stride apart). A track gives every segment of the
// split its exact phase, which the kcar recurrence cannot (it has no seam
// value to start from), so the solo long-form route keeps the split and
// fills the card. Neither the Q32 warp scan nor the kcar loop runs, and the
// carried Q32 and f32 phases pass through unchanged.
//
// In 'carry' mode no schedule is read: each lane carries its jitter phase
// and absolute lattice cell in si columns 3-4, and per chunk one thread
// steps the reference recurrence (phase = f32(phase + inc); if phase > 1:
// phase -= 1, cell += 1) into shared memory, as the kcar loop steps the
// carrier. The lane's lattice is a sliding window whose row 0 is the
// absolute cell lat_base[b], so the cell read is cell - lat_base[b],
// clamped to the window like the host mode's. A serving tick then uploads
// nothing: scores, lattices, offsets and state stay on the card. A tick is
// short (1,024 samples: 8 chunks) and one wave for up to the card's
// resident blocks, so its time is the launch plus 8 chunk latencies,
// whatever the number of sessions; the carry loop adds one more short
// sequential run per chunk to that latency.
//
// What bounds it on this card: not bytes and not FLOPs. Inputs are a few
// KB of tables per utterance plus an 8 B/sample schedule shared by all
// utterances; the output is 4 B/sample. The bound is dependency latency:
// the recurrence is sequential in time, so per chunk of 128 samples only 8
// threads (one per formant) walk 128 dependent steps of ~15 float ops,
// while 120 threads wait; and a batch of B utterances gives only B blocks
// for 132 SMs. The design keeps everything but the recurrence off that
// critical path: one block of 128 threads per utterance; per chunk, one
// thread per sample computes the feed-forward part (phases A-C) into shared
// memory as seven [128][8] coefficient streams (28 KB), then 8 threads run
// the recurrence from shared memory, then one thread per sample sums the
// formants and writes the output. The TPU kernel's carry across grid steps
// becomes a loop over chunks inside the block, with lp/b/c, the Q32 phase,
// the Lehmer seed and the f32 carrier phase in registers. The split fills
// the card: grail_fused_synth_slots reports how many blocks it holds at
// once, and the API picks the segment count S from it.
//
// Numerics: build with -fmad=false and without --use_fast_math, so every
// float op rounds as in the plain PyTorch version (synth_fused_reference):
// no a*b+c is contracted, and phase/f, 1/den stay IEEE-rounded divisions.
// Lehmer and Q32 arithmetic are uint32 (wrapping; signed overflow would be
// undefined). The Q32 scan is a modular sum, so its order does not matter.
// Where the TPU kernel extracted rows with masked FMAs over a 3-row basis,
// this kernel gathers the cur/next rows per sample: the TPU form equals the
// plain where-chain bit for bit, so the values are the same, and interior
// zero-length elements need no special case.

#include <cuda_runtime.h>
#include <stdint.h>

#include "seq_freq.cuh"

#define CHUNK 128      // samples per chunk = threads per block
#define NF 8           // formants
#define NVEC (6 * NF)  // vec row: ff, bw, smooth, breath, turb, amp (8 each)

// Inclusive scan of v over the block (wrapping uint32 adds); *total gets
// the block-wide sum. Contains one __syncthreads.
__device__ __forceinline__ uint32_t block_incl_scan(uint32_t v,
                                                    uint32_t* s_warp,
                                                    uint32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  uint32_t off = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < CHUNK / 32; ++w) {
    const uint32_t x = s_warp[w];
    if (w < warp) off += x;
    tot += x;
  }
  *total = tot;
  return v + off;
}

__global__ void __launch_bounds__(CHUNK)
fused_synth_kernel(const int* __restrict__ n, const float* __restrict__ scal,
                   const float* __restrict__ vec,
                   const float* __restrict__ latp,
                   const float* __restrict__ latf,
                   const float* __restrict__ lata,
                   const float* __restrict__ par,
                   const uint32_t* __restrict__ leh,
                   const float* __restrict__ phi,
                   const int* __restrict__ cell,
                   const float* __restrict__ car,
                   const int* __restrict__ g0,
                   const int* __restrict__ lat_base,
                   const float* __restrict__ sf_in,
                   const int* __restrict__ si_in, float* __restrict__ audio,
                   float* __restrict__ sf_out, int* __restrict__ si_out, int E,
                   int W, int T, int lanes_per_row, int row_stride, int kcar,
                   int jcarry, float inc) {
  __shared__ float s_alpha[CHUNK][NF];   // after D: the output terms b' + b
  __shared__ float s_d[CHUNK][NF];
  __shared__ float s_q1[CHUNK][NF];
  __shared__ float s_q2[CHUNK][NF];
  __shared__ float s_m11[CHUNK][NF];
  __shared__ float s_m21[CHUNK][NF];
  __shared__ float s_m22[CHUNK][NF];
  __shared__ float s_car[CHUNK];         // kcar: frequency in, phase out
  __shared__ float s_jphi[CHUNK];        // jcarry: the chunk's jitter phase
  __shared__ int s_jcell[CHUNK];         // jcarry: and absolute cell
  __shared__ uint32_t s_warp[CHUNK / 32];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int* nb = n + (size_t)b * E;
  const float* scb = scal + (size_t)b * E * NSCAL;
  const float* vcb = vec + (size_t)b * E * NVEC;
  const float* lpb = latp + (size_t)b * W;
  const float* lfb = latf + (size_t)b * W * NF;
  const float* lab = lata + (size_t)b * W * NF;
  const float jdf = par[b * 4 + 0];
  const float jdff = par[b * 4 + 1];
  const float jda = par[b * 4 + 2];
  const float dt = par[b * 4 + 3];
  // the lane's sample offset and schedule row (lanes are s-major); carry
  // mode reads no schedule
  const int off = g0 ? g0[b] : 0;
  const int lb = lat_base ? lat_base[b] : 0;
  const size_t row = (size_t)(b / lanes_per_row) * row_stride;
  // Lehmer: sample t of a chunk has state A^(t+1)*seed + S_(t+1), where
  // seed is the previous chunk's last state
  const uint32_t leh_a = leh[t], leh_s = leh[CHUNK + t];
  const uint32_t leh_a_end = leh[CHUNK - 1], leh_s_end = leh[2 * CHUNK - 1];

  const int si_cols = jcarry ? 5 : 3;   // carry mode: + jitter phase, cell
  const int* sib = si_in + (size_t)b * si_cols;
  uint32_t q32 = (uint32_t)sib[0];
  uint32_t seed = (uint32_t)sib[1];
  float kphase = __int_as_float(sib[2]);
  float jphi = jcarry ? __int_as_float(sib[3]) : 0.f;
  int jcell = jcarry ? sib[4] : 0;
  float lp = 0.f, bs = 0.f, cs = 0.f;
  if (t < NF) {
    lp = sf_in[b * 3 * NF + t];
    bs = sf_in[b * 3 * NF + NF + t];
    cs = sf_in[b * 3 * NF + 2 * NF + t];
  }

  for (int c0 = 0; c0 < T; c0 += CHUNK) {
    const int k = c0 + t;   // 0-based lane sample; k1 the absolute 1-based

    // ---- the jitter schedule: read, or stepped from the carried state --
    float ph;
    int cl_in;
    if (jcarry) {
      if (t == 0) {
        float p = jphi;
        int c = jcell;
        for (int i = 0; i < CHUNK; ++i) {
          p = p + inc;
          if (p > 1.f) {
            p = p - 1.f;
            c += 1;
          }
          s_jphi[i] = p;
          s_jcell[i] = c;
        }
        jphi = p;
        jcell = c;
      }
      __syncthreads();
      ph = s_jphi[t];
      cl_in = s_jcell[t] - lb;   // the window's row; seq_freq clamps it
    } else {
      ph = phi[row + k];
      cl_in = cell[row + k];
    }

    // ---- A-B: sequencer pick and pitch jitter (seq_freq.cuh) ------------
    const SeqFreq sq = seq_freq(off + k + 1, nb, scb, E, dt, lpb, W, jdf, ph,
                                cl_in);
    const int jc = sq.jc, jn = sq.jn, cl = sq.cl;
    const bool valid = sq.valid, hs_c = sq.hs_c, hs_n = sq.hs_n;
    const float vm = sq.vm, alf = sq.alf, one_m = sq.one_m;
    const float freq_j = sq.freq_j;

    // ---- C: carrier phase (pre-update) --------------------------------
    float phase;
    if (car) {
      phase = car[row + k];
    } else if (kcar) {
      s_car[t] = freq_j;
      __syncthreads();
      if (t == 0) {
        float p = kphase;
        for (int i = 0; i < CHUNK; ++i) {
          const float f = s_car[i];
          s_car[i] = p;
          p = p + f;
          if (p >= 1.f) p = p - 1.f;
        }
        kphase = p;
      }
      __syncthreads();
      phase = s_car[t];
    } else {
      const uint32_t fq = __float2uint_rz(freq_j * 4294967296.0f);
      uint32_t total;
      const uint32_t incl = block_incl_scan(fq, s_warp, &total);
      phase = __uint2float_rn(q32 + (incl - fq)) * 2.3283064365386963e-10f;
      q32 += total;
    }

    // polyBLEP saw (reference src/lib.rs:503-517)
    const float t0 = phase / freq_j;
    const float first = 2.f * t0 - t0 * t0 - 1.f;
    const float t1 = (phase - 1.f) / freq_j;
    const float last = t1 * t1 + 2.f * t1 + 1.f;
    const float pb = phase < freq_j ? first
                                    : (phase > 1.f - freq_j ? last : 0.f);
    const float saw = 2.f * phase - 1.f - pb;

    // Lehmer noise
    const uint32_t st = leh_a * seed + leh_s;
    const float nz = (__uint_as_float((st >> 9) | 0x3F800000u) - 1.5f) * 2.f;
    seed = leh_a_end * seed + leh_s_end;

    const float* vc = vcb + jc * NVEC;
    const float* vn = vcb + jn * NVEC;
    const float* fc = lfb + cl * NF;
    const float* ac = lab + cl * NF;
    const float jdff_m = vm * jdff;
    const float jda_m = vm * (0.5f * jda);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float ff_e = pick(vc[f], vn[f], 0.25f, alf, one_m, valid, hs_c,
                              hs_n);
      const float bw_e = pick(vc[NF + f], vn[NF + f], 0.25f, alf, one_m,
                              valid, hs_c, hs_n);
      const float sm_e = pick(vc[2 * NF + f], vn[2 * NF + f], 0.25f, alf,
                              one_m, valid, hs_c, hs_n);
      const float br_e = pick(vc[3 * NF + f], vn[3 * NF + f], 0.f, alf,
                              one_m, valid, hs_c, hs_n);
      const float tb_e = pick(vc[4 * NF + f], vn[4 * NF + f], 0.f, alf,
                              one_m, valid, hs_c, hs_n);
      // amplitude: lerp when both sound; fade out into a silent next
      // (amp*alf); fade in out of a silent cur (amp*(1-alf))
      const float amc = vc[5 * NF + f], amn = vn[5 * NF + f];
      float am_e = 0.f;
      if (valid) {
        if (hs_c && hs_n) am_e = amc * alf + amn * one_m;
        else if (hs_c) am_e = amc * alf;
        else if (hs_n) am_e = amn * one_m;
      }
      const float form = fc[f] + (fc[NF + f] - fc[f]) * ph;
      const float ampn = ac[f] + (ac[NF + f] - ac[f]) * ph;
      const float ff_j = ff_e + form * jdff_m;
      const float am_j = am_e * (1.f - (ampn + 1.f) * jda_m);

      const float nw = saw + (nz - saw) * br_e;
      const float o = 1.f - sm_e;                  // exp_approx
      const float o2 = o * o;
      const float alpha = o2 * o2 * o;
      const float tamp = (1.f + (nz - 1.f) * tb_e) * am_j;
      // SVF coefficients with one division (tan_approx_parts: g = N/D)
      const float x = ff_j;
      const float u = 1.f - x;
      const float v = x + 0.5f;
      const float p = v * (0.5f - x);
      const float q = u * x;
      const float N = q * (5.f - 4.f * p);
      const float D = p * (5.f - 4.f * q);
      const float fD2 = x * (D * D);
      const float fN2 = x * (N * N);
      const float ND = N * D;
      const float r = 1.f / (fD2 + fN2 + bw_e * ND);
      const float a1 = fD2 * r;
      const float a2 = (x * ND) * r;
      const float a3c = fN2 * r;
      const float m21 = 2.f * a2;
      s_alpha[t][f] = alpha;
      s_d[t][f] = (1.f - alpha) * nw;
      s_q1[t][f] = m21 * tamp;
      s_q2[t][f] = (2.f * a3c) * tamp;
      s_m11[t][f] = 2.f * a1 - 1.f;
      s_m21[t][f] = m21;
      s_m22[t][f] = 1.f - 2.f * a3c;
    }
    __syncthreads();

    // ---- D: the sequential recurrence, one thread per formant ----------
    if (t < NF) {
      const int f = t;
      for (int i = 0; i < CHUNK; ++i) {
        lp = s_alpha[i][f] * lp + s_d[i][f];
        const float m21 = s_m21[i][f];
        const float nbv = s_m11[i][f] * bs - m21 * cs + s_q1[i][f] * lp;
        const float ncv = m21 * bs + s_m22[i][f] * cs + s_q2[i][f] * lp;
        s_alpha[i][f] = nbv + bs;
        bs = nbv;
        cs = ncv;
      }
    }
    __syncthreads();

    // ---- output: 0.25 * sum over formants, zero past the end ----------
    float y = s_alpha[t][0];
#pragma unroll
    for (int f = 1; f < NF; ++f) y = y + s_alpha[t][f];
    audio[(size_t)b * T + k] = (y * 0.25f) * vm;
    __syncthreads();   // shared streams are rewritten by the next chunk
  }

  if (t < NF) {
    sf_out[b * 3 * NF + t] = lp;
    sf_out[b * 3 * NF + NF + t] = bs;
    sf_out[b * 3 * NF + 2 * NF + t] = cs;
  }
  if (t == 0) {
    int* sob = si_out + (size_t)b * si_cols;
    sob[0] = (kcar || car) ? sib[0] : (int)q32;
    sob[1] = (int)seed;
    sob[2] = kcar ? __float_as_int(kphase) : sib[2];
    if (jcarry) {
      sob[3] = __float_as_int(jphi);
      sob[4] = jcell;
    }
  }
}

extern "C" {

// Launches one block per lane on `stream`; returns cudaGetLastError().
// phi/cell hold B / lanes_per_row rows of T samples, row_stride apart (rows
// may overlap, as the split's segment windows do); g0 may be null (all 0).
// car, when not null, is the carrier phase track, laid out as phi is (the
// host_track mode; not with kcar or jcarry, which the wrapper refuses).
// jcarry = 1: the carry mode; phi/cell are not read, si has 5 columns (3
// otherwise), inc is the jitter rate and lat_base may be null (all 0).
int grail_fused_synth(const int* n, const float* scal, const float* vec,
                      const float* latp, const float* latf, const float* lata,
                      const float* par, const uint32_t* leh, const float* phi,
                      const int* cell, const float* car, const int* g0,
                      const int* lat_base, const float* sf_in,
                      const int* si_in, float* audio,
                      float* sf_out, int* si_out, int B, int E, int W, int T,
                      int lanes_per_row, int row_stride, int kcar, int jcarry,
                      float inc, void* stream) {
  fused_synth_kernel<<<B, CHUNK, 0, (cudaStream_t)stream>>>(
      n, scal, vec, latp, latf, lata, par, leh, phi, cell, car, g0, lat_base,
      sf_in, si_in, audio, sf_out, si_out, E, W, T, lanes_per_row, row_stride,
      kcar, jcarry, inc);
  return (int)cudaGetLastError();
}

// *slots = blocks of fused_synth_kernel resident at once on `device`: the
// occupancy API's blocks per SM times the SM count. Returns a CUDA error.
int grail_fused_synth_slots(int device, int* slots) {
  int per_sm = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_synth_kernel, CHUNK, 0);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *slots = per_sm * sms;
  return (int)e;
}

int grail_fused_synth_chunk(void) { return CHUNK; }

const char* grail_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
