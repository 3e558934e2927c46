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
// closed-form Lehmer noise; the one-pole + SVF coefficient streams;
// and the sequential one-pole lowpass + 8-formant SVF recurrence. Each
// lane may start at a sample offset g0 and read its own row of the
// schedule: the overlap-save split runs S time segments of each utterance
// as S lanes (s-major), seeded with exact phases: the Q32 phase by
// phase_q32_pre.cu, the kcar phase (si column 2) by kcar_seam.cu, which
// steps the same f32 recurrence over the same frequencies to each
// segment's first sample, so a split kcar lane's carrier is the unsplit
// lane's bit for bit.
//
// In 'host_track' mode (car != null) the per-sample carrier phase is not
// integrated here at all: it is the reference's own f32 recurrence, run once
// on the host over the whole utterance (the native pre-pass), and each lane
// reads its window of that track, addressed exactly as the schedule is (row
// b / lanes_per_row, row_stride apart), so the solo long-form route splits
// with no device pre-pass. Neither the Q32 warp scan nor the kcar loop
// runs, and the carried Q32 and f32 phases pass through unchanged.
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
// utterances; the output is 4 B/sample. The bound is chunk latency. The
// recurrence is sequential in time: per chunk of 128 samples, 8 threads
// (one per formant) walk 128 dependent steps. The feed-forward part
// (sequencer search, row and lattice gathers, carrier, three divisions) is
// parallel over samples but long in latency, and a batch gives few blocks
// per SM to hide it. Run one after the other, a chunk costs the
// feed-forward plus the recurrence plus the output.
//
// The design overlaps them: one block of 160 threads per lane runs a
// two-stage pipeline over its 128-sample chunks. Warps 0-3 (the producers,
// one thread per sample) compute chunk k + 1's feed-forward and write six
// [8][128] coefficient streams and the valid mask into one half of a
// two-buffer ring in shared memory, while warp 4 (the consumer) runs chunk
// k's recurrence from the other half: lanes 0-7, one per formant, carry
// lp/b/c in registers and load the next four steps' values (16 B a stream)
// while four steps compute; then all 32 lanes sum the formants and write
// the audio. Named barriers hand each half over: "full" (producers arrive,
// consumer waits) and "empty" (consumer arrives once it has written chunk
// k's audio, producers wait before they overwrite). The producers' own
// steps that need every sample of a chunk (the Q32 block scan, the kcar
// and jitter loops) synchronise the 128 producer threads alone, so the
// consumer never waits on them. A chunk then costs the longer of the two
// stages, not their sum. On an H100 the producers' stage is the longer one
// on every path (benchmarks/kernel1_ab.py phases: the consumer waits for
// a full buffer 58-78 % of each chunk), so what bounds the kernel now is
// the feed-forward's own latency: the search, the gathers, the divisions
// and the serial kcar and jitter loops. The Q32 phase, the Lehmer seed,
// the f32 carrier phase and the jitter state live in the producers'
// registers, lp/b/c in the consumer's. The stream m22
// and the products q1, q2 are formed by the consumer from the stored m21,
// 2*a3c and tamp, with the same rounded operations as the plain version.
// The ring (51,712 B) is dynamic shared memory; with the producers'
// scratch (2,592 B) a block holds 54,304 B, so 4 blocks share an SM (20
// warps, at most 96 registers a thread). The split fills the card:
// grail_fused_synth_slots reports how many blocks it holds at once, and the
// API picks the segment count S from it.
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

#define CHUNK 128      // samples per chunk = producer threads
#define NF 8           // formants
#define NVEC (6 * NF)  // vec row: ff, bw, smooth, breath, turb, amp (8 each)
#define NPROD CHUNK    // producer threads (warps 0-3)
#define NTHREADS (NPROD + 32)   // + the consumer warp
#define MIN_BLOCKS 4   // resident blocks per SM the budget is held to

// the ring: per buffer, six coefficient streams [f][sample] and the valid
// mask. A row is padded to 132 floats: a warp of producers storing one
// formant's row, the consumer's 8 formant lanes loading 16 B each at one
// step, and its 32 lanes reading one formant's outputs all hit distinct
// banks
enum { S_ALPHA, S_D, S_M11, S_M21, S_A3C2, S_TAMP, NSTREAM };
#define ROW (CHUNK + 4)
#define BUF_FLOATS (NSTREAM * NF * ROW + CHUNK)
#define RING_BYTES (2 * BUF_FLOATS * 4)

// named barriers (0 is __syncthreads): the producers' own, and per ring
// buffer its "full" and "empty" hand-over
#define BAR_PROD 1
#define BAR_FULL 2    // + buffer
#define BAR_EMPTY 4   // + buffer

static __device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

static __device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// One step of one formant's recurrence, as the plain version rounds it:
// lp' = alpha*lp + d; b' = (m11*b - m21*c) + q1*lp'; c' = (m21*b + m22*c)
// + q2*lp', with m22 = 1 - 2*a3c, q1 = m21*tamp, q2 = 2*a3c*tamp. Returns
// the output term b' + b.
static __device__ __forceinline__ float svf_step(float al, float dd,
                                                 float m11, float m21,
                                                 float a3c2, float tamp,
                                                 float& lp, float& bs,
                                                 float& cs) {
  lp = al * lp + dd;
  const float q1 = m21 * tamp;
  const float q2 = a3c2 * tamp;
  const float m22 = 1.f - a3c2;
  const float nbv = m11 * bs - m21 * cs + q1 * lp;
  const float ncv = m21 * bs + m22 * cs + q2 * lp;
  const float y = nbv + bs;
  bs = nbv;
  cs = ncv;
  return y;
}

// Inclusive scan of v over the producers (wrapping uint32 adds); *total
// gets their sum. Synchronises the producers once.
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
  bar_sync(BAR_PROD, NPROD);
  uint32_t off = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < NPROD / 32; ++w) {
    const uint32_t x = s_warp[w];
    if (w < warp) off += x;
    tot += x;
  }
  *total = tot;
  return v + off;
}

__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
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
  extern __shared__ float4 ring4[];        // [2][BUF_FLOATS] floats
  float* ring = reinterpret_cast<float*>(ring4);
  // the producers' scratch; what a step writes for every sample and reads
  // back after a producer barrier is double-buffered by chunk parity, so
  // chunk k + 1 cannot overwrite what a slower warp still reads of chunk k
  __shared__ float s_car[CHUNK];           // kcar: frequency in, phase out
  __shared__ float s_jphi[2][CHUNK];       // jcarry: the chunk's jitter phase
  __shared__ int s_jcell[2][CHUNK];        // jcarry: and absolute cell
  __shared__ uint32_t s_warp[2][NPROD / 32];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int nch = T / CHUNK;
  const int si_cols = jcarry ? 5 : 3;   // carry mode: + jitter phase, cell

  if (t >= NPROD) {
    // ---- the consumer warp: recurrence and output of chunk k ------------
    const int lane = t - NPROD;
    float lp = 0.f, bs = 0.f, cs = 0.f;
    if (lane < NF) {
      lp = sf_in[b * 3 * NF + lane];
      bs = sf_in[b * 3 * NF + NF + lane];
      cs = sf_in[b * 3 * NF + 2 * NF + lane];
    }
    for (int k = 0; k < nch; ++k) {
      float* buf = ring + (k & 1) * BUF_FLOATS;
      bar_sync(BAR_FULL + (k & 1), NTHREADS);
      if (lane < NF) {
        // one formant's 128 dependent steps, four at a time: the next four
        // steps' values are loaded (16 B per stream) while these compute,
        // and the output terms b' + b overwrite the alpha just read
        const float4* st4 = reinterpret_cast<const float4*>(buf + lane * ROW);
        float4* y4 = reinterpret_cast<float4*>(buf + lane * ROW);
        constexpr int G = NF * ROW / 4;   // float4s between two streams
        float4 al = st4[S_ALPHA * G], dd = st4[S_D * G],
               m11 = st4[S_M11 * G], m21 = st4[S_M21 * G],
               a3 = st4[S_A3C2 * G], ta = st4[S_TAMP * G];
#pragma unroll 2
        for (int g = 0; g < CHUNK / 4; ++g) {
          const int gn = g + 1 < CHUNK / 4 ? g + 1 : g;
          const float4 al_n = st4[S_ALPHA * G + gn];
          const float4 dd_n = st4[S_D * G + gn];
          const float4 m11_n = st4[S_M11 * G + gn];
          const float4 m21_n = st4[S_M21 * G + gn];
          const float4 a3_n = st4[S_A3C2 * G + gn];
          const float4 ta_n = st4[S_TAMP * G + gn];
          float4 y;
          y.x = svf_step(al.x, dd.x, m11.x, m21.x, a3.x, ta.x, lp, bs, cs);
          y.y = svf_step(al.y, dd.y, m11.y, m21.y, a3.y, ta.y, lp, bs, cs);
          y.z = svf_step(al.z, dd.z, m11.z, m21.z, a3.z, ta.z, lp, bs, cs);
          y.w = svf_step(al.w, dd.w, m11.w, m21.w, a3.w, ta.w, lp, bs, cs);
          y4[S_ALPHA * G + g] = y;
          al = al_n;
          dd = dd_n;
          m11 = m11_n;
          m21 = m21_n;
          a3 = a3_n;
          ta = ta_n;
        }
      }
      __syncwarp();
      // output: 0.25 * sum over formants (left to right), zero past the end;
      // lane j writes samples j, j + 32, j + 64, j + 96
      const float* y_p = buf + S_ALPHA * NF * ROW;
      const float* vm_p = buf + NSTREAM * NF * ROW;
      float* out = audio + (size_t)b * T + (size_t)k * CHUNK;
#pragma unroll
      for (int u = 0; u < CHUNK / 32; ++u) {
        const int i = lane + 32 * u;
        float y = y_p[i];
#pragma unroll
        for (int f = 1; f < NF; ++f) y = y + y_p[f * ROW + i];
        out[i] = (y * 0.25f) * vm_p[i];
      }
      // the producers wait for this buffer only if a chunk k + 2 follows
      if (k + 2 < nch) bar_arrive(BAR_EMPTY + (k & 1), NTHREADS);
    }
    if (lane < NF) {
      sf_out[b * 3 * NF + lane] = lp;
      sf_out[b * 3 * NF + NF + lane] = bs;
      sf_out[b * 3 * NF + 2 * NF + lane] = cs;
    }
    return;
  }

  // ---- the producers: the feed-forward part of chunk k, one thread per
  // sample --------------------------------------------------------------
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

  const int* sib = si_in + (size_t)b * si_cols;
  uint32_t q32 = (uint32_t)sib[0];
  uint32_t seed = (uint32_t)sib[1];
  float kphase = __int_as_float(sib[2]);
  float jphi = jcarry ? __int_as_float(sib[3]) : 0.f;
  int jcell = jcarry ? sib[4] : 0;

  for (int k = 0; k < nch; ++k) {
    const int kk = k * CHUNK + t;   // 0-based lane sample
    const int par_k = k & 1;

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
          s_jphi[par_k][i] = p;
          s_jcell[par_k][i] = c;
        }
        jphi = p;
        jcell = c;
      }
      bar_sync(BAR_PROD, NPROD);
      ph = s_jphi[par_k][t];
      cl_in = s_jcell[par_k][t] - lb;   // the window's row; seq_freq clamps
    } else {
      ph = phi[row + kk];
      cl_in = cell[row + kk];
    }

    // ---- A-B: sequencer pick and pitch jitter (seq_freq.cuh) ------------
    const SeqFreq sq = seq_freq(off + kk + 1, nb, scb, E, dt, lpb, W, jdf, ph,
                                cl_in);
    const int jc = sq.jc, jn = sq.jn, cl = sq.cl;
    const bool valid = sq.valid, hs_c = sq.hs_c, hs_n = sq.hs_n;
    const float vm = sq.vm, alf = sq.alf, one_m = sq.one_m;
    const float freq_j = sq.freq_j;

    // ---- C: carrier phase (pre-update) --------------------------------
    float phase;
    if (car) {
      phase = car[row + kk];
    } else if (kcar) {
      // s_car[t] is this thread's own slot: it read it last chunk before
      // reaching this chunk's barriers, so one buffer suffices
      s_car[t] = freq_j;
      bar_sync(BAR_PROD, NPROD);
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
      bar_sync(BAR_PROD, NPROD);
      phase = s_car[t];
    } else {
      const uint32_t fq = __float2uint_rz(freq_j * 4294967296.0f);
      uint32_t total;
      const uint32_t incl = block_incl_scan(fq, s_warp[par_k], &total);
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

    // the buffer of chunk k is free once the consumer is done with k - 2
    if (k >= 2) bar_sync(BAR_EMPTY + par_k, NTHREADS);
    float* buf = ring + par_k * BUF_FLOATS;
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
      float* col = buf + f * ROW + t;
      col[S_ALPHA * NF * ROW] = alpha;
      col[S_D * NF * ROW] = (1.f - alpha) * nw;
      col[S_M11 * NF * ROW] = 2.f * a1 - 1.f;
      col[S_M21 * NF * ROW] = 2.f * a2;
      col[S_A3C2 * NF * ROW] = 2.f * a3c;
      col[S_TAMP * NF * ROW] = tamp;
    }
    buf[NSTREAM * NF * ROW + t] = vm;
    bar_arrive(BAR_FULL + par_k, NTHREADS);
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

// The ring is dynamic shared memory above the 48 KB a block gets by
// default: raise the kernel's limit, and prefer the largest shared-memory
// carveout so that MIN_BLOCKS blocks fit on an SM. Once per device.
static cudaError_t configure(void) {
  static bool done[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(fused_synth_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           RING_BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fused_synth_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

extern "C" {

// Launches one block per lane on `stream`; returns a CUDA error code.
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
  const cudaError_t e = configure();
  if (e != cudaSuccess) return (int)e;
  fused_synth_kernel<<<B, NTHREADS, RING_BYTES, (cudaStream_t)stream>>>(
      n, scal, vec, latp, latf, lata, par, leh, phi, cell, car, g0, lat_base,
      sf_in, si_in, audio, sf_out, si_out, E, W, T, lanes_per_row, row_stride,
      kcar, jcarry, inc);
  return (int)cudaGetLastError();
}

// *slots = blocks of fused_synth_kernel resident at once on `device`: the
// occupancy API's blocks per SM at the launch's own thread count and
// dynamic shared memory, times the SM count. Returns a CUDA error.
int grail_fused_synth_slots(int device, int* slots) {
  int per_sm = 0, sms = 0;
  cudaError_t e = configure();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_synth_kernel, NTHREADS, RING_BYTES);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *slots = per_sm * sms;
  return (int)e;
}

// The launch geometry: threads per block, dynamic shared bytes per block,
// the kernel's registers per thread and static shared bytes, and the shared
// memory of one SM of the current device.
int grail_fused_synth_geometry(int* threads, int* dyn_smem, int* regs,
                               int* static_smem, int* sm_smem) {
  cudaFuncAttributes a;
  int dev = 0;
  *threads = NTHREADS;
  *dyn_smem = RING_BYTES;
  *regs = *static_smem = *sm_smem = 0;
  cudaError_t e = cudaFuncGetAttributes(&a, fused_synth_kernel);
  if (e == cudaSuccess) {
    *regs = a.numRegs;
    *static_smem = (int)a.sharedSizeBytes;
    e = cudaGetDevice(&dev);
  }
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  return (int)e;
}

int grail_fused_synth_chunk(void) { return CHUNK; }

const char* grail_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
