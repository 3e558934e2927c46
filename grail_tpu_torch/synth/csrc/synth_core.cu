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
// What bounds it on this card: bytes, when the lanes are many. It reads
// 7 x 8 x 4 = 224 B and writes 4 B per lane-sample for ~112 float ops, so
// at 3.35 TB/s the bytes take ~30x longer than the ops at the peak rate.
// Each (lane, formant) chain is T dependent steps, so the card reaches the
// bytes bound only if every SM keeps tens of KB of loads in flight while
// its chains step, in requests large enough for the memory system. With
// few lanes (64, the unsplit core program) nothing can: a consumer warp's
// own time per step (its loads from shared memory, the 13 operations of
// the step, the staged formant sum) times T is the floor, above the bytes
// bound.
//
// Design: a block owns 4 lanes and runs two warps. Warp 0, the consumer,
// runs the chains, thread c the chain of lane c % 4, formant c / 4, with
// its state in registers; the grid is ceil(B / 4) blocks (128 of the 132
// SMs at the core route's 512 lanes). The streams reach it through a ring
// of NSTAGE stages in shared memory, each CT steps of the block's 7
// streams x 8 formants x 4 lanes (14,336 B), which warp 1, the producer,
// fills NSTAGE - 1 stages ahead (~72 KB of loads in flight per block).
// Each slot has a "full" and an "empty" mbarrier. When B % 4 == 0 and the
// streams are 16-byte aligned, the producer's lane 0 asks the tensor
// memory accelerator for one box of 4 lanes x 8 formants x CT steps per
// stream (a tensor map per stream, built on the host per launch), counted
// on "full" by bytes. Otherwise its 32 threads copy the stage with 4-byte
// cp.async, lanes past B zero-filled, each arriving on "full" when its
// copies land. The consumer reads a stage's values into registers, runs its
// CT steps, releases the slot on "empty" and leaves y_f in a padded
// staging tile; after a barrier of the consumer warp each thread sums two
// (step, lane) outputs over the 8 formants left to right and writes them,
// 16-byte rows of 4 lanes. The tiles alternate by stage, so one barrier a
// stage suffices and no barrier involves the producer. The ring, the tiles
// and the mbarriers take 90,848 B of dynamic shared memory: 2 blocks per
// SM.
//
// On an H100 (benchmarks/kernels23_ab.py) the 512-lane block takes ~0.31
// ms, 46 % of the bytes bound: the card delivers ~1.5 TB/s to this access
// pattern, rows of 16 or 32 bytes per (step, formant) at a stride of B
// floats, each 2 KB row shared by 64-128 SMs. Eight lanes per block
// (32-byte rows), 12 stages in flight, L2 promotion of the tensor copies
// and a single warp issuing its own copies all land at 0.305-0.375 ms. At
// 64 lanes the consumer's own steps bound it, ~0.145 ms for 4,096 steps
// (~45 cycles a step: the step's shared loads and its 13 operations).
//
// Numerics: built with -fmad=false and no fast math, so each product and
// sum rounds on its own, left to right as written above; with the same
// order in synth_core_reference the two agree bit for bit in audio and
// state.

#include <cuda.h>   // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>

#define NF 8           // formants
#define LPB 4          // lanes per block
#define NCONS (NF * LPB)        // consumer threads, one per chain
#define NCW (NCONS / 32)        // consumer warps (one)
#define NTHREADS (NCONS + 32)   // + the producer warp
#define NSTR 7         // streams
#define CT 16          // time steps per ring stage
#define NSTAGE 6       // ring stages; NSTAGE - 1 are in flight
#define STREAM_FLOATS (CT * NF * LPB)          // one stream's box [k][f][l]
#define STAGE_FLOATS (NSTR * STREAM_FLOATS)
#define YROW (NF * LPB + LPB)   // staging row of NF * LPB outputs, padded
#define RING_BYTES (NSTAGE * STAGE_FLOATS * 4)
#define BAR_CONS 1     // named barrier of the consumer warps
// the ring (128-byte aligned for the tensor copies), two staging tiles and
// per ring slot a "full" and an "empty" mbarrier
#define SMEM_BYTES (128 + RING_BYTES + 2 * CT * YROW * 4 + 2 * NSTAGE * 8)

struct Streams {
  const float* p[NSTR];   // alpha, d, q1, q2, m11, m21, m22
};

// One tensor map per stream over [T][8][B] (dims B, 8, T innermost first),
// box LPB x 8 x CT: what one stage of one block reads.
struct Maps {
  CUtensorMap m[NSTR];
};

static __device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

static __device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                                 int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed.
static __device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

static __device__ __forceinline__ void mbar_init(uint64_t* bar,
                                                 unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

static __device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

static __device__ __forceinline__ void mbar_expect(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

static __device__ __forceinline__ void mbar_wait(uint64_t* bar,
                                                 unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

static __device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(BAR_CONS), "n"(NCONS) : "memory");
}

// The box of stream map `map` at (lane b0, formant 0, step t0) into `dst`,
// its bytes counted on `bar`; the tensor unit zero-fills what lies past B
// or T.
static __device__ __forceinline__ void tma_load(float* dst,
                                                const CUtensorMap* map,
                                                int b0, int t0,
                                                uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_addr(dst)),
      "l"((uint64_t)map), "r"(b0), "r"(0), "r"(t0), "r"(smem_addr(bar))
      : "memory");
}

// The producer warp: fill every stage's ring slot once the consumers have
// released it. TMA: lane 0 asks the tensor unit for the 7 boxes, their
// bytes counted on the slot's "full" barrier. Else the warp's 32 threads
// copy the stage 4 bytes at a time (lanes past B zero-filled), each
// arriving on "full" once its own copies have landed.
template <bool TMA>
static __device__ __forceinline__ void produce(
    const Maps& maps, const Streams& st, float* ring, uint64_t* full,
    uint64_t* empty, int nst, int T, int B, int b0, int p) {
  if (TMA && p != 0) return;
  for (int s = 0; s < nst; ++s) {
    const int slot = s % NSTAGE;
    if (s >= NSTAGE) mbar_wait(empty + slot, (s / NSTAGE - 1) & 1);
    float* dst = ring + slot * STAGE_FLOATS;
    const int t0 = s * CT;
    if (TMA) {
      mbar_expect(full + slot, STAGE_FLOATS * 4);
#pragma unroll
      for (int r = 0; r < NSTR; ++r)
        tma_load(dst + r * STREAM_FLOATS, &maps.m[r], b0, t0, full + slot);
    } else {
      // element e = p + 32 i of a stream's box: lane e % LPB, formant
      // e / LPB % 8, step e / (8 LPB)
      const int l = p % LPB;
      const bool on = b0 + l < B;
      const size_t lane = on ? (size_t)b0 + l : 0;
      const size_t row = on ? B : 0;     // a formant's row, B floats
#pragma unroll
      for (int r = 0; r < NSTR; ++r) {
#pragma unroll 4
        for (int e = p; e < STREAM_FLOATS; e += 32) {
          const int f = (e / LPB) % NF, k = e / (NF * LPB);
          if (t0 + k < T)
            cp_async4(dst + r * STREAM_FLOATS + e,
                      st.p[r] + ((size_t)(t0 + k) * NF + f) * row + lane,
                      on ? 4 : 0);
        }
      }
      cp_async_arrive(full + slot);
    }
  }
}

// The recurrence over the n steps of one stage (FULL: n == CT, unguarded)
// for consumer thread c: lane c % LPB, formant c / LPB of the block. All of
// the stage's values are read into registers first, so that the steps wait
// on no load.
template <bool FULL>
static __device__ __forceinline__ void run_stage(const float* buf,
                                                 float* s_y, int n, int c,
                                                 float& lp, float& bs,
                                                 float& cs) {
  float v[CT][NSTR];
#pragma unroll
  for (int k = 0; k < CT; ++k)
#pragma unroll
    for (int r = 0; r < NSTR; ++r)
      v[k][r] = (FULL || k < n) ? buf[r * STREAM_FLOATS + k * NF * LPB + c]
                                : 0.f;
#pragma unroll
  for (int k = 0; k < CT; ++k) {
    if (FULL || k < n) {
      const float lpn = v[k][0] * lp + v[k][1];
      const float nb = v[k][4] * bs - v[k][5] * cs + v[k][2] * lpn;
      const float nc = v[k][5] * bs + v[k][6] * cs + v[k][3] * lpn;
      s_y[k * YROW + c] = nb + bs;
      lp = lpn;
      bs = nb;
      cs = nc;
    }
  }
}

template <bool TMA>
__global__ void __launch_bounds__(NTHREADS)
synth_core_kernel(const __grid_constant__ Maps maps, Streams st,
                  const float* __restrict__ lp_in,
                  const float* __restrict__ b_in,
                  const float* __restrict__ c_in, float* __restrict__ audio,
                  float* __restrict__ lp_out, float* __restrict__ b_out,
                  float* __restrict__ c_out, int T, int B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // aligned by an offset from the shared array itself, so that every
  // access below stays a shared-memory one (LDS/STS, not generic)
  float* ring =
      (float*)(smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127));
  float* s_y = ring + NSTAGE * STAGE_FLOATS;       // [2][CT][YROW]
  uint64_t* full = (uint64_t*)(s_y + 2 * CT * YROW);
  uint64_t* empty = full + NSTAGE;
  const int c = threadIdx.x;
  const int b0 = blockIdx.x * LPB;
  const int nst = (T + CT - 1) / CT;
  if (c == 0) {
    for (int i = 0; i < NSTAGE; ++i) {
      mbar_init(full + i, TMA ? 1 : 32);
      mbar_init(empty + i, NCW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (c >= NCONS) {
    produce<TMA>(maps, st, ring, full, empty, nst, T, B, b0, c - NCONS);
    return;
  }

  const int l = c % LPB, f = c / LPB;   // lane in block, formant
  const bool on = b0 + l < B;
  const size_t si = (size_t)f * B + b0 + l;   // [8][B] state offset
  float lp = 0.f, bs = 0.f, cs = 0.f;
  if (on) {
    lp = lp_in[si];
    bs = b_in[si];
    cs = c_in[si];
  }
  for (int s = 0; s < nst; ++s) {
    const int slot = s % NSTAGE;
    mbar_wait(full + slot, (s / NSTAGE) & 1);
    const float* buf = ring + slot * STAGE_FLOATS;
    float* sy = s_y + (s & 1) * CT * YROW;
    const int t0 = s * CT;
    const int n = min(CT, T - t0);
    if (n == CT)
      run_stage<true>(buf, sy, n, c, lp, bs, cs);
    else
      run_stage<false>(buf, sy, n, c, lp, bs, cs);
    // the slot's values are all in registers and used: release it
    __syncwarp();
    if ((c & 31) == 0) mbar_arrive(empty + slot);
    // both warps' y of this stage are staged (and, the tiles alternating,
    // the previous stage's sums read)
    bar_consumers();
    // output o = c + NCONS j: step o / LPB, lane o % LPB; the 8 formants of a
    // lane summed left to right
#pragma unroll
    for (int j = 0; j < CT * LPB / NCONS; ++j) {
      const int o = c + NCONS * j;
      const int k = o / LPB, lo = o % LPB;
      if (k < n && b0 + lo < B) {
        const float* y = sy + k * YROW + lo;
        float acc = y[0];
#pragma unroll
        for (int g = 1; g < NF; ++g) acc = acc + y[g * LPB];
        audio[(size_t)(t0 + k) * B + b0 + lo] = acc * 0.25f;
      }
    }
  }
  if (on) {
    lp_out[si] = lp;
    b_out[si] = bs;
    c_out[si] = cs;
  }
}
// The tensor copies need B % 4 == 0 (16-byte strides) and 16-byte aligned
// streams.
static bool use_tma(const float* const* p, int B) {
  if (B % 4) return false;
  for (int r = 0; r < NSTR; ++r)
    if ((uintptr_t)p[r] % 16) return false;
  return true;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime (the
// library links no libcuda of its own).
static cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || !p)
      return cudaErrorSymbolNotFound;
    cached = (EncodeTiled)p;
  }
  *fn = cached;
  return cudaSuccess;
}

static cudaError_t make_maps(Maps* maps, const Streams& st, int T, int B) {
  EncodeTiled encode;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)B, NF, (cuuint64_t)T};
  const cuuint64_t strides[2] = {(cuuint64_t)B * 4, (cuuint64_t)NF * B * 4};
  const cuuint32_t box[3] = {LPB, NF, CT};
  const cuuint32_t unit[3] = {1, 1, 1};
  for (int r = 0; r < NSTR; ++r) {
    if (encode(&maps->m[r], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
               (void*)st.p[r], dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_NONE,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

extern "C" {

// Launches ceil(B / 8) blocks of three warps on `stream`. Streams are
// [T][8][B], state [8][B], audio [T][B], all f32 and contiguous; T >= 1.
// Returns cudaGetLastError() (or the error of building the tensor maps or
// of setting the kernel's shared memory limit).
int grail_synth_core(const float* alpha, const float* d, const float* q1,
                     const float* q2, const float* m11, const float* m21,
                     const float* m22, const float* lp_in, const float* b_in,
                     const float* c_in, float* audio, float* lp_out,
                     float* b_out, float* c_out, int T, int B,
                     void* stream) {
  const Streams st = {{alpha, d, q1, q2, m11, m21, m22}};
  const dim3 grid((B + LPB - 1) / LPB);
  const bool tma = use_tma(st.p, B);
  Maps maps{};
  cudaError_t err = tma ? make_maps(&maps, st, T, B) : cudaSuccess;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        tma ? synth_core_kernel<true> : synth_core_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (tma)
    synth_core_kernel<true><<<grid, NTHREADS, SMEM_BYTES,
                              (cudaStream_t)stream>>>(
        maps, st, lp_in, b_in, c_in, audio, lp_out, b_out, c_out, T, B);
  else
    synth_core_kernel<false><<<grid, NTHREADS, SMEM_BYTES,
                               (cudaStream_t)stream>>>(
        maps, st, lp_in, b_in, c_in, audio, lp_out, b_out, c_out, T, B);
  return (int)cudaGetLastError();
}

// What grail_synth_core launches for B lanes with aligned streams: blocks,
// threads per block, dynamic shared bytes, the compiled kernel's registers
// per thread, resident blocks per SM, and the copy route (1: tensor
// copies, 0: 4-byte cp.async). Returns 0 or a CUDA error.
int grail_synth_core_geometry(int B, int* blocks, int* threads, int* smem,
                              int* regs, int* per_sm, int* tma) {
  const bool t = B % 4 == 0;
  const void* fn = t ? (const void*)synth_core_kernel<true>
                     : (const void*)synth_core_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, NTHREADS,
                                                        SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  *blocks = (B + LPB - 1) / LPB;
  *threads = NTHREADS;
  *smem = SMEM_BYTES;
  *regs = attr.numRegs;
  *tma = t;
  return 0;
}

}  // extern "C"
