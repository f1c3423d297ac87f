// Hand-written Hopper (sm_90a) kernels for the max-plus sweep experiment
// (tehmm_tpu_torch/tools/exp_maxplus_s256.py): how to run a max-plus step
// when the transition matrix no longer fits in fast memory.
//
// Built with the other sources into one shared library with a plain C
// interface (tehmm_tpu_torch/ops/cuda_kernels.py), loaded with ctypes.
// Every entry point launches on the stream it is given, allocates nothing
// and returns the cudaGetLastError() that follows its launch.
//
// Kernels and the TPU kernels they replace (tools/exp_maxplus_s256.py,
// both under main :107):
//
//   maxplus_resident_kernel  K9 A, _kernel_unrolled (:41, pallas_call
//                            :115): every row of T read in place
//   maxplus_blocks_kernel    K9 B, _kernel_scratch_blocks (:54,
//                            pallas_call :120): row blocks of T staged
//                            through one scratch buffer
//
// What they compute: kSweeps sweeps of best[j, b] = max_i(v[i, b] +
// T[i, j]), v <- best - max_j best[j, b], on v f32[Sp, Bg] (state-major,
// as the JAX tool has it) and T f32[Sp, Sp]; the last v goes out.
//
// What bounds them on an H100: 2 * Sp^2 * Bg float32 instructions a sweep
// (an add and a max per term) against 4 * Sp^2 bytes of T a sweep for
// each block that reads it; at Sp = 1024 T is 4 MB, past every block's
// 227 KB of shared memory, so the bytes of T from L2 are the cost a
// layout can move: a block that holds C columns reads T once a sweep for
// all C of them.
//
// Design: a block of 256 threads owns C = 8 columns for every sweep
// (more columns a block: fewer blocks; fewer: more reads of T); thread j
// owns states j, j + 256,
// ... (SPT = ceil(Sp / 256) of them) of all C columns, so every element
// of T it reads serves C accumulators in registers, and the C values of
// v[i, :] it needs are C / 4 broadcast vector loads from shared memory
// ([Sp][C], state-major).  The column maxima go through a warp reduction
// and a [warps][C] exchange.
//   resident  the first n_s rows of T are staged into shared memory once,
//             the rest read through the read-only path every sweep (as
//             scan_tile.cuh splits the matrix);
//   blocks    each sweep stages T in blocks of blk rows through shared
//             memory with cp.async: a two-slot ring where two blocks fit
//             (block k + 1 in flight while block k is folded into the
//             running max), else one slot.
//
// Numerics: each candidate is one correctly rounded add, the max is
// exact and the renormalization one subtraction, so both kernels equal
// the plain version (ops/cuda_kernels.maxplus_sweeps_plain) and the JAX
// tool's _ref_sweep bit for bit, whatever order they fold rows in.
//
// All global index arithmetic is 64-bit.

#include "common.cuh"

namespace {

constexpr int kMpThreads = 256;
constexpr int kMpWarps = kMpThreads / 32;
constexpr int kSweeps = 64;  // STEPS of the JAX tool
constexpr int kCols = 8;     // columns of v a block owns

// The block's columns in shared memory and the column-max exchange.
//   s_v   [Sp][C]       the columns, state-major
//   s_red [warps][C]    per-warp column maxima
template <int SPT, int C>
struct MpTile {
  float acc[SPT][C];

  // acc = max over the rows i in [i0, i1) of s_v[i][c] + row(i)[j_q]
  // (kLdg: the rows lie in global memory and go through the read-only
  // path)
  template <bool kLdg, typename Row>
  __device__ __forceinline__ void fold(const float* s_v, int i0, int i1,
                                       Row row, int Sp) {
    const int tid = threadIdx.x;
#pragma unroll 4
    for (int i = i0; i < i1; ++i) {
      float pv[C];
#pragma unroll
      for (int c = 0; c < C; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(s_v + i * C + c);
        pv[c] = x.x;
        pv[c + 1] = x.y;
        pv[c + 2] = x.z;
        pv[c + 3] = x.w;
      }
      const float* r = row(i);
#pragma unroll
      for (int q = 0; q < SPT; ++q) {
        const int j = tid + q * kMpThreads;
        const float tv = j < Sp ? (kLdg ? __ldg(r + j) : r[j]) : 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[q][c] = fmaxf(acc[q][c], pv[c] + tv);
      }
    }
  }

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int q = 0; q < SPT; ++q)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[q][c] = -INFINITY;
  }

  // v <- acc - max_j acc (per column), written back to s_v.  Call with
  // the whole block after the fold.
  __device__ __forceinline__ void renorm(float* s_v, float* s_red,
                                         int Sp) {
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float m = -INFINITY;
#pragma unroll
      for (int q = 0; q < SPT; ++q)
        if (tid + q * kMpThreads < Sp) m = fmaxf(m, acc[q][c]);
      m = warp_max(m);
      if (lane == 0) s_red[warp * C + c] = m;
    }
    __syncthreads();  // every read of s_v by this sweep is done
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float m = s_red[c];
#pragma unroll
      for (int w = 1; w < kMpWarps; ++w) m = fmaxf(m, s_red[w * C + c]);
#pragma unroll
      for (int q = 0; q < SPT; ++q) {
        const int j = tid + q * kMpThreads;
        if (j < Sp) s_v[j * C + c] = acc[q][c] - m;
      }
    }
    __syncthreads();  // s_v is the next sweep's input; s_red is free
  }
};

// Load the block's columns [col0, col0 + C) of v into s_v (0 past Bg).
template <int C>
__device__ __forceinline__ void load_cols(float* s_v, const float* v,
                                          int Sp, int64_t Bg,
                                          int64_t col0) {
  for (int n = threadIdx.x; n < Sp * C; n += blockDim.x) {
    const int i = n / C, c = n % C;
    const int64_t b = col0 + c;
    s_v[n] = b < Bg ? v[(int64_t)i * Bg + b] : 0.0f;
  }
}

template <int C>
__device__ __forceinline__ void store_cols(float* out, const float* s_v,
                                           int Sp, int64_t Bg,
                                           int64_t col0) {
  for (int n = threadIdx.x; n < Sp * C; n += blockDim.x) {
    const int i = n / C, c = n % C;
    const int64_t b = col0 + c;
    if (b < Bg) out[(int64_t)i * Bg + b] = s_v[n];
  }
}

// K9 A: T's first n_s rows in shared memory, the rest read in place.
template <int SPT, int C>
__global__ void __launch_bounds__(kMpThreads)
    maxplus_resident_kernel(const float* __restrict__ v,
                            const float* __restrict__ T,
                            float* __restrict__ out, int Sp, int64_t Bg,
                            int n_s) {
  extern __shared__ __align__(16) float smem[];
  float* s_v = smem;                      // [Sp][C]
  float* s_red = s_v + Sp * C;            // [warps][C]
  float* s_T = s_red + kMpWarps * C;      // [n_s][Sp]
  const int64_t col0 = (int64_t)blockIdx.x * C;
  load_cols<C>(s_v, v, Sp, Bg, col0);
  stage(s_T, T, (int64_t)n_s * Sp);
  __syncthreads();
  MpTile<SPT, C> tl;
  for (int s = 0; s < kSweeps; ++s) {
    tl.reset();
    tl.template fold<false>(s_v, 0, n_s,
                            [&](int i) { return s_T + i * Sp; }, Sp);
    tl.template fold<true>(s_v, n_s, Sp,
                           [&](int i) { return T + (int64_t)i * Sp; }, Sp);
    tl.renorm(s_v, s_red, Sp);
  }
  store_cols<C>(out, s_v, Sp, Bg, col0);
}

// K9 B: T staged in blocks of blk rows through shared memory: a
// two-slot ring where two blocks fit beside the columns (block k + 1 in
// flight while block k is folded), else one slot (n_slots = 1).
template <int SPT, int C>
__global__ void __launch_bounds__(kMpThreads)
    maxplus_blocks_kernel(const float* __restrict__ v,
                          const float* __restrict__ T,
                          float* __restrict__ out, int Sp, int64_t Bg,
                          int blk, int n_slots) {
  extern __shared__ __align__(16) float smem[];
  float* s_v = smem;                      // [Sp][C]
  float* s_red = s_v + Sp * C;            // [warps][C]
  float* s_buf = s_red + kMpWarps * C;    // [n_slots][blk][Sp]
  const int64_t col0 = (int64_t)blockIdx.x * C;
  load_cols<C>(s_v, v, Sp, Bg, col0);
  MpTile<SPT, C> tl;
  for (int s = 0; s < kSweeps; ++s) {
    tl.reset();
    for_each_staged_block(s_buf, T, Sp, blk, n_slots,
                          [&](const float* cur, int i0, int i1) {
                            tl.template fold<false>(
                                s_v, i0, i1,
                                [&](int i) { return cur + (i - i0) * Sp; },
                                Sp);
                          });
    tl.renorm(s_v, s_red, Sp);
  }
  store_cols<C>(out, s_v, Sp, Bg, col0);
}

size_t mp_base_floats(int Sp, int C) {
  return (size_t)Sp * C + (size_t)kMpWarps * C;
}

template <int SPT, int C>
int launch_resident(const float* v, const float* T, float* out, int Sp,
                    int64_t Bg, cudaStream_t stream) {
  const size_t base = mp_base_floats(Sp, C);
  const int64_t room = kSmemLimit / 4 - (int64_t)base;
  const int n_s = room / Sp < Sp ? (int)(room / Sp) : Sp;
  const size_t smem = sizeof(float) * (base + (size_t)n_s * Sp);
  cudaError_t err = allow_smem(maxplus_resident_kernel<SPT, C>, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t grid = (Bg + C - 1) / C;
  maxplus_resident_kernel<SPT, C>
      <<<(unsigned)grid, kMpThreads, smem, stream>>>(v, T, out, Sp, Bg,
                                                     n_s);
  return (int)cudaGetLastError();
}

template <int SPT, int C>
int launch_blocks(const float* v, const float* T, float* out, int Sp,
                  int64_t Bg, int blk, cudaStream_t stream) {
  const size_t base = mp_base_floats(Sp, C);
  const size_t two = sizeof(float) * (base + 2 * (size_t)blk * Sp);
  const int n_slots = two <= (size_t)kSmemLimit ? 2 : 1;
  const size_t smem = sizeof(float) * (base + n_slots * (size_t)blk * Sp);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(maxplus_blocks_kernel<SPT, C>, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t grid = (Bg + C - 1) / C;
  maxplus_blocks_kernel<SPT, C>
      <<<(unsigned)grid, kMpThreads, smem, stream>>>(v, T, out, Sp, Bg,
                                                     blk, n_slots);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// blk = 0: the resident layout; else the blocks layout at blk rows.
int tehmm_maxplus_sweeps(const void* v, const void* T, void* out, int Sp,
                         int64_t Bg, int blk, void* stream) {
  if (Sp < 1 || Sp > 4 * kMpThreads || blk < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* vf = (const float*)v;
  const float* tf = (const float*)T;
  float* of = (float*)out;
  const int spt = (Sp + kMpThreads - 1) / kMpThreads;
  if (blk == 0) {
    if (spt == 1) return launch_resident<1, kCols>(vf, tf, of, Sp, Bg, st);
    if (spt == 2) return launch_resident<2, kCols>(vf, tf, of, Sp, Bg, st);
    return launch_resident<4, kCols>(vf, tf, of, Sp, Bg, st);
  }
  if (spt == 1) return launch_blocks<1, kCols>(vf, tf, of, Sp, Bg, blk, st);
  if (spt == 2) return launch_blocks<2, kCols>(vf, tf, of, Sp, Bg, blk, st);
  return launch_blocks<4, kCols>(vf, tf, of, Sp, Bg, blk, st);
}

}  // extern "C"
