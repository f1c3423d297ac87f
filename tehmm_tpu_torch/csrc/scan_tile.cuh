// The block-tile machinery the scans over a precomputed observation
// tensor share (streaming.cu: K5, K6a, K6b; scans.cu: K7a/K8a, K7b/K8b,
// K8c): a block of kThreads threads owns R = NG * RT batch rows for the
// whole scan, NG = kThreads / S row groups of S threads, thread (g, j)
// state j of the RT rows of group g (one or two rows per thread, chosen by
// launch_scan from the occupancy API); the rows' state vectors live in
// shared memory, state-major, beside as many rows of the S x S matrix as
// fit (the rest are read through the read-only path).  streaming.cu's
// header gives the design and what bounds it.  Everything is in an
// anonymous namespace: each source gets its own copy.

#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;          // threads per block; S <= kThreads
constexpr int kWarps = kThreads / 32;
constexpr float kProbFloor = 1e-37f;

// Sum-product in float32: K6's scaled probabilities, and the products of
// the log-space scans (scans.cu) on exp(state vector).
struct ProbOps {
  static constexpr float kCarry0 = 1.0f;  // the carry before position 0
  static constexpr float kFloor = kProbFloor;
  __device__ static float init() { return 0.0f; }
  __device__ static float step(float acc, float p, float t) {
    return fmaf(p, t, acc);
  }
  __device__ static float combine(float a, float b) {
    return __fadd_rn(a, b);
  }
  __device__ static float emit(float base, float o) {
    return __fmul_rn(base, o);
  }
  __device__ static float renorm(float u, float m) {
    return __fmul_rn(u, __fdiv_rn(1.0f, m));
  }
  __device__ static float increment(float m) { return logf(m); }
};

// The RT state-vector values of one state for this thread's rows.
template <int RT>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[RT]) {
  static_assert(RT == 1 || RT == 2, "one or two rows per thread");
  if constexpr (RT == 1) {
    v[0] = p[0];
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  }
}

// A block's shared memory and this thread's place in it.
//   s_p  [S][R]   state vectors, state-major
//   s_u  [R][S]   unnormalized rows, for the max reductions
//   s_m  [R]      row maxima
//   s_len[R + 1]  row lengths, then the block's longest
//   s_T  [n_s][S] the first n_s rows of the matrix
template <int RT>
struct Tile {
  float* s_p;
  float* s_u;
  float* s_m;
  int* s_len;
  float* s_T;
  int R;         // rows of the block
  int j;         // this thread's state
  int row;       // its first row within the block
  bool active;   // false for the threads past the last row group
  int64_t b0;    // its first batch row
  int len[RT];   // its rows' lengths (0 past the batch)
  bool live[RT]; // its rows exist in the batch
  int max_len;   // longest row of the block

  __device__ Tile(float* smem, const float* __restrict__ mat,
                  const int32_t* __restrict__ lens, int64_t B, int64_t L,
                  int S, int n_s) {
    const int NG = kThreads / S;
    R = NG * RT;
    s_p = smem;
    s_u = s_p + S * R;
    s_m = s_u + R * S;
    s_len = reinterpret_cast<int*>(s_m + R);
    s_T = reinterpret_cast<float*>(s_len + R + 1);
    const int tid = threadIdx.x;
    j = tid % S;
    const int g = tid / S;
    active = g < NG;
    row = g * RT;
    stage(s_T, mat, (int64_t)n_s * S);
    const int64_t block_row0 = (int64_t)blockIdx.x * R;
    if (tid == 0) s_len[R] = 0;
    __syncthreads();
    for (int r = tid; r < R; r += kThreads) {
      const int64_t b = block_row0 + r;
      int64_t n = b < B ? lens[b] : 0;  // clamped to [0, L]
      n = n < 0 ? 0 : (n > L ? L : n);
      s_len[r] = (int)n;
      atomicMax(&s_len[R], (int)n);
    }
    __syncthreads();
    max_len = s_len[R];
    b0 = block_row0 + row;
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      len[k] = active ? s_len[row + k] : 0;
      live[k] = active && b0 + k < B;
    }
  }

  // s_m[r] = max(max_j s_u[r][j], floor) for every row of the block
  // (warp w takes rows w, w + 8, ...).  Call with the whole block.
  __device__ void rows_max(int S, float floor) const {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    for (int r = warp; r < R; r += kWarps) {
      float m = -INFINITY;
      for (int jj = lane; jj < S; jj += 32) m = fmaxf(m, s_u[r * S + jj]);
      m = warp_max(m);
      if (lane == 0) s_m[r] = fmaxf(m, floor);
    }
  }

  // acc[k] = (+ or max)_i op(s_p[i][row + k], M[i][j]): rows below n_s
  // from shared memory, the rest through the read-only path.  Four
  // partial results per row, over i = 0, 1, 2, 3 (mod 4), combined as
  // (a0 + a1) + (a2 + a3): four independent chains a thread can overlap,
  // in an order that depends on S alone (n_s is a multiple of 4 unless it
  // is S, and the last S % 4 terms all go to a0).
  template <typename Ops>
  __device__ void product(const float* __restrict__ mat, int S, int n_s,
                          float (&acc)[RT]) const {
    float a[RT][4];
#pragma unroll
    for (int k = 0; k < RT; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[k][q] = Ops::init();
    const float* p = s_p + row;
    const int S4 = S & ~3;
    const int n4 = n_s < S ? n_s : S4;
    float pv[RT];
    for (int i = 0; i < n4; i += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float tv = s_T[(i + q) * S + j];
        load_rows<RT>(p + (i + q) * R, pv);
#pragma unroll
        for (int k = 0; k < RT; ++k) a[k][q] = Ops::step(a[k][q], pv[k], tv);
      }
    }
    for (int i = n4; i < S4; i += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float tv = __ldg(mat + (int64_t)(i + q) * S + j);
        load_rows<RT>(p + (i + q) * R, pv);
#pragma unroll
        for (int k = 0; k < RT; ++k) a[k][q] = Ops::step(a[k][q], pv[k], tv);
      }
    }
    for (int i = S4; i < S; ++i) {
      const float tv =
          i < n_s ? s_T[i * S + j] : __ldg(mat + (int64_t)i * S + j);
      load_rows<RT>(p + i * R, pv);
#pragma unroll
      for (int k = 0; k < RT; ++k) a[k][0] = Ops::step(a[k][0], pv[k], tv);
    }
#pragma unroll
    for (int k = 0; k < RT; ++k)
      acc[k] = Ops::combine(Ops::combine(a[k][0], a[k][1]),
                            Ops::combine(a[k][2], a[k][3]));
  }
};

// ---------------------------------------------------------------------
// host side: rows per thread, shared-memory split, launch
// ---------------------------------------------------------------------

struct Plan {
  int n_s;       // matrix rows kept in shared memory
  size_t smem;   // dynamic shared memory, bytes
  int64_t grid;  // blocks
};

inline Plan make_plan(int S, int64_t B, int rt) {
  const int R = (kThreads / S) * rt;
  const int64_t tile = 2 * (int64_t)S * R + 2 * R + 1;
  const int64_t room = kSmemLimit / 4 - tile;
  Plan pl;
  // every matrix row, or a multiple of 4 of them (Tile::product)
  pl.n_s = room / S < S ? (int)(room / S) & ~3 : S;
  pl.smem = sizeof(float) * (size_t)(tile + (int64_t)pl.n_s * S);
  pl.grid = (B + R - 1) / R;
  return pl;
}

// Opts ``kernel`` (its RT = rt) in to its shared memory and says whether
// the card holds its whole grid at once.
template <typename Fn>
cudaError_t plan_for(Fn kernel, int S, int64_t B, int rt, Plan* pl,
                     bool* one_wave) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *pl = make_plan(S, B, rt);
  err = allow_smem(kernel, pl->smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, pl->smem);
  *one_wave = pl->grid <= (int64_t)per_sm * sms;
  return err;
}

// Launches ``one`` (one row per thread) where the card holds its grid in
// one wave, else ``two`` (two rows per thread).
template <typename Fn, typename... Args>
int launch_scan(Fn one, Fn two, int64_t B, int S, void* stream,
                Args... args) {
  if (S < 1 || S > kThreads) return (int)cudaErrorInvalidValue;
  Plan pl;
  bool one_wave = false;
  cudaError_t err = plan_for(one, S, B, 1, &pl, &one_wave);
  if (err != cudaSuccess) return (int)err;
  Fn kernel = one;
  if (!one_wave) {
    kernel = two;
    err = plan_for(two, S, B, 2, &pl, &one_wave);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)pl.grid, kThreads, pl.smem, (cudaStream_t)stream>>>(
      args..., pl.n_s);
  return (int)cudaGetLastError();
}

}  // namespace
