// Hand-written Hopper (sm_90a) kernels for the streaming scans over a
// precomputed observation tensor: the obs-space Viterbi value sweep and
// the probability-space forward and backward of the E-step engine
// "cuda_v3".
//
// Built with viterbi.cu, em_estep.cu and posterior.cu into one shared
// library with a plain C interface (tehmm_tpu_torch/ops/cuda_kernels.py),
// loaded with ctypes.  Every entry point launches on the stream it is
// given, allocates nothing and returns the cudaGetLastError() that follows
// its launch.
//
// Kernels and the TPU kernels they replace
// (tehmm_tpu/ops/pallas_kernels.py):
//
//   viterbi_values_kernel  K5, _make_viterbi_kernel_v3(carry_mode=False)
//                          (:1284) under _viterbi_values_v3 (:1374) and
//                          viterbi_pallas_v3 (:1453)
//   fwd_prob_kernel        K6a, _forward_kernel_v3 (:627) under
//                          forward_prob_pallas_v3 (:815)
//   bwd_prob_kernel        K6b, _backward_kernel_v3 (:712) under
//                          backward_prob_pallas_v3 (:885)
//
// What they compute: a scan over the positions of every batch row whose
// step is an S x S matrix-vector product in a semiring (max-plus for K5,
// sum-product in float32 for K6) on the row's state vector, a combination
// with the position's observation row, and a renormalization by the max
// over states; positions at or past a row's length carry the state vector
// through.  obs / obs_p, the outputs and the lengths keep the layout the
// callers use, [B, L, S] and [B]; the backward kernel walks it from the
// end (no relayout, no reversed copy, no padded normalizer block).
//
// What bounds them on an H100: at S = 20 the bytes (obs read once, rows
// written once); at S = 256 the 2 * S * S float32 operations per position
// (about 0.5 ms for 256 rows of 1024 against 0.16 ms of bytes), and in
// practice the chain of L dependent steps, each an S-term FMA (or
// add-and-max) chain per output plus block-wide max reductions.
//
// Design: a block of 256 threads owns R = NG * RT batch rows for the whole
// scan, NG = 256 / S row groups of S threads.  Thread (g, j) owns state j
// of the RT rows of group g and keeps their accumulators in registers,
// four partial results each, so every transition element it reads is used
// RT times and four independent chains hide each other's latency.  The
// rows' state vectors live in shared memory, state-major ([S][R]), so the
// RT values a thread needs for state i are one vector load that its whole
// group shares (a broadcast).  The transition matrix is read as M[i][j]
// with j across the threads (conflict-free); the backward kernel is handed
// the transposed matrix, so the three share one product loop.  As many
// rows of M as fit beside the vectors stay in shared memory (all of them
// up to S = 239 at RT = 2; a multiple of 4 otherwise); at S = 256 the
// matrix is 256 KB, over the 227 KB a block may have, and the remaining
// rows are read through the read-only path from global memory, where they
// stay L1/L2-resident (every block reads the same few tens of KB every
// step).  RT is 1 where the card holds the grid in one wave (the occupancy
// API says how many blocks an SM holds), else 2: a second row per thread
// buys reuse only when there are more rows than the card can hold at
// once.  The observation rows are loaded ahead of their use (one step
// ahead in the forward scan, where the row is needed after the product;
// two in the backward kernel, where it is needed first), so their latency
// hides behind the steps.  Steps past the longest row of a block skip the
// product and only write the carried rows.
//
// Numerics: K5 is float32 add, subtract and max only, so it agrees bit for
// bit with the plain torch version (ops/cuda_kernels.viterbi_values_plain)
// and its paths are dp.viterbi's.  K6 sums each product in a fixed order,
// four interleaved FMA chains added pairwise, that depends on S alone (no
// atomics, no tensor cores, no TF32): two runs, at either RT, give the
// same bits, and the result is within float32 rounding of the plain
// version's matrix product.  The observation multiply and
// the 1/m scale are roundings of their own (u * (1 / m), never u / m),
// the max floors are 1e-37, rows of length 0 stay all-ones (K6) or
// all-zero (K5) with zero normalizers, and scaled probabilities that
// underflow float32 flush toward zero, all as in the TPU kernels.
//
// All global index arithmetic is 64-bit.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;          // threads per block; S <= kThreads
constexpr int kWarps = kThreads / 32;
constexpr float kProbFloor = 1e-37f;

// K6: scaled probabilities, sum-product.
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

// K5: log values, max-plus.
struct MaxPlusOps {
  static constexpr float kCarry0 = 0.0f;
  static constexpr float kFloor = kLogZero;
  __device__ static float init() { return -INFINITY; }
  __device__ static float step(float acc, float v, float t) {
    return fmaxf(acc, v + t);
  }
  __device__ static float combine(float a, float b) { return fmaxf(a, b); }
  __device__ static float emit(float base, float o) { return base + o; }
  __device__ static float renorm(float u, float m) { return u - m; }
  __device__ static float increment(float m) { return m; }
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

// The forward scan of K5 and K6a.  Position 0 takes ``start``; position
// t >= 1 the product of the carried vector with M = trans; then the
// observation row is combined in, the row renormalized by its max, and
// the row and the normalizer's increment written out.
template <int RT, typename Ops>
__device__ __forceinline__ void forward_scan(
    const float* __restrict__ obs, const int32_t* __restrict__ lens,
    const float* __restrict__ start, const float* __restrict__ mat,
    float* __restrict__ rows_out, float* __restrict__ dm_out, int64_t B,
    int64_t L, int S, int n_s, float* smem) {
  Tile<RT> tl(smem, mat, lens, B, L, S, n_s);
  const int j = tl.j;
  float p[RT], o_next[RT];
#pragma unroll
  for (int k = 0; k < RT; ++k) {
    p[k] = Ops::kCarry0;
    if (tl.active) tl.s_p[j * tl.R + tl.row + k] = p[k];
    o_next[k] = tl.len[k] > 0 ? obs[(tl.b0 + k) * L * S + j] : 0.0f;
  }
  const float start_j = tl.active ? start[j] : 0.0f;
  __syncthreads();

  for (int64_t t = 0; t < L; ++t) {
    if (t >= tl.max_len) {
      // every row of the block is past its end: carried rows, zeros
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        if (!tl.live[k]) continue;
        const int64_t pos = (tl.b0 + k) * L + t;
        rows_out[pos * S + j] = p[k];
        if (j == 0) dm_out[pos] = 0.0f;
      }
      continue;
    }
    float o[RT], u[RT];
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      o[k] = o_next[k];
      o_next[k] = t + 1 < tl.len[k]
                      ? obs[((tl.b0 + k) * L + t + 1) * S + j]
                      : 0.0f;
    }
    if (t == 0) {
#pragma unroll
      for (int k = 0; k < RT; ++k) u[k] = start_j;
    } else if (tl.active) {
      tl.template product<Ops>(mat, S, n_s, u);
    }
    if (tl.active) {
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        u[k] = Ops::emit(u[k], o[k]);
        tl.s_u[(tl.row + k) * S + j] = u[k];
      }
    }
    __syncthreads();
    tl.rows_max(S, Ops::kFloor);
    __syncthreads();
    if (tl.active) {
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        const float m = tl.s_m[tl.row + k];
        const bool valid = t < tl.len[k];
        if (valid) p[k] = Ops::renorm(u[k], m);
        tl.s_p[j * tl.R + tl.row + k] = p[k];
        if (tl.live[k]) {
          const int64_t pos = (tl.b0 + k) * L + t;
          rows_out[pos * S + j] = p[k];
          if (j == 0) dm_out[pos] = valid ? Ops::increment(m) : 0.0f;
        }
      }
    }
    __syncthreads();
  }
}

// K5: max-normalized Viterbi value rows and their normalizers.
template <int RT>
__global__ void __launch_bounds__(kThreads)
    viterbi_values_kernel(const float* __restrict__ obs,
                          const int32_t* __restrict__ lens,
                          const float* __restrict__ log_start,
                          const float* __restrict__ log_trans,
                          float* __restrict__ v_out,
                          float* __restrict__ dm_out, int64_t B, int64_t L,
                          int S, int n_s) {
  extern __shared__ __align__(16) float smem[];
  forward_scan<RT, MaxPlusOps>(obs, lens, log_start, log_trans, v_out,
                               dm_out, B, L, S, n_s, smem);
}

// K6a: scaled forward probabilities (per-position max 1) and log m.
template <int RT>
__global__ void __launch_bounds__(kThreads)
    fwd_prob_kernel(const float* __restrict__ obs_p,
                    const int32_t* __restrict__ lens,
                    const float* __restrict__ start_p,
                    const float* __restrict__ trans_p,
                    float* __restrict__ alpha_out,
                    float* __restrict__ dm_out, int64_t B, int64_t L, int S,
                    int n_s) {
  extern __shared__ __align__(16) float smem[];
  forward_scan<RT, ProbOps>(obs_p, lens, start_p, trans_p, alpha_out,
                            dm_out, B, L, S, n_s, smem);
}

// K6b: scaled backward probabilities.  beta[L - 1] is all-ones; beta[t]
// steps back from t + 1 where t + 1 < length (x = obs_p[t + 1] * b,
// normalized by its max; s = trans x, normalized by its max), and carries
// beta[t + 1] elsewhere.  ``trans_t`` is the transposed matrix, so that
// s_i = sum_j trans_t[j][i] x_j runs through the shared product loop.
template <int RT>
__global__ void __launch_bounds__(kThreads)
    bwd_prob_kernel(const float* __restrict__ obs_p,
                    const int32_t* __restrict__ lens,
                    const float* __restrict__ trans_t,
                    float* __restrict__ beta_out, int64_t B, int64_t L,
                    int S, int n_s) {
  extern __shared__ __align__(16) float smem[];
  Tile<RT> tl(smem, trans_t, lens, B, L, S, n_s);
  const int j = tl.j;
  // A step consumes its observation row first thing, so the rows are
  // loaded two steps ahead: one step ahead leaves the load's latency on
  // the chain.
  float b[RT], o_next[RT], o_next2[RT];
#pragma unroll
  for (int k = 0; k < RT; ++k) {
    b[k] = 1.0f;
    // the first step that runs reads position max_len - 1
    const int64_t t1 = tl.max_len - 1;
    o_next[k] = t1 >= 1 && t1 < tl.len[k]
                    ? obs_p[((tl.b0 + k) * L + t1) * S + j]
                    : 0.0f;
    o_next2[k] = t1 >= 2 && t1 - 1 < tl.len[k]
                     ? obs_p[((tl.b0 + k) * L + t1 - 1) * S + j]
                     : 0.0f;
  }

  for (int64_t t = L - 1; t >= 0; --t) {
    if (t + 1 < tl.max_len) {
      float o[RT], x[RT], s[RT];
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        o[k] = o_next[k];
        o_next[k] = o_next2[k];
        o_next2[k] = t >= 2 && t - 1 < tl.len[k]
                         ? obs_p[((tl.b0 + k) * L + t - 1) * S + j]
                         : 0.0f;
      }
      if (tl.active) {
#pragma unroll
        for (int k = 0; k < RT; ++k) {
          x[k] = __fmul_rn(o[k], b[k]);
          tl.s_u[(tl.row + k) * S + j] = x[k];
        }
      }
      __syncthreads();
      tl.rows_max(S, kProbFloor);
      __syncthreads();
      if (tl.active) {
#pragma unroll
        for (int k = 0; k < RT; ++k)
          tl.s_p[j * tl.R + tl.row + k] =
              ProbOps::renorm(x[k], tl.s_m[tl.row + k]);
      }
      __syncthreads();
      if (tl.active) {
        tl.template product<ProbOps>(trans_t, S, n_s, s);
#pragma unroll
        for (int k = 0; k < RT; ++k) tl.s_u[(tl.row + k) * S + j] = s[k];
      }
      __syncthreads();
      tl.rows_max(S, kProbFloor);
      __syncthreads();
      if (tl.active) {
#pragma unroll
        for (int k = 0; k < RT; ++k)
          if (t + 1 < tl.len[k])
            b[k] = ProbOps::renorm(s[k], tl.s_m[tl.row + k]);
      }
    }
#pragma unroll
    for (int k = 0; k < RT; ++k)
      if (tl.live[k]) beta_out[((tl.b0 + k) * L + t) * S + j] = b[k];
  }
}

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

extern "C" {

int tehmm_viterbi_values(const void* obs, const void* lens,
                         const void* log_start, const void* log_trans,
                         void* v_out, void* dm_out, int64_t B, int64_t L,
                         int S, void* stream) {
  return launch_scan(viterbi_values_kernel<1>, viterbi_values_kernel<2>, B,
                     S, stream, (const float*)obs, (const int32_t*)lens,
                     (const float*)log_start, (const float*)log_trans,
                     (float*)v_out, (float*)dm_out, B, L, S);
}

int tehmm_fwd_prob(const void* obs_p, const void* lens, const void* start_p,
                   const void* trans_p, void* alpha_out, void* dm_out,
                   int64_t B, int64_t L, int S, void* stream) {
  return launch_scan(fwd_prob_kernel<1>, fwd_prob_kernel<2>, B, S, stream,
                     (const float*)obs_p, (const int32_t*)lens,
                     (const float*)start_p, (const float*)trans_p,
                     (float*)alpha_out, (float*)dm_out, B, L, S);
}

int tehmm_bwd_prob(const void* obs_p, const void* lens, const void* trans_t,
                   void* beta_out, int64_t B, int64_t L, int S,
                   void* stream) {
  return launch_scan(bwd_prob_kernel<1>, bwd_prob_kernel<2>, B, S, stream,
                     (const float*)obs_p, (const int32_t*)lens,
                     (const float*)trans_t, (float*)beta_out, B, L, S);
}

}  // extern "C"
