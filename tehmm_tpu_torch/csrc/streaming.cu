// Hand-written Hopper (sm_90a) kernels for the streaming scans over a
// precomputed observation tensor: the obs-space Viterbi value sweep and
// the probability-space forward and backward of the E-step engine
// "cuda_v3".
//
// Built with viterbi.cu, em_estep.cu, posterior.cu and scans.cu into one
// shared library with a plain C interface
// (tehmm_tpu_torch/ops/cuda_kernels.py), loaded with ctypes.  Every entry point launches on the stream it is
// given, allocates nothing and returns the cudaGetLastError() that follows
// its launch.
//
// Kernels and the TPU kernels they replace
// (tehmm_tpu/ops/pallas_kernels.py):
//
//   viterbi_values_kernel  K5, _make_viterbi_kernel_v3(carry_mode=False)
//                          (:1284) under _viterbi_values_v3 (:1374) and
//                          viterbi_pallas_v3 (:1453); in carry mode K3,
//                          viterbi_chunk_values_pallas (:1492) past 239
//                          states
//   viterbi_values_cluster_kernel
//                          the same function, carry mode included, from
//                          257 to 1024 states on the cluster tile
//                          (scan_cluster.cuh), with the same bits
//   fwd_prob_kernel        K6a, _forward_kernel_v3 (:627) under
//                          forward_prob_pallas_v3 (:815)
//   bwd_prob_kernel        K6b, _backward_kernel_v3 (:712) under
//                          backward_prob_pallas_v3 (:885)
//   fwd_prob_cluster_kernel, bwd_prob_cluster_kernel
//                          the same two functions from 257 to 1024
//                          states on the cluster tile, with the same bits
//   fwd_prob_lanes_kernel, bwd_prob_lanes_kernel
//                          the same two functions to 32 states, a warp a
//                          row (scan_rows.cuh), with the same bits
//   fwd_prob_rows_kernel, bwd_prob_rows_kernel
//                          the same two functions from 33 to 256 states
//                          (scan_rows.cuh), with the same bits
//   viterbi_values_lanes_kernel, viterbi_values_rows_kernel
//                          K5 and its carry mode to 32 states (K3's
//                          max-plus lanes step) and from 33 to 256
//                          (scan_rows.cuh), with the same bits
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
// add-and-max) chain per output plus block-wide max reductions.  Past 256
// states, on the staged tile, each block also re-reads the whole matrix
// from L2 every step (4 MB at S = 1024), which sets the time there; on the
// cluster tile the product over a block's slice (R S^2 / C FMAs, or
// add-and-max, a block a step) and two exchanges across the cluster a step
// (K6b: three).
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
// product and only write the carried rows.  Past 256 states a thread owns
// 2 or 4 states of every row of its block, the block 2 or 4 rows, and the
// matrix is staged block by block through shared memory every step, each
// staged block serving all the rows (scan_tile.cuh).  From 257 to 1024
// states every kernel here runs the cluster tile instead
// (scan_cluster.cuh, which says why and how: each block keeps its column
// slice of the matrix resident; K5's state vector holds the renormalized
// log values themselves, K6's the scaled probabilities); the staged tile
// is kept for comparison and past SCAN_CLUSTER_MAX_STATES.  To 256 states
// K6a and K6b run their own kernels instead (scan_rows.cuh, which says
// why and how: the lanes step to 32 states, a warp a row with no shared
// memory or barrier in the chain; the rows kernels beyond, a float4 of the
// matrix for 4 R FMAs, all of it on chip, two barriers a step in K6a and
// three in K6b); so do K5 and its carry mode (K3's max-plus lanes step,
// the rows kernels' max-plus product, two barriers a step); the block
// tile is kept for comparison.  The entries take the kernel the caller
// names, ``tile`` (scan_tile.cuh ScanTile).
//
// K3's carry mode (tehmm_viterbi_carry_tile) is K5 started from each
// row's carry instead of log_start: every position, 0 included, applies
// the max-plus step; the value rows and/or the last vector go out.
//
// Numerics: K5 is float32 add, subtract and max only, so it agrees bit for
// bit with the plain torch version (ops/cuda_kernels.viterbi_values_plain)
// and its paths are dp.viterbi's.  K6 sums each product in a fixed order,
// four interleaved FMA chains added pairwise, that depends on S alone (no
// atomics, no tensor cores, no TF32): two runs, at either RT, on either
// tile past 256 states and on K6's own kernels to 256 states (at any R),
// give the same bits, and the result is
// within float32 rounding of the plain version's matrix product.  The
// observation multiply and the 1/m scale are roundings of their own
// (u * (1 / m), never u / m), the max floors are 1e-37, rows of length 0
// stay all-ones (K6) or all-zero (K5) with zero normalizers, and scaled
// probabilities that underflow float32 flush toward zero, all as in the
// TPU kernels.
//
// All global index arithmetic is 64-bit.

#include "scan_cluster.cuh"
#include "scan_rows.cuh"

namespace {

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
  // the state vector holds the log values themselves
  __device__ static float from_log(float v) { return v; }
};

// The forward scan of K5 and K6a, and K3's carry mode.  Position 0 takes
// ``start``; position t >= 1 the product of the carried vector with
// M = trans; then the observation row is combined in, the row
// renormalized by its max, and the row and the normalizer's increment
// written out.  With ``carry_in`` (K3) the carried vector starts as the
// row's carry and every position, 0 included, applies the product;
// ``rows_out``, ``dm_out`` and ``carry_out`` (the last vector) may each be
// nullptr.
template <int SPT, int RT, typename Ops>
__device__ __forceinline__ void forward_scan(
    const float* __restrict__ obs, const int32_t* __restrict__ lens,
    const float* __restrict__ start, const float* __restrict__ carry_in,
    const float* __restrict__ mat, float* __restrict__ rows_out,
    float* __restrict__ dm_out, float* __restrict__ carry_out, int64_t B,
    int64_t L, int S, int n_s, int n_slots, float* smem) {
  Tile<SPT, RT> tl(smem, mat, lens, B, L, S, n_s);
  const bool carried = carry_in != nullptr;
  float p[SPT][RT], o_next[SPT][RT], start_j[SPT];
#pragma unroll
  for (int q = 0; q < SPT; ++q) {
    const int jq = tl.jq(q);
    const bool has = tl.has(q, S);
    start_j[q] = has && !carried ? start[jq] : 0.0f;
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      p[q][k] = carried && has && tl.live[k]
                    ? carry_in[(tl.b0 + k) * S + jq]
                    : Ops::kCarry0;
      if (has) tl.s_p[jq * tl.R + tl.row + k] = p[q][k];
      o_next[q][k] =
          has && tl.len[k] > 0 ? obs[(tl.b0 + k) * L * S + jq] : 0.0f;
    }
  }
  __syncthreads();

  for (int64_t t = 0; t < L; ++t) {
    if (t >= tl.max_len) {
      // every row of the block is past its end: carried rows, zeros
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        if (!tl.live[k]) continue;
        const int64_t pos = (tl.b0 + k) * L + t;
        if (rows_out != nullptr)
#pragma unroll
          for (int q = 0; q < SPT; ++q)
            if (tl.has(q, S)) rows_out[pos * S + tl.jq(q)] = p[q][k];
        if (tl.j == 0 && dm_out != nullptr) dm_out[pos] = 0.0f;
      }
      continue;
    }
    float o[SPT][RT], u[SPT][RT];
#pragma unroll
    for (int q = 0; q < SPT; ++q)
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        o[q][k] = o_next[q][k];
        o_next[q][k] = tl.has(q, S) && t + 1 < tl.len[k]
                           ? obs[((tl.b0 + k) * L + t + 1) * S + tl.jq(q)]
                           : 0.0f;
      }
    if (t == 0 && !carried) {
#pragma unroll
      for (int q = 0; q < SPT; ++q)
#pragma unroll
        for (int k = 0; k < RT; ++k) u[q][k] = start_j[q];
    } else if (tl.active) {
      tl.template product<Ops>(mat, S, n_s, n_slots, u);
    }
    if (tl.active) {
#pragma unroll
      for (int q = 0; q < SPT; ++q)
#pragma unroll
        for (int k = 0; k < RT; ++k) {
          if (!tl.has(q, S)) continue;
          u[q][k] = Ops::emit(u[q][k], o[q][k]);
          tl.s_u[(tl.row + k) * S + tl.jq(q)] = u[q][k];
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
        const int64_t pos = (tl.b0 + k) * L + t;
#pragma unroll
        for (int q = 0; q < SPT; ++q) {
          if (!tl.has(q, S)) continue;
          if (valid) p[q][k] = Ops::renorm(u[q][k], m);
          tl.s_p[tl.jq(q) * tl.R + tl.row + k] = p[q][k];
          if (tl.live[k] && rows_out != nullptr)
            rows_out[pos * S + tl.jq(q)] = p[q][k];
        }
        if (tl.live[k] && tl.j == 0 && dm_out != nullptr)
          dm_out[pos] = valid ? Ops::increment(m) : 0.0f;
      }
    }
    __syncthreads();
  }
  if (carry_out != nullptr) {
#pragma unroll
    for (int q = 0; q < SPT; ++q)
#pragma unroll
      for (int k = 0; k < RT; ++k)
        if (tl.has(q, S) && tl.live[k])
          carry_out[(tl.b0 + k) * S + tl.jq(q)] = p[q][k];
  }
}

// K5: max-normalized Viterbi value rows and their normalizers; with
// ``carry_in``, K3 (value rows and / or the final carry of one chunk).
template <int SPT, int RT>
__global__ void __launch_bounds__(kThreads)
    viterbi_values_kernel(const float* __restrict__ obs,
                          const int32_t* __restrict__ lens,
                          const float* __restrict__ log_start,
                          const float* __restrict__ carry_in,
                          const float* __restrict__ log_trans,
                          float* __restrict__ v_out,
                          float* __restrict__ dm_out,
                          float* __restrict__ carry_out, int64_t B,
                          int64_t L, int S, int n_s, int n_slots) {
  extern __shared__ __align__(16) float smem[];
  forward_scan<SPT, RT, MaxPlusOps>(obs, lens, log_start, carry_in,
                                    log_trans, v_out, dm_out, carry_out, B,
                                    L, S, n_s, n_slots, smem);
}

// The forward scan of K5 and K6a, and K3's carry mode, past 256 states on
// the cluster tile (scan_cluster.cuh): the function and the bits of
// forward_scan.  A step: the product over the block's slice of M = trans
// (at position 0 without a carry, ``start`` instead), the observation
// combined in, the cluster's row max (an exchange), the row renormalized
// by it on valid positions, the row into every block's state vector (a
// second).  A row of length 0 keeps its carry (Ops::kCarry0) with dm 0:
// position 0 is renormalized only where it is valid.  ``carry_in``,
// ``rows_out``, ``dm_out`` and ``carry_out`` as in forward_scan.
template <int R, typename Ops>
__device__ __forceinline__ void forward_cluster_scan(
    const float* __restrict__ obs, const int32_t* __restrict__ lens,
    const float* __restrict__ start, const float* __restrict__ carry_in,
    const float* __restrict__ mat, float* __restrict__ rows_out,
    float* __restrict__ dm_out, float* __restrict__ carry_out, int64_t B,
    int64_t L, int S, int n_res, float* smem) {
  using Tile = ClusterTile<R>;
  constexpr int kOwn = Tile::kOwn;
  Tile tl(smem, mat, lens, B, L, S, n_res, 1);
  const bool carried = carry_in != nullptr;
  int64_t cell[kOwn];
  float p[kOwn], o_next[kOwn];
  const float start_j = tl.has_col && !carried ? start[tl.gj] : 0.0f;
#pragma unroll
  for (int m = 0; m < kOwn; ++m) {
    cell[m] = tl.b0 + tl.own_k[m];
    p[m] = carried && tl.own_has[m] && tl.own_live[m]
               ? carry_in[cell[m] * S + tl.gj]
               : Ops::kCarry0;
    o_next[m] = tl.own_has[m] && tl.own_len[m] > 0
                    ? obs[cell[m] * L * S + tl.gj]
                    : 0.0f;
  }
  if (carried) tl.template fill_state<Ops>(carry_in, B);
  const bool writes_dm = tl.rank == 0 && tl.col == 0 && dm_out != nullptr;

  for (int64_t t = 0; t < L; ++t) {
    if (t >= tl.max_len) {
      // every row of the cluster is past its end: carried rows, zeros
#pragma unroll
      for (int m = 0; m < kOwn; ++m) {
        if (!tl.own_live[m]) continue;
        const int64_t pos = cell[m] * L + t;
        if (rows_out != nullptr && tl.own_has[m])
          rows_out[pos * S + tl.gj] = p[m];
        if (writes_dm) dm_out[pos] = 0.0f;
      }
      continue;
    }
    float o[kOwn], u[kOwn], mx[kOwn];
#pragma unroll
    for (int m = 0; m < kOwn; ++m) {
      o[m] = o_next[m];
      o_next[m] = tl.own_has[m] && t + 1 < tl.own_len[m]
                      ? obs[(cell[m] * L + t + 1) * S + tl.gj]
                      : 0.0f;
    }
    if (t == 0 && !carried) {
#pragma unroll
      for (int m = 0; m < kOwn; ++m) u[m] = start_j;
    } else {
      float s[R];
      tl.template product<Ops>(s);
      tl.own(s, u);
    }
#pragma unroll
    for (int m = 0; m < kOwn; ++m) u[m] = Ops::emit(u[m], o[m]);
    tl.template rows_max<0>(u, mx, Ops::kFloor);
#pragma unroll
    for (int m = 0; m < kOwn; ++m) {
      const bool valid = t < tl.own_len[m];
      if (valid) p[m] = Ops::renorm(u[m], mx[m]);
      if (!tl.own_live[m]) continue;
      const int64_t pos = cell[m] * L + t;
      if (rows_out != nullptr && tl.own_has[m])
        rows_out[pos * S + tl.gj] = p[m];
      if (writes_dm) dm_out[pos] = valid ? Ops::increment(mx[m]) : 0.0f;
    }
    tl.broadcast(p);
  }
  if (carry_out != nullptr) {
#pragma unroll
    for (int m = 0; m < kOwn; ++m)
      if (tl.own_has[m] && tl.own_live[m])
        carry_out[cell[m] * S + tl.gj] = p[m];
  }
  tl.finish();
}

// K5 and K3's carry mode past 256 states on the cluster tile: the
// function and the bits of viterbi_values_kernel (max-plus on the
// renormalized log values; a row of length 0 stays all-zero).
template <int R>
__global__ void __launch_bounds__(kClusterThreads, 1)
    viterbi_values_cluster_kernel(const float* __restrict__ obs,
                                  const int32_t* __restrict__ lens,
                                  const float* __restrict__ log_start,
                                  const float* __restrict__ carry_in,
                                  const float* __restrict__ log_trans,
                                  float* __restrict__ v_out,
                                  float* __restrict__ dm_out,
                                  float* __restrict__ carry_out, int64_t B,
                                  int64_t L, int S, int n_res) {
  extern __shared__ __align__(16) float smem[];
  forward_cluster_scan<R, MaxPlusOps>(obs, lens, log_start, carry_in,
                                      log_trans, v_out, dm_out, carry_out,
                                      B, L, S, n_res, smem);
}


// K6a: scaled forward probabilities (per-position max 1) and log m.
template <int SPT, int RT>
__global__ void __launch_bounds__(kThreads)
    fwd_prob_kernel(const float* __restrict__ obs_p,
                    const int32_t* __restrict__ lens,
                    const float* __restrict__ start_p,
                    const float* __restrict__ trans_p,
                    float* __restrict__ alpha_out,
                    float* __restrict__ dm_out, int64_t B, int64_t L, int S,
                    int n_s, int n_slots) {
  extern __shared__ __align__(16) float smem[];
  forward_scan<SPT, RT, ProbOps>(obs_p, lens, start_p, nullptr, trans_p,
                                 alpha_out, dm_out, nullptr, B, L, S, n_s,
                                 n_slots, smem);
}

// K6a past 256 states on the cluster tile: the function and the bits of
// fwd_prob_kernel.  The state vector holds p itself (no expf); a row of
// length 0 stays all-ones.
template <int R>
__global__ void __launch_bounds__(kClusterThreads, 1)
    fwd_prob_cluster_kernel(const float* __restrict__ obs_p,
                            const int32_t* __restrict__ lens,
                            const float* __restrict__ start_p,
                            const float* __restrict__ trans_p,
                            float* __restrict__ alpha_out,
                            float* __restrict__ dm_out, int64_t B,
                            int64_t L, int S, int n_res) {
  extern __shared__ __align__(16) float smem[];
  forward_cluster_scan<R, ProbOps>(obs_p, lens, start_p, nullptr, trans_p,
                                   alpha_out, dm_out, nullptr, B, L, S,
                                   n_res, smem);
}

// K6b: scaled backward probabilities.  beta[L - 1] is all-ones; beta[t]
// steps back from t + 1 where t + 1 < length (x = obs_p[t + 1] * b,
// normalized by its max; s = trans x, normalized by its max), and carries
// beta[t + 1] elsewhere.  ``trans_t`` is the transposed matrix, so that
// s_i = sum_j trans_t[j][i] x_j runs through the shared product loop.
template <int SPT, int RT>
__global__ void __launch_bounds__(kThreads)
    bwd_prob_kernel(const float* __restrict__ obs_p,
                    const int32_t* __restrict__ lens,
                    const float* __restrict__ trans_t,
                    float* __restrict__ beta_out, int64_t B, int64_t L,
                    int S, int n_s, int n_slots) {
  extern __shared__ __align__(16) float smem[];
  Tile<SPT, RT> tl(smem, trans_t, lens, B, L, S, n_s);
  // A step consumes its observation row first thing, so the rows are
  // loaded two steps ahead: one step ahead leaves the load's latency on
  // the chain.
  float b[SPT][RT], o_next[SPT][RT], o_next2[SPT][RT];
  // the first step that runs reads position max_len - 1
  const int64_t t1 = tl.max_len - 1;
#pragma unroll
  for (int q = 0; q < SPT; ++q)
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      const int64_t base = (tl.b0 + k) * L * S + tl.jq(q);
      b[q][k] = 1.0f;
      o_next[q][k] = tl.has(q, S) && t1 >= 1 && t1 < tl.len[k]
                         ? obs_p[base + t1 * S]
                         : 0.0f;
      o_next2[q][k] = tl.has(q, S) && t1 >= 2 && t1 - 1 < tl.len[k]
                          ? obs_p[base + (t1 - 1) * S]
                          : 0.0f;
    }

  for (int64_t t = L - 1; t >= 0; --t) {
    if (t + 1 < tl.max_len) {
      float o[SPT][RT], x[SPT][RT], s[SPT][RT];
#pragma unroll
      for (int q = 0; q < SPT; ++q)
#pragma unroll
        for (int k = 0; k < RT; ++k) {
          o[q][k] = o_next[q][k];
          o_next[q][k] = o_next2[q][k];
          o_next2[q][k] =
              tl.has(q, S) && t >= 2 && t - 1 < tl.len[k]
                  ? obs_p[((tl.b0 + k) * L + t - 1) * S + tl.jq(q)]
                  : 0.0f;
        }
      if (tl.active) {
#pragma unroll
        for (int q = 0; q < SPT; ++q)
#pragma unroll
          for (int k = 0; k < RT; ++k) {
            if (!tl.has(q, S)) continue;
            x[q][k] = __fmul_rn(o[q][k], b[q][k]);
            tl.s_u[(tl.row + k) * S + tl.jq(q)] = x[q][k];
          }
      }
      __syncthreads();
      tl.rows_max(S, kProbFloor);
      __syncthreads();
      if (tl.active) {
#pragma unroll
        for (int q = 0; q < SPT; ++q)
#pragma unroll
          for (int k = 0; k < RT; ++k)
            if (tl.has(q, S))
              tl.s_p[tl.jq(q) * tl.R + tl.row + k] =
                  ProbOps::renorm(x[q][k], tl.s_m[tl.row + k]);
      }
      __syncthreads();
      if (tl.active) {
        tl.template product<ProbOps>(trans_t, S, n_s, n_slots, s);
#pragma unroll
        for (int q = 0; q < SPT; ++q)
#pragma unroll
          for (int k = 0; k < RT; ++k)
            if (tl.has(q, S)) tl.s_u[(tl.row + k) * S + tl.jq(q)] = s[q][k];
      }
      __syncthreads();
      tl.rows_max(S, kProbFloor);
      __syncthreads();
      if (tl.active) {
#pragma unroll
        for (int k = 0; k < RT; ++k)
          if (t + 1 < tl.len[k])
#pragma unroll
            for (int q = 0; q < SPT; ++q)
              b[q][k] = ProbOps::renorm(s[q][k], tl.s_m[tl.row + k]);
      }
    }
#pragma unroll
    for (int q = 0; q < SPT; ++q)
#pragma unroll
      for (int k = 0; k < RT; ++k)
        if (tl.live[k] && tl.has(q, S))
          beta_out[((tl.b0 + k) * L + t) * S + tl.jq(q)] = b[q][k];
  }
}

// K6b past 256 states on the cluster tile: the function and the bits of
// bwd_prob_kernel.  b starts at 1.  A step (where t + 1 < the cluster's
// longest row): x = obs_p[t + 1] * b, the cluster's max xm (an exchange),
// x * (1 / xm) into every block's state vector (a second), the
// sum-product over the block's slice of trans_t, the cluster's max nm (a
// third), b = s * (1 / nm) where t + 1 < the row's length.  beta goes out
// at every t.  The two maxima have a buffer and an mbarrier each.
template <int R>
__global__ void __launch_bounds__(kClusterThreads, 1)
    bwd_prob_cluster_kernel(const float* __restrict__ obs_p,
                            const int32_t* __restrict__ lens,
                            const float* __restrict__ trans_t,
                            float* __restrict__ beta_out, int64_t B,
                            int64_t L, int S, int n_res) {
  extern __shared__ __align__(16) float smem[];
  using Tile = ClusterTile<R>;
  constexpr int kOwn = Tile::kOwn;
  Tile tl(smem, trans_t, lens, B, L, S, n_res, 2);
  int64_t cell[kOwn];
  // the observation rows two steps ahead, as in bwd_prob_kernel
  float b[kOwn], o_next[kOwn], o_next2[kOwn];
  // the first step that runs reads position max_len - 1
  const int64_t t1 = tl.max_len - 1;
#pragma unroll
  for (int m = 0; m < kOwn; ++m) {
    cell[m] = tl.b0 + tl.own_k[m];
    const int64_t base = cell[m] * L * S + tl.gj;
    b[m] = 1.0f;
    o_next[m] = tl.own_has[m] && t1 >= 1 && t1 < tl.own_len[m]
                    ? obs_p[base + t1 * S]
                    : 0.0f;
    o_next2[m] = tl.own_has[m] && t1 >= 2 && t1 - 1 < tl.own_len[m]
                     ? obs_p[base + (t1 - 1) * S]
                     : 0.0f;
  }

  for (int64_t t = L - 1; t >= 0; --t) {
    if (t + 1 < tl.max_len) {
      float o[kOwn], x[kOwn], xm[kOwn], e[kOwn], s[R], so[kOwn], nm[kOwn];
#pragma unroll
      for (int m = 0; m < kOwn; ++m) {
        o[m] = o_next[m];
        o_next[m] = o_next2[m];
        o_next2[m] = tl.own_has[m] && t >= 2 && t - 1 < tl.own_len[m]
                         ? obs_p[(cell[m] * L + t - 1) * S + tl.gj]
                         : 0.0f;
        x[m] = __fmul_rn(o[m], b[m]);
      }
      tl.template rows_max<0>(x, xm, kProbFloor);
#pragma unroll
      for (int m = 0; m < kOwn; ++m) e[m] = ProbOps::renorm(x[m], xm[m]);
      tl.broadcast(e);
      tl.template product<ProbOps>(s);
      tl.own(s, so);
      tl.template rows_max<1>(so, nm, kProbFloor);
#pragma unroll
      for (int m = 0; m < kOwn; ++m)
        if (t + 1 < tl.own_len[m]) b[m] = ProbOps::renorm(so[m], nm[m]);
    }
#pragma unroll
    for (int m = 0; m < kOwn; ++m)
      if (tl.own_live[m] && tl.own_has[m])
        beta_out[(cell[m] * L + t) * S + tl.gj] = b[m];
  }
  tl.finish();
}

// K6a to 32 states, a warp a row (scan_rows.cuh, lanes): the function
// and the bits of fwd_prob_kernel.  Lane j holds column j of trans_p and
// p_j (0 past S); a step over the row's valid positions is u = s * obs_p
// (position 0: start_p * obs_p), s the lanes_product of p, the exact row
// max m floored at 1e-37 and p = u * (1 / m).  dm = log m is off the
// chain: lane k keeps the m of step k of the ring's half and takes its log
// when the half is done.  Past the row's length p is carried with dm 0,
// so a row of length 0 is all ones.
template <int NS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    fwd_prob_lanes_kernel(const float* __restrict__ obs_p,
                          const int32_t* __restrict__ lens,
                          const float* __restrict__ start_p,
                          const float* __restrict__ trans_p,
                          float* __restrict__ alpha_out,
                          float* __restrict__ dm_out, int64_t B, int64_t L,
                          int S) {
  extern __shared__ __align__(16) float smem[];  // a ring a warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t b = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;
  const bool mine = lane < S;
  const bool tail = (S & 3) != 0;
  float* ring = smem + warp * (2 * kHalf * 32) + lane;
  float mc[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i)
    mc[i] = mine && i < S ? trans_p[(int64_t)i * S + lane] : 0.0f;
  const float start = mine ? start_p[lane] : 0.0f;
  float p = mine ? ProbOps::kCarry0 : 0.0f;
  const int64_t n = max((int64_t)0, min((int64_t)lens[b], L));
  const float* ob = obs_p + b * L * S + lane;
  float* hb = alpha_out + b * L * S + lane;  // the next row, by pointer
  float* db = dm_out + b * L;
  float mk = 0.0f;  // lane k: the row max of step k of this half
  stage_column(ring, ob, 0, n, S, mine);
  stage_column(ring, ob, kHalf, n, S, mine);
  for (int64_t t0 = 0; t0 < n; t0 += kHalf) {
    cp_async_wait<1>();  // this half is in; the next may be in flight
    const float* src = ring + ((t0 / kHalf) & 1) * kHalf * 32;
    const int steps = (int)min((int64_t)kHalf, n - t0);
    for (int k = 0; k < steps; ++k) {
      const float o = src[k * 32];
      const float base = t0 + k == 0 ? start : lanes_product<NS>(p, mc, tail);
      const float u = ProbOps::emit(base, o);
      const float m = lanes_max<NS>(u, mine, kProbFloor);
      p = mine ? ProbOps::renorm(u, m) : 0.0f;
      if (mine) *hb = p;
      hb += S;
      mk = lane == k ? m : mk;
    }
    if (lane < steps) db[t0 + lane] = ProbOps::increment(mk);
    stage_column(ring, ob, t0 + 2 * kHalf, n, S, mine);
  }
  cp_async_wait<0>();
  // past the row's length: the carried row, zero normalizers
  for (int64_t t = n; t < L; ++t) {
    if (mine) *hb = p;
    hb += S;
    if (lane == 0) db[t] = 0.0f;
  }
}

// K6b to 32 states, a warp a row: the function and the bits of
// bwd_prob_kernel.  Lane j holds column j of trans_t (row j of trans_p)
// and b_j.  beta is 1 from position n - 1 of a row of length n up; below,
// the chain: x = obs_p[t + 1] * b, its exact max xm, e = x * (1 / xm),
// s the lanes_product of e, its max nm, beta[t] = s * (1 / nm), both
// maxima floored at 1e-37.
template <int NS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    bwd_prob_lanes_kernel(const float* __restrict__ obs_p,
                          const int32_t* __restrict__ lens,
                          const float* __restrict__ trans_t,
                          float* __restrict__ beta_out, int64_t B, int64_t L,
                          int S) {
  extern __shared__ __align__(16) float smem[];  // a ring a warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t b = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;
  const bool mine = lane < S;
  const bool tail = (S & 3) != 0;
  float* ring = smem + warp * (2 * kHalf * 32) + lane;
  float mc[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i)
    mc[i] = mine && i < S ? trans_t[(int64_t)i * S + lane] : 0.0f;
  const int64_t n = max((int64_t)0, min((int64_t)lens[b], L));
  const float* ob = obs_p + b * L * S + lane;
  float* bb = beta_out + b * L * S + lane;
  float bv = 1.0f;
  if (mine)
    for (int64_t t = max(n - 1, (int64_t)0); t < L; ++t) bb[t * S] = bv;
  // the chain: step r at t = n - 2 - r reads position t + 1 = n - 1 - r
  stage_column_reverse(ring, ob, 0, n, S, mine);
  stage_column_reverse(ring, ob, kHalf, n, S, mine);
  for (int64_t r0 = 0; r0 < n - 1; r0 += kHalf) {
    cp_async_wait<1>();  // this half is in; the next may be in flight
    const float* src = ring + ((r0 / kHalf) & 1) * kHalf * 32;
    const int steps = (int)min((int64_t)kHalf, n - 1 - r0);
    for (int k = 0; k < steps; ++k) {
      const int64_t t = n - 2 - (r0 + k);
      const float x = __fmul_rn(src[k * 32], bv);
      const float xm = lanes_max<NS>(x, mine, kProbFloor);
      const float e = mine ? ProbOps::renorm(x, xm) : 0.0f;
      const float s = lanes_product<NS>(e, mc, tail);
      const float nm = lanes_max<NS>(s, mine, kProbFloor);
      bv = ProbOps::renorm(s, nm);
      if (mine) bb[t * S] = bv;
    }
    stage_column_reverse(ring, ob, r0 + 2 * kHalf, n, S, mine);
  }
  cp_async_wait<0>();
}

// K6a from 33 to 256 states (scan_rows.cuh, rows): the function and the
// bits of fwd_prob_kernel.  A step over the block's valid positions: the
// product over its R rows (position 0: start_p), u = s * obs_p, the row
// max (one barrier), p = u * (1 / m) where the position is valid, p into
// the state vectors (a second).  Rows of length 0 never step: all ones.
// dm = log m is off the chain: lane k R + r of warp 0 keeps row r's m of
// step k of the ring's half and takes its log when the half is done.  At
// one row a block and 16 register rows of the matrix (64 to 127 states)
// the kernel keeps to 128 registers, so that an SM holds eight blocks of
// 64 threads and S64's 1,024 rows fit one wave at R = 1.
template <int R, int KR>
__global__ void __launch_bounds__(kRowsMaxThreads,
                                  R == 1 && KR == 16 ? 2 : 1)
    fwd_prob_rows_kernel(const float* __restrict__ obs_p,
                         const int32_t* __restrict__ lens,
                         const float* __restrict__ start_p,
                         const float* __restrict__ trans_p,
                         float* __restrict__ alpha_out,
                         float* __restrict__ dm_out, int64_t B, int64_t L,
                         int S) {
  extern __shared__ __align__(16) float smem[];
  RowsTile<R, KR> tl(smem, trans_p, lens, B, L, S);
  const bool has = tl.has;
  const int j = tl.j;
  const float start_j = has ? start_p[j] : 0.0f;
  float p[R];
#pragma unroll
  for (int r = 0; r < R; ++r) p[r] = ProbOps::kCarry0;
  float mk = 0.0f;  // lane k R + r: row r's m at step k of this half, or 0
  // the steps that run; past them every row of the block is past its end
  const int64_t steps = tl.max_len;
  tl.template stage<false>(obs_p, L, 0, steps);
  tl.template stage<false>(obs_p, L, kRowsHalf, steps);
  for (int64_t t0 = 0; t0 < steps; t0 += kRowsHalf) {
    cp_async_wait<1>();  // this half is in; the next may be in flight
    const int n = (int)min((int64_t)kRowsHalf, steps - t0);
    for (int k = 0; k < n; ++k) {
      const int64_t t = t0 + k;
      float o[R], u[R], m[R];
      tl.template ring_obs<false>(L, t, o);
      if (t == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) u[r] = ProbOps::emit(start_j, o[r]);
      } else {
        float s[R];
        tl.product(s);
#pragma unroll
        for (int r = 0; r < R; ++r) u[r] = ProbOps::emit(s[r], o[r]);
      }
      tl.row_max(u, m, 0, kProbFloor);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool valid = t < tl.len[r];
        if (valid) p[r] = ProbOps::renorm(u[r], m[r]);
        if (tl.lane == k * R + r) mk = valid ? m[r] : 0.0f;
        if (tl.live[r] && has)
          alpha_out[((tl.b0 + r) * L + t) * S + j] = p[r];
      }
      tl.put(p);
      __syncthreads();
    }
    if (tl.warp == 0 && tl.lane < n * R) {
      const int64_t b = tl.b0 + tl.lane % R;
      if (b < B)
        dm_out[b * L + t0 + tl.lane / R] =
            mk > 0.0f ? ProbOps::increment(mk) : 0.0f;
    }
    tl.template stage<false>(obs_p, L, t0 + 2 * kRowsHalf, steps);
  }
  cp_async_wait<0>();
  for (int64_t t = steps; t < L; ++t) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!tl.live[r]) continue;
      const int64_t pos = (tl.b0 + r) * L + t;
      if (has) alpha_out[pos * S + j] = p[r];
      if (j == 0) dm_out[pos] = 0.0f;
    }
  }
}

// K6b from 33 to 256 states: the function and the bits of bwd_prob_kernel.
// Step s at t = L - 1 - s, where t + 1 < the block's longest row: x =
// obs_p[t + 1] * b, its row max xm (one barrier), x * (1 / xm) into the
// state vectors (a second), the product over trans_t, its row max nm (a
// third), b = s * (1 / nm) where t + 1 < the row's length; the two maxima
// have a partial buffer each.  beta goes out at every t.
template <int R, int KR>
__global__ void __launch_bounds__(kRowsMaxThreads)
    bwd_prob_rows_kernel(const float* __restrict__ obs_p,
                         const int32_t* __restrict__ lens,
                         const float* __restrict__ trans_t,
                         float* __restrict__ beta_out, int64_t B, int64_t L,
                         int S) {
  extern __shared__ __align__(16) float smem[];
  RowsTile<R, KR> tl(smem, trans_t, lens, B, L, S);
  const bool has = tl.has;
  const int j = tl.j;
  float bv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) bv[r] = 1.0f;
  tl.template stage<true>(obs_p, L, 0, L);
  tl.template stage<true>(obs_p, L, kRowsHalf, L);
  for (int64_t s0 = 0; s0 < L; s0 += kRowsHalf) {
    cp_async_wait<1>();  // this half is in; the next may be in flight
    const int n = (int)min((int64_t)kRowsHalf, L - s0);
    for (int k = 0; k < n; ++k) {
      const int64_t t = L - 1 - (s0 + k);
      if (t + 1 < tl.max_len) {
        float o[R], x[R], xm[R], e[R], s[R], nm[R];
        tl.template ring_obs<true>(L, s0 + k, o);
#pragma unroll
        for (int r = 0; r < R; ++r) x[r] = __fmul_rn(o[r], bv[r]);
        tl.row_max(x, xm, 0, kProbFloor);
#pragma unroll
        for (int r = 0; r < R; ++r) e[r] = ProbOps::renorm(x[r], xm[r]);
        tl.put(e);
        __syncthreads();
        tl.product(s);
        tl.row_max(s, nm, 1, kProbFloor);
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (t + 1 < tl.len[r]) bv[r] = ProbOps::renorm(s[r], nm[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (tl.live[r] && has)
          beta_out[((tl.b0 + r) * L + t) * S + j] = bv[r];
    }
    tl.template stage<true>(obs_p, L, s0 + 2 * kRowsHalf, L);
  }
  cp_async_wait<0>();
}

// K5 and K3's carry mode to 32 states, a warp a row (scan_rows.cuh,
// lanes): the function and the bits of viterbi_values_kernel.  K3's
// lanes step (common.cuh lanes_step): lane j holds column j of log_trans
// in registers and every lane the whole row (-inf past S), a step is the
// max-plus product, + obs, the row gathered by shuffles and renormalized
// in every lane.  Position 0 without a carry is log_start + obs, renormalized
// (lanes_renorm).  dm is off the chain: lane k keeps the m of step k of
// the ring's half and stores it when the half is done.  Past the row's
// length the row is carried with dm 0, so a row of length 0 keeps its
// carry (0 without one).  ``carry_in``, ``v_out``, ``dm_out`` and
// ``carry_out`` as in forward_scan.
template <int NS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    viterbi_values_lanes_kernel(const float* __restrict__ obs,
                                const int32_t* __restrict__ lens,
                                const float* __restrict__ log_start,
                                const float* __restrict__ carry_in,
                                const float* __restrict__ log_trans,
                                float* __restrict__ v_out,
                                float* __restrict__ dm_out,
                                float* __restrict__ carry_out, int64_t B,
                                int64_t L, int S) {
  extern __shared__ __align__(16) float smem[];  // a ring a warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t b = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;
  const bool mine = lane < S;  // lanes past S carry -inf
  const bool carried = carry_in != nullptr;
  float* ring = smem + warp * (2 * kHalf * 32) + lane;
  if (!mine)  // their obs stay 0, so their values stay -inf
    for (int k = 0; k < 2 * kHalf; ++k) ring[k * 32] = 0.0f;
  float tc[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i)
    tc[i] = mine && i < S ? log_trans[(int64_t)i * S + lane] : -INFINITY;
  float own = !mine ? -INFINITY
                    : (carried ? carry_in[b * S + lane] : MaxPlusOps::kCarry0);
  float row[NS];  // the row, row[i] for i < S, -inf beyond
#pragma unroll
  for (int i = 0; i < NS; ++i) row[i] = __shfl_sync(0xffffffffu, own, i);
  const float start = mine && !carried ? log_start[lane] : -INFINITY;
  const int64_t n = max((int64_t)0, min((int64_t)lens[b], L));
  const float* ob = obs + b * L * S + lane;
  // the next stores of each output, walked by pointer
  float* vb = v_out != nullptr ? v_out + b * L * S + lane : nullptr;
  float* db = dm_out != nullptr ? dm_out + b * L : nullptr;
  float mk = 0.0f;  // lane k: the row max of step k of this half
  stage_column(ring, ob, 0, n, S, mine);
  stage_column(ring, ob, kHalf, n, S, mine);
  for (int64_t t0 = 0; t0 < n; t0 += kHalf) {
    cp_async_wait<1>();  // this half is in; the next may be in flight
    const float* src = ring + ((t0 / kHalf) & 1) * kHalf * 32;
    const int steps = (int)min((int64_t)kHalf, n - t0);
    auto emit = [&](int k, float m) {
      if (vb != nullptr) {
        if (mine) *vb = own;
        vb += S;
      }
      mk = lane == k ? m : mk;
    };
    int k = 0;
    if (t0 == 0 && !carried) {
      float m;
      own = lanes_renorm<NS>(row, start + src[0], &m);
      emit(0, m);
      k = 1;
    }
    for (; k < steps; ++k) {
      float m;
      own = lanes_step<NS>(row, tc, src[k * 32], nullptr, &m);
      emit(k, m);
    }
    if (db != nullptr && lane < steps) db[t0 + lane] = mk;
    stage_column(ring, ob, t0 + 2 * kHalf, n, S, mine);
  }
  cp_async_wait<0>();
  // past the row's length: the carried row, zero normalizers
  for (int64_t t = n; t < L; ++t) {
    if (vb != nullptr) {
      if (mine) *vb = own;
      vb += S;
    }
    if (db != nullptr && lane == 0) db[t] = 0.0f;
  }
  if (carry_out != nullptr && mine) carry_out[b * S + lane] = own;
}

// K5 and K3's carry mode from 33 to 256 states (scan_rows.cuh, rows): the
// function and the bits of viterbi_values_kernel.  The state vectors hold
// the renormalized log values v themselves, the matrix's pads are -inf.
// A step over the block's valid positions: the max-plus product over its
// R rows (RowsTile::product_max; position 0 without a carry: log_start),
// u = s + obs, the row max m floored at LOG_ZERO (one barrier), v = u - m
// where the position is valid, v into the state vectors (a second); dm is
// m itself, stored beside the row.  With ``carry_in`` the vectors start
// as the rows' carries and every position applies the product.  Rows of
// length 0 keep their carry (0 without one) with dm 0.  ``v_out``,
// ``dm_out`` and ``carry_out`` may each be null.  Register use as
// fwd_prob_rows_kernel's: eight blocks of 64 threads an SM at one row a
// block from 64 to 127 states.
template <int R, int KR>
__global__ void __launch_bounds__(kRowsMaxThreads,
                                  R == 1 && KR == 16 ? 2 : 1)
    viterbi_values_rows_kernel(const float* __restrict__ obs,
                               const int32_t* __restrict__ lens,
                               const float* __restrict__ log_start,
                               const float* __restrict__ carry_in,
                               const float* __restrict__ log_trans,
                               float* __restrict__ v_out,
                               float* __restrict__ dm_out,
                               float* __restrict__ carry_out, int64_t B,
                               int64_t L, int S) {
  extern __shared__ __align__(16) float smem[];
  RowsTile<R, KR> tl(smem, log_trans, lens, B, L, S, -INFINITY);
  const bool carried = carry_in != nullptr;
  const bool has = tl.has;
  const int j = tl.j;
  const float start_j = has && !carried ? log_start[j] : 0.0f;
  float v[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    v[r] = carried && has && tl.live[r] ? carry_in[(tl.b0 + r) * S + j]
                                        : MaxPlusOps::kCarry0;
  // the steps that run; past them every row of the block is past its end
  const int64_t steps = tl.max_len;
  tl.template stage<false>(obs, L, 0, steps);
  tl.template stage<false>(obs, L, kRowsHalf, steps);
  if (carried) tl.put(v);
  __syncthreads();
  for (int64_t t0 = 0; t0 < steps; t0 += kRowsHalf) {
    cp_async_wait<1>();  // this half is in; the next may be in flight
    const int n = (int)min((int64_t)kRowsHalf, steps - t0);
    for (int k = 0; k < n; ++k) {
      const int64_t t = t0 + k;
      float o[R], u[R], m[R];
      tl.template ring_obs<false>(L, t, o);
      if (t == 0 && !carried) {
#pragma unroll
        for (int r = 0; r < R; ++r) u[r] = start_j + o[r];
      } else {
        tl.product_max(u);
#pragma unroll
        for (int r = 0; r < R; ++r) u[r] = u[r] + o[r];
      }
      tl.row_max(u, m, 0, MaxPlusOps::kFloor);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool valid = t < tl.len[r];
        if (valid) v[r] = u[r] - m[r];
        if (!tl.live[r]) continue;
        const int64_t pos = (tl.b0 + r) * L + t;
        if (v_out != nullptr && has) v_out[pos * S + j] = v[r];
        if (dm_out != nullptr && j == 0) dm_out[pos] = valid ? m[r] : 0.0f;
      }
      tl.put(v);
      __syncthreads();
    }
    tl.template stage<false>(obs, L, t0 + 2 * kRowsHalf, steps);
  }
  cp_async_wait<0>();
  for (int64_t t = steps; t < L; ++t) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!tl.live[r]) continue;
      const int64_t pos = (tl.b0 + r) * L + t;
      if (v_out != nullptr && has) v_out[pos * S + j] = v[r];
      if (dm_out != nullptr && j == 0) dm_out[pos] = 0.0f;
    }
  }
  if (carry_out != nullptr && has) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (tl.live[r]) carry_out[(tl.b0 + r) * S + j] = v[r];
  }
}

// K5's launch (with ``carry_in``, K3's carry mode) by ``tile``
// (scan_tile.cuh ScanTile): the block tile, the cluster tile (257 to 1024
// states), the lanes step (to 32), the rows kernels (33 to 256).
int launch_viterbi_values(int tile, const float* obs, const int32_t* lens,
                          const float* log_start, const float* carry_in,
                          const float* log_trans, float* v_out,
                          float* dm_out, float* carry_out, int64_t B,
                          int64_t L, int S, void* stream) {
  if (tile == kTileCluster) {
    CLUSTER_KERNELS(ks, viterbi_values_cluster_kernel);
    return launch_cluster_scan(ks, B, S, 1, stream, obs, lens, log_start,
                               carry_in, log_trans, v_out, dm_out,
                               carry_out, B, L, S);
  }
  if (tile == kTileLanes) {
    LANES_KERNELS(ks, viterbi_values_lanes_kernel);
    return launch_lanes(ks, B, S, stream, obs, lens, log_start, carry_in,
                        log_trans, v_out, dm_out, carry_out, B, L, S);
  }
  if (tile == kTileRows) {
    ROWS_KERNELS(ks, viterbi_values_rows_kernel);
    return launch_rows(ks, B, S, stream, obs, lens, log_start, carry_in,
                       log_trans, v_out, dm_out, carry_out, B, L, S);
  }
  TILE_KERNELS(ks, viterbi_values_kernel);
  return launch_scan(ks, B, S, stream, obs, lens, log_start, carry_in,
                     log_trans, v_out, dm_out, carry_out, B, L, S);
}

}  // namespace

extern "C" {

// ``tile``: launch_viterbi_values'.
int tehmm_viterbi_values(const void* obs, const void* lens,
                         const void* log_start, const void* log_trans,
                         void* v_out, void* dm_out, int64_t B, int64_t L,
                         int S, int tile, void* stream) {
  return launch_viterbi_values(tile, (const float*)obs, (const int32_t*)lens,
                               (const float*)log_start, nullptr,
                               (const float*)log_trans, (float*)v_out,
                               (float*)dm_out, nullptr, B, L, S, stream);
}

// K3's carry mode: v_out (values) or carry_out (the final carry) may be
// null; ``tile`` as tehmm_viterbi_values'.
int tehmm_viterbi_carry_tile(const void* obs, const void* carry_in,
                             const void* lens, const void* log_trans,
                             void* v_out, void* carry_out, int64_t B,
                             int64_t L, int S, int tile, void* stream) {
  return launch_viterbi_values(tile, (const float*)obs,
                               (const int32_t*)lens, nullptr,
                               (const float*)carry_in,
                               (const float*)log_trans, (float*)v_out,
                               nullptr, (float*)carry_out, B, L, S, stream);
}

// The cluster plans of streaming.cu's kernels at S states and B rows
// (scan_cluster.cuh write_cluster_plan), by scans.cu's
// tehmm_scan_cluster_plan ``kind``: 2 K5 (and K3's carry mode), 4 K6a, 5
// K6b (two max buffers).
int tehmm_streaming_cluster_plan(int S, int64_t B, int kind, int64_t* out) {
  if (kind == 2) {
    CLUSTER_KERNELS(ks, viterbi_values_cluster_kernel);
    return write_cluster_plan(ks, S, B, 1, out);
  }
  if (kind == 4) {
    CLUSTER_KERNELS(ks, fwd_prob_cluster_kernel);
    return write_cluster_plan(ks, S, B, 1, out);
  }
  if (kind == 5) {
    CLUSTER_KERNELS(ks, bwd_prob_cluster_kernel);
    return write_cluster_plan(ks, S, B, 2, out);
  }
  return (int)cudaErrorInvalidValue;
}

// The rows kernels' plan of ``kind`` (scans.cu tehmm_rows_plan's: 2 K6a,
// 3 K6b, 4 K5 and K3's carry mode) at S states and B rows into out[8]
// (write_rows_plan).
int tehmm_streaming_rows_plan(int S, int64_t B, int kind, int64_t* out) {
  if (kind == 2) {
    ROWS_KERNELS(ks, fwd_prob_rows_kernel);
    return write_rows_plan(ks, B, S, out);
  }
  if (kind == 3) {
    ROWS_KERNELS(ks, bwd_prob_rows_kernel);
    return write_rows_plan(ks, B, S, out);
  }
  if (kind == 4) {
    ROWS_KERNELS(ks, viterbi_values_rows_kernel);
    return write_rows_plan(ks, B, S, out);
  }
  return (int)cudaErrorInvalidValue;
}

// ``tile`` (scan_tile.cuh ScanTile): the block tile, the cluster tile
// (257 to 1024 states), the lanes step (to 32), the rows kernels (33 to
// 256).
int tehmm_fwd_prob(const void* obs_p, const void* lens, const void* start_p,
                   const void* trans_p, void* alpha_out, void* dm_out,
                   int64_t B, int64_t L, int S, int tile, void* stream) {
  const float* o = (const float*)obs_p;
  const int32_t* n = (const int32_t*)lens;
  const float* sp = (const float*)start_p;
  const float* tp = (const float*)trans_p;
  float* a = (float*)alpha_out;
  float* dm = (float*)dm_out;
  if (tile == kTileCluster) {
    CLUSTER_KERNELS(ks, fwd_prob_cluster_kernel);
    return launch_cluster_scan(ks, B, S, 1, stream, o, n, sp, tp, a, dm, B,
                               L, S);
  }
  if (tile == kTileLanes) {
    LANES_KERNELS(ks, fwd_prob_lanes_kernel);
    return launch_lanes(ks, B, S, stream, o, n, sp, tp, a, dm, B, L, S);
  }
  if (tile == kTileRows) {
    ROWS_KERNELS(ks, fwd_prob_rows_kernel);
    return launch_rows(ks, B, S, stream, o, n, sp, tp, a, dm, B, L, S);
  }
  TILE_KERNELS(ks, fwd_prob_kernel);
  return launch_scan(ks, B, S, stream, o, n, sp, tp, a, dm, B, L, S);
}

int tehmm_bwd_prob(const void* obs_p, const void* lens, const void* trans_t,
                   void* beta_out, int64_t B, int64_t L, int S, int tile,
                   void* stream) {
  const float* o = (const float*)obs_p;
  const int32_t* n = (const int32_t*)lens;
  const float* tt = (const float*)trans_t;
  float* beta = (float*)beta_out;
  if (tile == kTileCluster) {
    CLUSTER_KERNELS(ks, bwd_prob_cluster_kernel);
    return launch_cluster_scan(ks, B, S, 2, stream, o, n, tt, beta, B, L,
                               S);
  }
  if (tile == kTileLanes) {
    LANES_KERNELS(ks, bwd_prob_lanes_kernel);
    return launch_lanes(ks, B, S, stream, o, n, tt, beta, B, L, S);
  }
  if (tile == kTileRows) {
    ROWS_KERNELS(ks, bwd_prob_rows_kernel);
    return launch_rows(ks, B, S, stream, o, n, tt, beta, B, L, S);
  }
  TILE_KERNELS(ks, bwd_prob_kernel);
  return launch_scan(ks, B, S, stream, o, n, tt, beta, B, L, S);
}

}  // extern "C"
