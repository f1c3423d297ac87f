// Hand-written Hopper (sm_90a) kernels for the log-space scaled scans over
// a precomputed observation tensor and the pointer-writing Viterbi: the
// forward and backward of the E-step engine "cuda_log" and of the
// max-posterior decode past K4's envelope (parallel/stitch.py), and the
// "pointers" decode of tools/bench_engines.
//
// Built with viterbi.cu, em_estep.cu, posterior.cu and streaming.cu into
// one shared library with a plain C interface
// (tehmm_tpu_torch/ops/cuda_kernels.py), loaded with ctypes.  Every entry
// point launches on the stream it is given, allocates nothing and returns
// the cudaGetLastError() that follows its launch.
//
// Kernels and the TPU kernels they replace
// (tehmm_tpu/ops/pallas_kernels.py):
//
//   fwd_scaled_kernel    K7a, _forward_kernel_v2 (:402) under
//                        forward_scaled_pallas_v2 (:493), and K8a,
//                        _forward_kernel (:75) under forward_scaled_pallas
//                        (:131): the same function
//   bwd_scaled_kernel    K7b, _backward_kernel_v2 (:934) under
//                        backward_hat_pallas_v2 (:1012), and K8b,
//                        _backward_kernel (:187) under
//                        backward_scaled_pallas (:222): K7b's function is
//                        K8b's without the normalizers
//   fwd_scaled_lanes_kernel, bwd_scaled_lanes_kernel
//                        the same two functions, carry modes included, to
//                        32 states, a warp a row (scan_rows.cuh), with the
//                        same bits
//   fwd_scaled_rows_kernel, bwd_scaled_rows_kernel
//                        the same two functions, carry modes included,
//                        from 33 to 256 states (scan_rows.cuh), with the
//                        same bits
//   fwd_scaled_cluster_kernel, bwd_scaled_cluster_kernel
//                        the same two functions, carry modes included,
//                        from 257 to 1024 states on the cluster tile
//                        (scan_cluster.cuh), with the same bits
//   viterbi_ptrs_kernel  K8c, _viterbi_kernel (:277) under viterbi_pallas
//                        (:333)
//   viterbi_ptrs_lanes_kernel, viterbi_ptrs_rows_kernel
//                        the same function to 32 states (K3's max-plus
//                        lanes step, pointer mode) and from 33 to 256
//                        (scan_rows.cuh, product_argmax), with the same
//                        bits
//   viterbi_ptrs_cluster_kernel
//                        the same function from 257 to 1024 states on the
//                        cluster tile, with the same bits
//   pointer_chase_kernel the XLA backtrace of viterbi_pallas (:381-388),
//                        no Pallas kernel
//
// What they compute (tehmm_tpu_torch/ops/dp.py forward_scaled,
// backward_scaled, viterbi), over obs [B, L, S] and lengths [B]:
//   forward   a[0] = log_start + obs[0] (LOG_ZERO for a zero-length row),
//             then a[t] = log(exp(a[t-1]) . exp(log_trans)) + obs[t] (log
//             of a zero sum is LOG_ZERO); each row is renormalized by its
//             max m (floored at LOG_ZERO), which goes out as dm[t].
//   backward  b[L-1] = 0; b[t] from x = obs[t+1] + b[t+1] renormalized by
//             its max xm, then log(exp(x) . exp(log_trans)^T) renormalized
//             by its max nm; dm[t] = xm + nm.
//   Viterbi   K5's max-plus forward (streaming.cu), writing at every
//             position the argmax predecessor of every state, first hit
//             (the lowest index) on ties, as uint8 (S <= 256) or
//             uint16 (to S = 1024); only the last value row is kept.
//             The chase walks the pointers back from the first-hit
//             argmax of that row.
// Positions at or past a row's length carry the row with a zero normalizer
// (the forward's position 0 excepted, as in the reference) and, in the
// Viterbi, the identity pointer, so paths replicate the last valid state.
//
// What bounds them on an H100: as streaming.cu's scans, the chain of L
// dependent steps; each step R S^2 FMAs over the R rows a block holds,
// plus one expf and one logf per cell (the backward: a second max
// reduction); the bytes of obs in and of the rows and normalizers out.
// The forward and backward to 256 states: the block tile loaded a matrix
// element and a state-vector element from shared memory for every FMA
// and took three (five) block-wide barriers a step; their own kernels
// (scan_rows.cuh) load a float4 of the matrix (or hold it in registers)
// for 4 R FMAs, keep the first 32 to 128 matrix rows in registers and
// the rest in shared memory, and take two (three) barriers of a block of
// R rows, or none in a warp a row to 32 states.  Past 256 states, on the
// staged tile, the re-read of the matrix from L2 every step, and on the
// cluster tile the product over a block's slice (R S^2 / C FMAs, or
// add-and-compares, a block a step) and two exchanges across the cluster
// a step (the backward: three).  The chase is one dependent pointer load
// per position.
//
// Design: scan_tile.cuh's tile (a block of 256 threads owns a tile of rows
// for the whole scan, one thread per state to S = 256 and 2 or 4 beyond,
// one or two rows per thread (beyond, two or four rows a block, all of
// them the thread's); as many matrix rows as fit in shared memory and the
// rest through the read-only path, or past 256 states the matrix staged
// block by block every step).  The log-space scans keep the row's
// log values in registers and put its exp in the tile's state vectors, so
// the product is K6's (ProbOps) loop on the same matrix layout; the
// Viterbi's product tracks, beside each of its four partial maxima (one
// chain in row order past 256 states), the index that set it.  The chase
// is one thread per batch row.  The carry modes of X1 (K7a started from
// each row's carry, every position a product step) and X2 (K7b, whose
// step at the chunk's last position takes exp of the carry and whose
// x_out is renormalized after position 0) run the same loops, so a sweep
// cut into chunks executes the same instructions as one chunk.  To 256
// states the forward and backward (and their carry modes) run their own
// kernels instead (scan_rows.cuh, which says why and how: the lanes step
// to 32 states, the rows kernels beyond), and so does the Viterbi; from
// 257 to 1024 states they and the Viterbi run the cluster tile
// (scan_cluster.cuh): the entries take the kernel the caller names,
// ``tile`` (scan_tile.cuh ScanTile).
//
// Numerics: each product is summed in K6's fixed order, four interleaved
// FMA chains added pairwise, that depends on S alone (no atomics, no
// tensor cores, no TF32): two runs, at either rows-per-thread choice, give
// the same bits, within float32 rounding of the plain version's matrix
// product.  expf and logf are the accurate library functions.  The
// Viterbi is float32 add, subtract and max only; its partial maxima are
// combined by value and then by the lower index, so values, pointers and
// paths agree bit for bit with the plain version's first-hit argmax.
//
// All global index arithmetic is 64-bit.

#include <type_traits>

#include "scan_cluster.cuh"
#include "scan_rows.cuh"

namespace {

constexpr int kChaseThreads = 32;  // threads per block of the chase

// K7a/K8a: log-space scaled forward values and their normalizers.  With
// ``carry_in``, X1's carry mode: the row's carry is the value row before
// position 0, every position applies the product, and ``alpha_out``
// (values), ``dm_out`` (carry-only mode) and ``carry_out`` (the last row)
// may each be nullptr.
template <int SPT, int RT>
__global__ void __launch_bounds__(kThreads)
    fwd_scaled_kernel(const float* __restrict__ obs,
                      const int32_t* __restrict__ lens,
                      const float* __restrict__ log_start,
                      const float* __restrict__ carry_in,
                      const float* __restrict__ trans_p,
                      float* __restrict__ alpha_out,
                      float* __restrict__ dm_out,
                      float* __restrict__ carry_out, int64_t B, int64_t L,
                      int S, int n_s, int n_slots) {
  extern __shared__ __align__(16) float smem[];
  Tile<SPT, RT> tl(smem, trans_p, lens, B, L, S, n_s);
  const bool carried = carry_in != nullptr;
  float a[SPT][RT], o_next[SPT][RT], start_j[SPT];
#pragma unroll
  for (int q = 0; q < SPT; ++q) {
    const int jq = tl.jq(q);
    const bool has = tl.has(q, S);
    start_j[q] = has && !carried ? log_start[jq] : 0.0f;
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      a[q][k] = carried && has && tl.live[k]
                    ? carry_in[(tl.b0 + k) * S + jq]
                    : 0.0f;
      if (carried && has) tl.s_p[jq * tl.R + tl.row + k] = expf(a[q][k]);
      o_next[q][k] =
          has && tl.len[k] > 0 ? obs[(tl.b0 + k) * L * S + jq] : 0.0f;
    }
  }
  if (carried) __syncthreads();

  for (int64_t t = 0; t < L; ++t) {
    if ((t > 0 || carried) && t >= tl.max_len) {
      // every row of the block is past its end: carried rows, zeros
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        if (!tl.live[k]) continue;
        const int64_t pos = (tl.b0 + k) * L + t;
        if (alpha_out != nullptr)
#pragma unroll
          for (int q = 0; q < SPT; ++q)
            if (tl.has(q, S)) alpha_out[pos * S + tl.jq(q)] = a[q][k];
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
    const bool first = t == 0 && !carried;
    if (first) {
#pragma unroll
      for (int q = 0; q < SPT; ++q)
#pragma unroll
        for (int k = 0; k < RT; ++k)
          u[q][k] = tl.len[k] > 0 ? start_j[q] + o[q][k] : kLogZero;
    } else if (tl.active) {
      float s[SPT][RT];
      tl.template product<ProbOps>(trans_p, S, n_s, n_slots, s);
#pragma unroll
      for (int q = 0; q < SPT; ++q)
#pragma unroll
        for (int k = 0; k < RT; ++k)
          u[q][k] = (s[q][k] > 0.0f ? logf(s[q][k]) : kLogZero) + o[q][k];
    }
    if (tl.active) {
#pragma unroll
      for (int q = 0; q < SPT; ++q)
#pragma unroll
        for (int k = 0; k < RT; ++k)
          if (tl.has(q, S)) tl.s_u[(tl.row + k) * S + tl.jq(q)] = u[q][k];
    }
    __syncthreads();
    tl.rows_max(S, kLogZero);
    __syncthreads();
    if (tl.active) {
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        const float m = tl.s_m[tl.row + k];
        // position 0 is renormalized in every row, as the reference
        // does (a zero-length row: all LOG_ZERO, so a = 0, dm = LOG_ZERO)
        const bool valid = first || t < tl.len[k];
        const int64_t pos = (tl.b0 + k) * L + t;
#pragma unroll
        for (int q = 0; q < SPT; ++q) {
          if (!tl.has(q, S)) continue;
          if (valid) a[q][k] = u[q][k] - m;
          tl.s_p[tl.jq(q) * tl.R + tl.row + k] = expf(a[q][k]);
          if (tl.live[k] && alpha_out != nullptr)
            alpha_out[pos * S + tl.jq(q)] = a[q][k];
        }
        if (tl.live[k] && tl.j == 0 && dm_out != nullptr)
          dm_out[pos] = valid ? m : 0.0f;
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
          carry_out[(tl.b0 + k) * S + tl.jq(q)] = a[q][k];
  }
}

// K7b/K8b: log-space scaled backward values and their normalizers.
// ``trans_t`` is exp(log_trans) transposed, so that
// s_i = sum_j trans[i][j] exp(x_j) runs through the tile's product loop.
// With ``x_carry``, X2's carry mode: position L - 1 takes the step from
// the carry (the next chunk's normalized obs + beta row, exponentiated as
// it is) where ``continuing`` says the row goes on, and after position 0
// x_out = obs[0] + beta[0] less its max goes out; ``dm_out`` may then be
// nullptr.
template <int SPT, int RT>
__global__ void __launch_bounds__(kThreads)
    bwd_scaled_kernel(const float* __restrict__ obs,
                      const int32_t* __restrict__ lens,
                      const float* __restrict__ x_carry,
                      const int32_t* __restrict__ continuing,
                      const float* __restrict__ trans_t,
                      float* __restrict__ beta_out,
                      float* __restrict__ dm_out,
                      float* __restrict__ x_out, int64_t B, int64_t L,
                      int S, int n_s, int n_slots) {
  extern __shared__ __align__(16) float smem[];
  Tile<SPT, RT> tl(smem, trans_t, lens, B, L, S, n_s);
  const bool carried = x_carry != nullptr;
  // A step consumes its observation row first thing, so the rows are
  // loaded two steps ahead (as in streaming.cu's backward).
  float b[SPT][RT], o_next[SPT][RT], o_next2[SPT][RT];
  bool cont[RT];
  // the first in-chunk step that runs reads position max_len - 1
  const int64_t t1 = tl.max_len - 1;
#pragma unroll
  for (int k = 0; k < RT; ++k)
    cont[k] = carried && tl.live[k] && continuing[tl.b0 + k] != 0;
#pragma unroll
  for (int q = 0; q < SPT; ++q)
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      const int64_t base = (tl.b0 + k) * L * S + tl.jq(q);
      b[q][k] = 0.0f;
      o_next[q][k] = tl.has(q, S) && t1 >= 1 && t1 < tl.len[k]
                         ? obs[base + t1 * S]
                         : 0.0f;
      o_next2[q][k] = tl.has(q, S) && t1 >= 2 && t1 - 1 < tl.len[k]
                          ? obs[base + (t1 - 1) * S]
                          : 0.0f;
    }

  for (int64_t t = L - 1; t >= 0; --t) {
    float d[RT];
#pragma unroll
    for (int k = 0; k < RT; ++k) d[k] = 0.0f;
    if (carried && t == L - 1) {
      // the boundary step: exp(x_carry) through the product
      float s[SPT][RT];
      if (tl.active) {
#pragma unroll
        for (int q = 0; q < SPT; ++q)
#pragma unroll
          for (int k = 0; k < RT; ++k)
            if (tl.has(q, S))
              tl.s_p[tl.jq(q) * tl.R + tl.row + k] = expf(
                  tl.live[k] ? x_carry[(tl.b0 + k) * S + tl.jq(q)] : 0.0f);
      }
      __syncthreads();
      if (tl.active) {
        tl.template product<ProbOps>(trans_t, S, n_s, n_slots, s);
#pragma unroll
        for (int q = 0; q < SPT; ++q)
#pragma unroll
          for (int k = 0; k < RT; ++k) {
            s[q][k] = s[q][k] > 0.0f ? logf(s[q][k]) : kLogZero;
            if (tl.has(q, S)) tl.s_u[(tl.row + k) * S + tl.jq(q)] = s[q][k];
          }
      }
      __syncthreads();
      tl.rows_max(S, kLogZero);
      __syncthreads();
      if (tl.active) {
#pragma unroll
        for (int k = 0; k < RT; ++k)
          if (cont[k])
#pragma unroll
            for (int q = 0; q < SPT; ++q)
              b[q][k] = s[q][k] - tl.s_m[tl.row + k];
      }
    } else if (t + 1 < tl.max_len) {
      float o[SPT][RT], x[SPT][RT], xm[RT], s[SPT][RT];
#pragma unroll
      for (int q = 0; q < SPT; ++q)
#pragma unroll
        for (int k = 0; k < RT; ++k) {
          o[q][k] = o_next[q][k];
          o_next[q][k] = o_next2[q][k];
          o_next2[q][k] =
              tl.has(q, S) && t >= 2 && t - 1 < tl.len[k]
                  ? obs[((tl.b0 + k) * L + t - 1) * S + tl.jq(q)]
                  : 0.0f;
        }
      if (tl.active) {
#pragma unroll
        for (int q = 0; q < SPT; ++q)
#pragma unroll
          for (int k = 0; k < RT; ++k) {
            if (!tl.has(q, S)) continue;
            x[q][k] = o[q][k] + b[q][k];
            tl.s_u[(tl.row + k) * S + tl.jq(q)] = x[q][k];
          }
      }
      __syncthreads();
      tl.rows_max(S, kLogZero);
      __syncthreads();
      if (tl.active) {
#pragma unroll
        for (int k = 0; k < RT; ++k) {
          xm[k] = tl.s_m[tl.row + k];
#pragma unroll
          for (int q = 0; q < SPT; ++q)
            if (tl.has(q, S))
              tl.s_p[tl.jq(q) * tl.R + tl.row + k] = expf(x[q][k] - xm[k]);
        }
      }
      __syncthreads();
      if (tl.active) {
        tl.template product<ProbOps>(trans_t, S, n_s, n_slots, s);
#pragma unroll
        for (int q = 0; q < SPT; ++q)
#pragma unroll
          for (int k = 0; k < RT; ++k) {
            s[q][k] = s[q][k] > 0.0f ? logf(s[q][k]) : kLogZero;
            if (tl.has(q, S)) tl.s_u[(tl.row + k) * S + tl.jq(q)] = s[q][k];
          }
      }
      __syncthreads();
      tl.rows_max(S, kLogZero);
      __syncthreads();
      if (tl.active) {
#pragma unroll
        for (int k = 0; k < RT; ++k) {
          if (t + 1 < tl.len[k]) {
            const float nm = tl.s_m[tl.row + k];
#pragma unroll
            for (int q = 0; q < SPT; ++q) b[q][k] = s[q][k] - nm;
            d[k] = xm[k] + nm;
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      if (!tl.live[k]) continue;
      const int64_t pos = (tl.b0 + k) * L + t;
#pragma unroll
      for (int q = 0; q < SPT; ++q)
        if (tl.has(q, S)) beta_out[pos * S + tl.jq(q)] = b[q][k];
      if (tl.j == 0 && dm_out != nullptr) dm_out[pos] = d[k];
    }
  }
  if (carried) {
    // x_out = obs[0] + beta[0], less its max
    float x[SPT][RT];
    __syncthreads();  // s_u's last readers are done
    if (tl.active) {
#pragma unroll
      for (int q = 0; q < SPT; ++q)
#pragma unroll
        for (int k = 0; k < RT; ++k) {
          if (!tl.has(q, S)) continue;
          x[q][k] = (tl.live[k] ? obs[(tl.b0 + k) * L * S + tl.jq(q)]
                                : 0.0f) +
                    b[q][k];
          tl.s_u[(tl.row + k) * S + tl.jq(q)] = x[q][k];
        }
    }
    __syncthreads();
    tl.rows_max(S, kLogZero);
    __syncthreads();
    if (tl.active) {
#pragma unroll
      for (int q = 0; q < SPT; ++q)
#pragma unroll
        for (int k = 0; k < RT; ++k)
          if (tl.has(q, S) && tl.live[k])
            x_out[(tl.b0 + k) * S + tl.jq(q)] =
                x[q][k] - tl.s_m[tl.row + k];
    }
  }
}

// K7a/K8a to 32 states, a warp a row (scan_rows.cuh, lanes): the function
// and the bits of fwd_scaled_kernel, carry mode included.  Lane j holds
// column j of exp(log_trans), a_j and e_j = expf(a_j) (lanes past S: e =
// 0); a step is lanes_product, log, + obs, the exact row max and a - m.
template <int NS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    fwd_scaled_lanes_kernel(const float* __restrict__ obs,
                            const int32_t* __restrict__ lens,
                            const float* __restrict__ log_start,
                            const float* __restrict__ carry_in,
                            const float* __restrict__ trans_p,
                            float* __restrict__ alpha_out,
                            float* __restrict__ dm_out,
                            float* __restrict__ carry_out, int64_t B,
                            int64_t L, int S) {
  extern __shared__ __align__(16) float smem[];  // a ring a warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t b = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;
  const bool mine = lane < S;
  const bool tail = (S & 3) != 0;
  const bool carried = carry_in != nullptr;
  float* ring = smem + warp * (2 * kHalf * 32) + lane;
  float mc[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i)
    mc[i] = mine && i < S ? trans_p[(int64_t)i * S + lane] : 0.0f;
  float a = carried && mine ? carry_in[b * S + lane] : 0.0f;
  float e = mine ? expf(a) : 0.0f;
  const float start = mine && !carried ? log_start[lane] : 0.0f;
  const int64_t n = max((int64_t)0, min((int64_t)lens[b], L));
  const float* ob = obs + b * L * S + lane;
  // the next stores of each output, walked by pointer
  float* hb = alpha_out != nullptr ? alpha_out + b * L * S + lane : nullptr;
  float* db = dm_out != nullptr ? dm_out + b * L : nullptr;
  stage_column(ring, ob, 0, n, S, mine);
  stage_column(ring, ob, kHalf, n, S, mine);
  for (int64_t t0 = 0; t0 < n; t0 += kHalf) {
    cp_async_wait<1>();  // this half is in; the next may be in flight
    const float* src = ring + ((t0 / kHalf) & 1) * kHalf * 32;
    const int steps = (int)min((int64_t)kHalf, n - t0);
    for (int k = 0; k < steps; ++k) {
      const float o = src[k * 32];
      float u;
      if (!carried && t0 + k == 0) {
        u = start + o;
      } else {
        const float s = lanes_product<NS>(e, mc, tail);
        u = (s > 0.0f ? logf(s) : kLogZero) + o;
      }
      const float m = lanes_max<NS>(u, mine, kLogZero);
      a = u - m;
      e = mine ? expf(a) : 0.0f;
      if (hb != nullptr) {
        if (mine) *hb = a;
        hb += S;
      }
      if (db != nullptr) {
        if (lane == 0) *db = m;
        ++db;
      }
    }
    stage_column(ring, ob, t0 + 2 * kHalf, n, S, mine);
  }
  cp_async_wait<0>();
  int64_t t = n;
  if (!carried && n == 0) {
    // position 0 of a zero-length row: every u is LOG_ZERO, so a = 0 and
    // dm = LOG_ZERO, as the reference renormalizes it
    a = 0.0f;
    if (hb != nullptr) {
      if (mine) *hb = a;
      hb += S;
    }
    if (db != nullptr) {
      if (lane == 0) *db = kLogZero;
      ++db;
    }
    t = 1;
  }
  // past the row's length: the carried row, zero normalizers
  for (; t < L; ++t) {
    if (hb != nullptr) {
      if (mine) *hb = a;
      hb += S;
    }
    if (db != nullptr) {
      if (lane == 0) *db = 0.0f;
      ++db;
    }
  }
  if (carry_out != nullptr && mine) carry_out[b * S + lane] = a;
}

// K7b/K8b to 32 states, a warp a row: the function and the bits of
// bwd_scaled_kernel, carry mode included.  Lane j holds column j of
// trans_t (row j of exp(log_trans)).  From position n - 1 of a row of
// length n up, beta is that of the boundary step (X2's carry mode) or 0,
// with normalizer 0; below, the chain: x = obs[t + 1] + beta[t + 1], its
// exact max xm, e = expf(x - xm), lanes_product, log, its max nm, beta[t]
// = s - nm and dm[t] = xm + nm.
template <int NS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    bwd_scaled_lanes_kernel(const float* __restrict__ obs,
                            const int32_t* __restrict__ lens,
                            const float* __restrict__ x_carry,
                            const int32_t* __restrict__ continuing,
                            const float* __restrict__ trans_t,
                            float* __restrict__ beta_out,
                            float* __restrict__ dm_out,
                            float* __restrict__ x_out, int64_t B, int64_t L,
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
  const float* ob = obs + b * L * S + lane;
  float bv = 0.0f;
  if (x_carry != nullptr) {
    // the boundary step at position L - 1: exp(x_carry) through the
    // product, beta where the row continues
    const float e = mine ? expf(x_carry[b * S + lane]) : 0.0f;
    float s = lanes_product<NS>(e, mc, tail);
    s = s > 0.0f ? logf(s) : kLogZero;
    const float nm = lanes_max<NS>(s, mine, kLogZero);
    if (continuing[b] != 0) bv = s - nm;
  }
  float* bb = beta_out + b * L * S + lane;
  float* db = dm_out != nullptr ? dm_out + b * L : nullptr;
  for (int64_t t = max(n - 1, (int64_t)0); t < L; ++t) {
    if (mine) bb[t * S] = bv;
    if (db != nullptr && lane == 0) db[t] = 0.0f;
  }
  // the chain: step r at t = n - 2 - r reads position t + 1 = n - 1 - r
  stage_column_reverse(ring, ob, 0, n, S, mine);
  stage_column_reverse(ring, ob, kHalf, n, S, mine);
  for (int64_t r0 = 0; r0 < n - 1; r0 += kHalf) {
    cp_async_wait<1>();  // this half is in; the next may be in flight
    const float* src = ring + ((r0 / kHalf) & 1) * kHalf * 32;
    const int steps = (int)min((int64_t)kHalf, n - 1 - r0);
    for (int k = 0; k < steps; ++k) {
      const int64_t t = n - 2 - (r0 + k);
      const float x = src[k * 32] + bv;
      const float xm = lanes_max<NS>(x, mine, kLogZero);
      const float e = mine ? expf(x - xm) : 0.0f;
      float s = lanes_product<NS>(e, mc, tail);
      s = s > 0.0f ? logf(s) : kLogZero;
      const float nm = lanes_max<NS>(s, mine, kLogZero);
      bv = s - nm;
      if (mine) bb[t * S] = bv;
      if (db != nullptr && lane == 0) db[t] = xm + nm;
    }
    stage_column_reverse(ring, ob, r0 + 2 * kHalf, n, S, mine);
  }
  cp_async_wait<0>();
  if (x_out != nullptr) {
    // x_out = obs[0] + beta[0], less its max
    const float x = (mine ? ob[0] : 0.0f) + bv;
    const float xm = lanes_max<NS>(x, mine, kLogZero);
    if (mine) x_out[b * S + lane] = x - xm;
  }
}

// K7a/K8a from 33 to 256 states (scan_rows.cuh, rows): the function and
// the bits of fwd_scaled_kernel, carry mode included.  A step: the product
// over the block's R rows, u = log(s) + obs, the row max (one barrier),
// a = u - m, exp(a) into the state vectors (a second).
template <int R, int KR>
__global__ void __launch_bounds__(kRowsMaxThreads)
    fwd_scaled_rows_kernel(const float* __restrict__ obs,
                           const int32_t* __restrict__ lens,
                           const float* __restrict__ log_start,
                           const float* __restrict__ carry_in,
                           const float* __restrict__ trans_p,
                           float* __restrict__ alpha_out,
                           float* __restrict__ dm_out,
                           float* __restrict__ carry_out, int64_t B,
                           int64_t L, int S) {
  extern __shared__ __align__(16) float smem[];
  RowsTile<R, KR> tl(smem, trans_p, lens, B, L, S);
  const bool carried = carry_in != nullptr;
  const bool has = tl.has;
  const int j = tl.j;
  const float start_j = has && !carried ? log_start[j] : 0.0f;
  float a[R], e[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    a[r] = carried && has && tl.live[r] ? carry_in[(tl.b0 + r) * S + j]
                                        : 0.0f;
    e[r] = expf(a[r]);
  }
  // the steps that run; past them every row of the block is past its end
  const int64_t steps = carried ? tl.max_len : max(tl.max_len, 1);
  tl.template stage<false>(obs, L, 0, steps);
  tl.template stage<false>(obs, L, kRowsHalf, steps);
  if (carried) tl.put(e);
  __syncthreads();
  for (int64_t t0 = 0; t0 < steps; t0 += kRowsHalf) {
    cp_async_wait<1>();  // this half is in; the next may be in flight
    const int n = (int)min((int64_t)kRowsHalf, steps - t0);
    for (int k = 0; k < n; ++k) {
      const int64_t t = t0 + k;
      float o[R], u[R], m[R];
      tl.template ring_obs<false>(L, t, o);
      const bool first = t == 0 && !carried;
      if (first) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          u[r] = tl.len[r] > 0 ? start_j + o[r] : kLogZero;
      } else {
        float s[R];
        tl.product(s);
#pragma unroll
        for (int r = 0; r < R; ++r)
          u[r] = (s[r] > 0.0f ? logf(s[r]) : kLogZero) + o[r];
      }
      tl.row_max(u, m, 0, kLogZero);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // position 0 is renormalized in every row, as the reference does
        const bool valid = first || t < tl.len[r];
        if (valid) a[r] = u[r] - m[r];
        e[r] = expf(a[r]);
        if (!tl.live[r]) continue;
        const int64_t pos = (tl.b0 + r) * L + t;
        if (alpha_out != nullptr && has) alpha_out[pos * S + j] = a[r];
        if (dm_out != nullptr && j == 0) dm_out[pos] = valid ? m[r] : 0.0f;
      }
      tl.put(e);
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
      if (alpha_out != nullptr && has) alpha_out[pos * S + j] = a[r];
      if (dm_out != nullptr && j == 0) dm_out[pos] = 0.0f;
    }
  }
  if (carry_out != nullptr && has) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (tl.live[r]) carry_out[(tl.b0 + r) * S + j] = a[r];
  }
}

// K7b/K8b from 33 to 256 states: the function and the bits of
// bwd_scaled_kernel, carry mode included.  Step s at t = L - 1 - s: x =
// obs[t + 1] + beta, its row max xm (one barrier), exp(x - xm) into the
// state vectors (a second), the product, log, the row max nm (a third);
// the two maxima have a partial buffer each.
template <int R, int KR>
__global__ void __launch_bounds__(kRowsMaxThreads)
    bwd_scaled_rows_kernel(const float* __restrict__ obs,
                           const int32_t* __restrict__ lens,
                           const float* __restrict__ x_carry,
                           const int32_t* __restrict__ continuing,
                           const float* __restrict__ trans_t,
                           float* __restrict__ beta_out,
                           float* __restrict__ dm_out,
                           float* __restrict__ x_out, int64_t B, int64_t L,
                           int S) {
  extern __shared__ __align__(16) float smem[];
  RowsTile<R, KR> tl(smem, trans_t, lens, B, L, S);
  const bool carried = x_carry != nullptr;
  const bool has = tl.has;
  const int j = tl.j;
  float bv[R];
  bool cont[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    bv[r] = 0.0f;
    cont[r] = carried && tl.live[r] && continuing[tl.b0 + r] != 0;
  }
  tl.template stage<true>(obs, L, 0, L);
  tl.template stage<true>(obs, L, kRowsHalf, L);
  for (int64_t s0 = 0; s0 < L; s0 += kRowsHalf) {
    cp_async_wait<1>();  // this half is in; the next may be in flight
    const int n = (int)min((int64_t)kRowsHalf, L - s0);
    for (int k = 0; k < n; ++k) {
      const int64_t t = L - 1 - (s0 + k);
      float dv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) dv[r] = 0.0f;
      if (carried && t == L - 1) {
        // the boundary step: exp(x_carry) through the product
        float e[R], s[R], nm[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          e[r] = expf(has && tl.live[r] ? x_carry[(tl.b0 + r) * S + j]
                                        : 0.0f);
        tl.put(e);
        __syncthreads();
        tl.product(s);
#pragma unroll
        for (int r = 0; r < R; ++r)
          s[r] = s[r] > 0.0f ? logf(s[r]) : kLogZero;
        tl.row_max(s, nm, 1, kLogZero);
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (cont[r]) bv[r] = s[r] - nm[r];
      } else if (t + 1 < tl.max_len) {
        float o[R], x[R], xm[R], e[R], s[R], nm[R];
        tl.template ring_obs<true>(L, s0 + k, o);
#pragma unroll
        for (int r = 0; r < R; ++r) x[r] = o[r] + bv[r];
        tl.row_max(x, xm, 0, kLogZero);
#pragma unroll
        for (int r = 0; r < R; ++r) e[r] = expf(x[r] - xm[r]);
        tl.put(e);
        __syncthreads();
        tl.product(s);
#pragma unroll
        for (int r = 0; r < R; ++r)
          s[r] = s[r] > 0.0f ? logf(s[r]) : kLogZero;
        tl.row_max(s, nm, 1, kLogZero);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (t + 1 < tl.len[r]) {
            bv[r] = s[r] - nm[r];
            dv[r] = xm[r] + nm[r];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!tl.live[r]) continue;
        const int64_t pos = (tl.b0 + r) * L + t;
        if (has) beta_out[pos * S + j] = bv[r];
        if (dm_out != nullptr && j == 0) dm_out[pos] = dv[r];
      }
    }
    tl.template stage<true>(obs, L, s0 + 2 * kRowsHalf, L);
  }
  cp_async_wait<0>();
  if (carried) {
    // x_out = obs[0] + beta[0], less its max
    float x[R], xm[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      x[r] = tl.obs_at(obs, L, r, 0, has && tl.live[r]) + bv[r];
    tl.row_max(x, xm, 0, kLogZero);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (has && tl.live[r]) x_out[(tl.b0 + r) * S + j] = x[r] - xm[r];
  }
}

// K7a/K8a past 256 states on the cluster tile (scan_cluster.cuh): the
// function and the bits of fwd_scaled_kernel, carry mode included.  A
// step: the product over the block's slice, u = log(s) + obs, the
// cluster's row max (an exchange), a = u - m, exp(a) into every block's
// state vector (a second).
template <int R>
__global__ void __launch_bounds__(kClusterThreads, 1)
    fwd_scaled_cluster_kernel(const float* __restrict__ obs,
                              const int32_t* __restrict__ lens,
                              const float* __restrict__ log_start,
                              const float* __restrict__ carry_in,
                              const float* __restrict__ trans_p,
                              float* __restrict__ alpha_out,
                              float* __restrict__ dm_out,
                              float* __restrict__ carry_out, int64_t B,
                              int64_t L, int S, int n_res) {
  extern __shared__ __align__(16) float smem[];
  using Tile = ClusterTile<R>;
  constexpr int kOwn = Tile::kOwn;
  Tile tl(smem, trans_p, lens, B, L, S, n_res, 1);
  const bool carried = carry_in != nullptr;
  // where this thread's cells are in obs and the [B, S] rows
  int64_t cell[kOwn];
  float a[kOwn], o_next[kOwn];
  const float start_j = tl.has_col && !carried ? log_start[tl.gj] : 0.0f;
#pragma unroll
  for (int m = 0; m < kOwn; ++m) {
    cell[m] = tl.b0 + tl.own_k[m];
    a[m] = carried && tl.own_has[m] && tl.own_live[m]
               ? carry_in[cell[m] * S + tl.gj]
               : 0.0f;
    o_next[m] = tl.own_has[m] && tl.own_len[m] > 0
                    ? obs[cell[m] * L * S + tl.gj]
                    : 0.0f;
  }
  if (carried) tl.template fill_state<ProbOps>(carry_in, B);
  const bool writes_dm = tl.rank == 0 && tl.col == 0 && dm_out != nullptr;

  for (int64_t t = 0; t < L; ++t) {
    if ((t > 0 || carried) && t >= tl.max_len) {
      // every row of the cluster is past its end: carried rows, zeros
#pragma unroll
      for (int m = 0; m < kOwn; ++m) {
        if (!tl.own_live[m]) continue;
        const int64_t pos = cell[m] * L + t;
        if (alpha_out != nullptr && tl.own_has[m])
          alpha_out[pos * S + tl.gj] = a[m];
        if (writes_dm) dm_out[pos] = 0.0f;
      }
      continue;
    }
    float o[kOwn], u[kOwn], mx[kOwn], e[kOwn];
#pragma unroll
    for (int m = 0; m < kOwn; ++m) {
      o[m] = o_next[m];
      o_next[m] = tl.own_has[m] && t + 1 < tl.own_len[m]
                      ? obs[(cell[m] * L + t + 1) * S + tl.gj]
                      : 0.0f;
    }
    const bool first = t == 0 && !carried;
    if (first) {
#pragma unroll
      for (int m = 0; m < kOwn; ++m)
        u[m] = tl.own_len[m] > 0 ? start_j + o[m] : kLogZero;
    } else {
      float s[R], so[kOwn];
      tl.template product<ProbOps>(s);
      tl.own(s, so);
#pragma unroll
      for (int m = 0; m < kOwn; ++m)
        u[m] = (so[m] > 0.0f ? logf(so[m]) : kLogZero) + o[m];
    }
    tl.template rows_max<0>(u, mx, kLogZero);
#pragma unroll
    for (int m = 0; m < kOwn; ++m) {
      // position 0 is renormalized in every row, as the reference does
      const bool valid = first || t < tl.own_len[m];
      if (valid) a[m] = u[m] - mx[m];
      e[m] = expf(a[m]);
      if (!tl.own_live[m]) continue;
      const int64_t pos = cell[m] * L + t;
      if (alpha_out != nullptr && tl.own_has[m])
        alpha_out[pos * S + tl.gj] = a[m];
      if (writes_dm) dm_out[pos] = valid ? mx[m] : 0.0f;
    }
    tl.broadcast(e);
  }
  if (carry_out != nullptr) {
#pragma unroll
    for (int m = 0; m < kOwn; ++m)
      if (tl.own_has[m] && tl.own_live[m])
        carry_out[cell[m] * S + tl.gj] = a[m];
  }
  tl.finish();
}

// K7b/K8b past 256 states on the cluster tile: the function and the bits
// of bwd_scaled_kernel, carry mode included.  A step: x = obs + beta, the
// cluster's max xm (an exchange), exp(x - xm) into every block's state
// vector (a second), the product over the block's slice, log, the
// cluster's max nm (a third).  The two maxima have a buffer and an
// mbarrier each.
template <int R>
__global__ void __launch_bounds__(kClusterThreads, 1)
    bwd_scaled_cluster_kernel(const float* __restrict__ obs,
                              const int32_t* __restrict__ lens,
                              const float* __restrict__ x_carry,
                              const int32_t* __restrict__ continuing,
                              const float* __restrict__ trans_t,
                              float* __restrict__ beta_out,
                              float* __restrict__ dm_out,
                              float* __restrict__ x_out, int64_t B,
                              int64_t L, int S, int n_res) {
  extern __shared__ __align__(16) float smem[];
  using Tile = ClusterTile<R>;
  constexpr int kOwn = Tile::kOwn;
  Tile tl(smem, trans_t, lens, B, L, S, n_res, 2);
  const bool carried = x_carry != nullptr;
  int64_t cell[kOwn];
  float b[kOwn], o_next[kOwn], o_next2[kOwn];
  bool cont[kOwn];
  // the first in-chunk step that runs reads position max_len - 1
  const int64_t t1 = tl.max_len - 1;
#pragma unroll
  for (int m = 0; m < kOwn; ++m) {
    cell[m] = tl.b0 + tl.own_k[m];
    cont[m] = carried && tl.own_live[m] && continuing[cell[m]] != 0;
    const int64_t base = cell[m] * L * S + tl.gj;
    b[m] = 0.0f;
    o_next[m] = tl.own_has[m] && t1 >= 1 && t1 < tl.own_len[m]
                    ? obs[base + t1 * S]
                    : 0.0f;
    o_next2[m] = tl.own_has[m] && t1 >= 2 && t1 - 1 < tl.own_len[m]
                     ? obs[base + (t1 - 1) * S]
                     : 0.0f;
  }
  const bool writes_dm = tl.rank == 0 && tl.col == 0 && dm_out != nullptr;

  for (int64_t t = L - 1; t >= 0; --t) {
    float d[kOwn];
#pragma unroll
    for (int m = 0; m < kOwn; ++m) d[m] = 0.0f;
    if (carried && t == L - 1) {
      // the boundary step: exp(x_carry) through the product
      float s[R], so[kOwn], nm[kOwn];
      tl.template fill_state<ProbOps>(x_carry, B);
      tl.template product<ProbOps>(s);
      tl.own(s, so);
#pragma unroll
      for (int m = 0; m < kOwn; ++m)
        so[m] = so[m] > 0.0f ? logf(so[m]) : kLogZero;
      tl.template rows_max<1>(so, nm, kLogZero);
#pragma unroll
      for (int m = 0; m < kOwn; ++m)
        if (cont[m]) b[m] = so[m] - nm[m];
    } else if (t + 1 < tl.max_len) {
      float o[kOwn], x[kOwn], xm[kOwn], e[kOwn], s[R], so[kOwn], nm[kOwn];
#pragma unroll
      for (int m = 0; m < kOwn; ++m) {
        o[m] = o_next[m];
        o_next[m] = o_next2[m];
        o_next2[m] = tl.own_has[m] && t >= 2 && t - 1 < tl.own_len[m]
                         ? obs[(cell[m] * L + t - 1) * S + tl.gj]
                         : 0.0f;
        x[m] = o[m] + b[m];
      }
      tl.template rows_max<0>(x, xm, kLogZero);
#pragma unroll
      for (int m = 0; m < kOwn; ++m) e[m] = expf(x[m] - xm[m]);
      tl.broadcast(e);
      tl.template product<ProbOps>(s);
      tl.own(s, so);
#pragma unroll
      for (int m = 0; m < kOwn; ++m)
        so[m] = so[m] > 0.0f ? logf(so[m]) : kLogZero;
      tl.template rows_max<1>(so, nm, kLogZero);
#pragma unroll
      for (int m = 0; m < kOwn; ++m) {
        if (t + 1 < tl.own_len[m]) {
          b[m] = so[m] - nm[m];
          d[m] = xm[m] + nm[m];
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kOwn; ++m) {
      if (!tl.own_live[m]) continue;
      const int64_t pos = cell[m] * L + t;
      if (tl.own_has[m]) beta_out[pos * S + tl.gj] = b[m];
      if (writes_dm) dm_out[pos] = d[m];
    }
  }
  if (carried) {
    // x_out = obs[0] + beta[0], less its max
    float x[kOwn], xm[kOwn];
#pragma unroll
    for (int m = 0; m < kOwn; ++m)
      x[m] = (tl.own_has[m] && tl.own_live[m]
                  ? obs[cell[m] * L * S + tl.gj]
                  : 0.0f) +
             b[m];
    tl.template rows_max<0>(x, xm, kLogZero);
#pragma unroll
    for (int m = 0; m < kOwn; ++m)
      if (tl.own_has[m] && tl.own_live[m])
        x_out[cell[m] * S + tl.gj] = x[m] - xm[m];
  }
  tl.finish();
}

// best[q][k] = max_i (s_p[i][row + k] + M[i][jq(q)]) and arg[q][k] its
// first-hit i.  Narrow: the rows of M below n_s from shared memory and the
// rest through the read-only path, four partial maxima over i = 0, 1, 2, 3
// (mod 4), each with the index that set it (strict >, so the lowest within
// a chain), combined by value and then by the lower index.  Wide: one
// chain in row order with a strict >, which is the same first hit.
template <int SPT, int RT>
__device__ __forceinline__ void maxplus_argmax(
    const Tile<SPT, RT>& tl, const float* __restrict__ mat, int S, int n_s,
    int n_slots, float (&best)[SPT][RT], int (&arg)[SPT][RT]) {
  if constexpr (SPT > 1) {
#pragma unroll
    for (int q = 0; q < SPT; ++q)
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        best[q][k] = -INFINITY;
        arg[q][k] = S;
      }
    tl.sweep_rows(mat, S, n_s, n_slots, [&](int i, int,
                                            const float (&pv)[RT],
                           const float (&tv)[SPT]) {
#pragma unroll
      for (int q = 0; q < SPT; ++q)
#pragma unroll
        for (int k = 0; k < RT; ++k) {
          const float c = pv[k] + tv[q];
          if (c > best[q][k]) {
            best[q][k] = c;
            arg[q][k] = i;
          }
        }
    });
  } else {
    float a[RT][4];
    int ia[RT][4];
#pragma unroll
    for (int k = 0; k < RT; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[k][q] = -INFINITY;
        ia[k][q] = S;
      }
    const int j = tl.j;
    const float* p = tl.s_p + tl.row;
    const int S4 = S & ~3;
    const int n4 = n_s < S ? n_s : S4;
    // as Tile::product: a group's operands are loaded before its steps
    float tv[4], pv4[4][RT];
    auto steps = [&](int i) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int k = 0; k < RT; ++k) {
          const float c = pv4[q][k] + tv[q];
          if (c > a[k][q]) {
            a[k][q] = c;
            ia[k][q] = i + q;
          }
        }
    };
    for (int i = 0; i < n4; i += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        tv[q] = tl.s_T[(i + q) * S + j];
        load_rows<RT>(p + (i + q) * tl.R, pv4[q]);
      }
      steps(i);
    }
    for (int i = n4; i < S4; i += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        tv[q] = __ldg(mat + (int64_t)(i + q) * S + j);
        load_rows<RT>(p + (i + q) * tl.R, pv4[q]);
      }
      steps(i);
    }
    float pv[RT];
    for (int i = S4; i < S; ++i) {
      const float t1 =
          i < n_s ? tl.s_T[i * S + j] : __ldg(mat + (int64_t)i * S + j);
      load_rows<RT>(p + i * tl.R, pv);
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        const float c = pv[k] + t1;
        if (c > a[k][0]) {
          a[k][0] = c;
          ia[k][0] = i;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      best[0][k] = a[k][0];
      arg[0][k] = ia[k][0];
#pragma unroll
      for (int q = 1; q < 4; ++q) {
        if (a[k][q] > best[0][k] ||
            (a[k][q] == best[0][k] && ia[k][q] < arg[0][k])) {
          best[0][k] = a[k][q];
          arg[0][k] = ia[k][q];
        }
      }
    }
  }
}

// K8c: K5's max-plus forward with the argmax predecessor of every state
// written at every position (the identity at position 0 and at padding):
// uint8 pointers up to 256 states (SPT = 1), uint16 beyond; the last value
// row and the normalizers go out.
template <int SPT, int RT>
__global__ void __launch_bounds__(kThreads)
    viterbi_ptrs_kernel(const float* __restrict__ obs,
                        const int32_t* __restrict__ lens,
                        const float* __restrict__ log_start,
                        const float* __restrict__ log_trans,
                        void* __restrict__ ptr_void,
                        float* __restrict__ v_last,
                        float* __restrict__ dm_out, int64_t B, int64_t L,
                        int S, int n_s, int n_slots) {
  using PtrT = std::conditional_t<(SPT > 1), uint16_t, uint8_t>;
  PtrT* ptr_out = static_cast<PtrT*>(ptr_void);
  extern __shared__ __align__(16) float smem[];
  Tile<SPT, RT> tl(smem, log_trans, lens, B, L, S, n_s);
  float v[SPT][RT], o_next[SPT][RT], start_j[SPT];
#pragma unroll
  for (int q = 0; q < SPT; ++q) {
    start_j[q] = tl.has(q, S) ? log_start[tl.jq(q)] : 0.0f;
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      v[q][k] = 0.0f;
      o_next[q][k] = tl.has(q, S) && tl.len[k] > 0
                         ? obs[(tl.b0 + k) * L * S + tl.jq(q)]
                         : 0.0f;
    }
  }

  for (int64_t t = 0; t < L; ++t) {
    if (t >= tl.max_len) {
      // every row of the block is past its end: identity pointers, zeros
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        if (!tl.live[k]) continue;
        const int64_t pos = (tl.b0 + k) * L + t;
#pragma unroll
        for (int q = 0; q < SPT; ++q)
          if (tl.has(q, S)) ptr_out[pos * S + tl.jq(q)] = (PtrT)tl.jq(q);
        if (tl.j == 0) dm_out[pos] = 0.0f;
      }
      continue;
    }
    float o[SPT][RT], u[SPT][RT];
    int arg[SPT][RT];
#pragma unroll
    for (int q = 0; q < SPT; ++q)
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        o[q][k] = o_next[q][k];
        o_next[q][k] = tl.has(q, S) && t + 1 < tl.len[k]
                           ? obs[((tl.b0 + k) * L + t + 1) * S + tl.jq(q)]
                           : 0.0f;
      }
    if (t == 0) {
#pragma unroll
      for (int q = 0; q < SPT; ++q)
#pragma unroll
        for (int k = 0; k < RT; ++k) {
          u[q][k] = start_j[q];
          arg[q][k] = tl.jq(q);
        }
    } else if (tl.active) {
      maxplus_argmax<SPT, RT>(tl, log_trans, S, n_s, n_slots, u, arg);
    }
    if (tl.active) {
#pragma unroll
      for (int q = 0; q < SPT; ++q)
#pragma unroll
        for (int k = 0; k < RT; ++k) {
          if (!tl.has(q, S)) continue;
          u[q][k] = u[q][k] + o[q][k];
          tl.s_u[(tl.row + k) * S + tl.jq(q)] = u[q][k];
        }
    }
    __syncthreads();
    tl.rows_max(S, kLogZero);
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
          if (valid) v[q][k] = u[q][k] - m;
          tl.s_p[tl.jq(q) * tl.R + tl.row + k] = v[q][k];
          if (tl.live[k])
            ptr_out[pos * S + tl.jq(q)] =
                (PtrT)(valid ? arg[q][k] : tl.jq(q));
        }
        if (tl.live[k] && tl.j == 0) dm_out[pos] = valid ? m : 0.0f;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < SPT; ++q)
#pragma unroll
    for (int k = 0; k < RT; ++k)
      if (tl.live[k] && tl.has(q, S))
        v_last[(tl.b0 + k) * S + tl.jq(q)] = v[q][k];
}

// K8c past 256 states on the cluster tile (scan_cluster.cuh): the function
// and the bits of viterbi_ptrs_kernel, uint16 pointers.  A step: the
// max-plus product over the block's slice with the first-hit argmax beside
// every partial maximum (ClusterTile::product_argmax; at position 0
// log_start and the identity), u = best + obs, the cluster's row max (an
// exchange), v = u - m on valid positions, v into every block's state
// vector (a second).  Every block holds the whole state vector, so no
// argmax crosses blocks.
template <int R>
__global__ void __launch_bounds__(kClusterThreads, 1)
    viterbi_ptrs_cluster_kernel(const float* __restrict__ obs,
                                const int32_t* __restrict__ lens,
                                const float* __restrict__ log_start,
                                const float* __restrict__ log_trans,
                                void* __restrict__ ptr_void,
                                float* __restrict__ v_last,
                                float* __restrict__ dm_out, int64_t B,
                                int64_t L, int S, int n_res) {
  uint16_t* ptr_out = static_cast<uint16_t*>(ptr_void);
  extern __shared__ __align__(16) float smem[];
  using Tile = ClusterTile<R>;
  constexpr int kOwn = Tile::kOwn;
  Tile tl(smem, log_trans, lens, B, L, S, n_res, 1);
  int64_t cell[kOwn];
  float v[kOwn], o_next[kOwn];
  const float start_j = tl.has_col ? log_start[tl.gj] : 0.0f;
  const uint16_t ident = (uint16_t)tl.gj;
#pragma unroll
  for (int m = 0; m < kOwn; ++m) {
    cell[m] = tl.b0 + tl.own_k[m];
    v[m] = 0.0f;
    o_next[m] = tl.own_has[m] && tl.own_len[m] > 0
                    ? obs[cell[m] * L * S + tl.gj]
                    : 0.0f;
  }
  const bool writes_dm = tl.rank == 0 && tl.col == 0;

  for (int64_t t = 0; t < L; ++t) {
    if (t >= tl.max_len) {
      // every row of the cluster is past its end: identity pointers, zeros
#pragma unroll
      for (int m = 0; m < kOwn; ++m) {
        if (!tl.own_live[m]) continue;
        const int64_t pos = cell[m] * L + t;
        if (tl.own_has[m]) ptr_out[pos * S + tl.gj] = ident;
        if (writes_dm) dm_out[pos] = 0.0f;
      }
      continue;
    }
    float o[kOwn], u[kOwn], mx[kOwn];
    int arg[kOwn];
#pragma unroll
    for (int m = 0; m < kOwn; ++m) {
      o[m] = o_next[m];
      o_next[m] = tl.own_has[m] && t + 1 < tl.own_len[m]
                      ? obs[(cell[m] * L + t + 1) * S + tl.gj]
                      : 0.0f;
    }
    if (t == 0) {
#pragma unroll
      for (int m = 0; m < kOwn; ++m) {
        u[m] = start_j;
        arg[m] = tl.gj;
      }
    } else {
      float best[R];
      int idx[R];
      tl.product_argmax(best, idx);
      tl.own(best, u);
      tl.own(idx, arg);
    }
#pragma unroll
    for (int m = 0; m < kOwn; ++m) u[m] = u[m] + o[m];
    tl.template rows_max<0>(u, mx, kLogZero);
#pragma unroll
    for (int m = 0; m < kOwn; ++m) {
      const bool valid = t < tl.own_len[m];
      if (valid) v[m] = u[m] - mx[m];
      if (!tl.own_live[m]) continue;
      const int64_t pos = cell[m] * L + t;
      if (tl.own_has[m])
        ptr_out[pos * S + tl.gj] = valid ? (uint16_t)arg[m] : ident;
      if (writes_dm) dm_out[pos] = valid ? mx[m] : 0.0f;
    }
    tl.broadcast(v);
  }
#pragma unroll
  for (int m = 0; m < kOwn; ++m)
    if (tl.own_has[m] && tl.own_live[m]) v_last[cell[m] * S + tl.gj] = v[m];
  tl.finish();
}

// K8c to 32 states, a warp a row (scan_rows.cuh, lanes): the function and
// the bits of viterbi_ptrs_kernel, uint8 pointers.  K3's lanes step in its
// pointer mode (common.cuh lanes_step): lane j holds column j of
// log_trans and every lane the whole row (-inf past S); a step's
// first-hit argmax (row_argmax over the candidates, the lowest i on ties;
// the -inf pads never win) is off the chain.  Position 0 is log_start +
// obs, renormalized, with the identity pointer.  dm as in
// viterbi_values_lanes_kernel; past the row's length the identity
// pointer and dm 0; v_last is the last row (0 for a row of length 0).
template <int NS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    viterbi_ptrs_lanes_kernel(const float* __restrict__ obs,
                              const int32_t* __restrict__ lens,
                              const float* __restrict__ log_start,
                              const float* __restrict__ log_trans,
                              uint8_t* __restrict__ ptr_out,
                              float* __restrict__ v_last,
                              float* __restrict__ dm_out, int64_t B,
                              int64_t L, int S) {
  extern __shared__ __align__(16) float smem[];  // a ring a warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t b = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;
  const bool mine = lane < S;  // lanes past S carry -inf
  float* ring = smem + warp * (2 * kHalf * 32) + lane;
  if (!mine)  // their obs stay 0, so their values stay -inf
    for (int k = 0; k < 2 * kHalf; ++k) ring[k * 32] = 0.0f;
  float tc[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i)
    tc[i] = mine && i < S ? log_trans[(int64_t)i * S + lane] : -INFINITY;
  float own = mine ? 0.0f : -INFINITY;
  float row[NS];  // set at position 0
  const float start = mine ? log_start[lane] : -INFINITY;
  const int64_t n = max((int64_t)0, min((int64_t)lens[b], L));
  const float* ob = obs + b * L * S + lane;
  uint8_t* pb = ptr_out + b * L * S + lane;  // the next pointer
  float* db = dm_out + b * L;
  float mk = 0.0f;  // lane k: the row max of step k of this half
  stage_column(ring, ob, 0, n, S, mine);
  stage_column(ring, ob, kHalf, n, S, mine);
  for (int64_t t0 = 0; t0 < n; t0 += kHalf) {
    cp_async_wait<1>();  // this half is in; the next may be in flight
    const float* src = ring + ((t0 / kHalf) & 1) * kHalf * 32;
    const int steps = (int)min((int64_t)kHalf, n - t0);
    auto emit = [&](int k, int arg, float m) {
      if (mine) *pb = (uint8_t)arg;
      pb += S;
      mk = lane == k ? m : mk;
    };
    int k = 0;
    if (t0 == 0) {
      float m;
      own = lanes_renorm<NS>(row, start + src[0], &m);
      emit(0, lane, m);
      k = 1;
    }
    for (; k < steps; ++k) {
      float m;
      int arg;
      own = lanes_step<NS>(row, tc, src[k * 32], &arg, &m);
      emit(k, arg, m);
    }
    if (lane < steps) db[t0 + lane] = mk;
    stage_column(ring, ob, t0 + 2 * kHalf, n, S, mine);
  }
  cp_async_wait<0>();
  // past the row's length: identity pointers, zero normalizers
  for (int64_t t = n; t < L; ++t) {
    if (mine) *pb = (uint8_t)lane;
    pb += S;
    if (lane == 0) db[t] = 0.0f;
  }
  if (mine) v_last[b * S + lane] = own;
}

// K8c from 33 to 256 states (scan_rows.cuh, rows): the function and the
// bits of viterbi_ptrs_kernel, uint8 pointers.  A step over the block's
// valid positions: the max-plus product with its first-hit argmax over
// the block's R rows (RowsTile::product_argmax; position 0: log_start and
// the identity), u = best + obs, the row max m floored at LOG_ZERO (one
// barrier), v = u - m and the argmax pointer where the position is valid
// (else the identity), v into the state vectors (a second).  The state
// vectors hold the log values v themselves, the matrix's pads are -inf.
// Past the block's longest row the identity pointers and dm 0; v_last is
// the last row (0 for a row of length 0).
template <int R, int KR>
__global__ void __launch_bounds__(kRowsMaxThreads,
                                  R == 1 && KR == 16 ? 2 : 1)
    viterbi_ptrs_rows_kernel(const float* __restrict__ obs,
                             const int32_t* __restrict__ lens,
                             const float* __restrict__ log_start,
                             const float* __restrict__ log_trans,
                             uint8_t* __restrict__ ptr_out,
                             float* __restrict__ v_last,
                             float* __restrict__ dm_out, int64_t B,
                             int64_t L, int S) {
  extern __shared__ __align__(16) float smem[];
  RowsTile<R, KR> tl(smem, log_trans, lens, B, L, S, -INFINITY);
  const bool has = tl.has;
  const int j = tl.j;
  const float start_j = has ? log_start[j] : 0.0f;
  float v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = 0.0f;
  // the steps that run; past them every row of the block is past its end
  const int64_t steps = tl.max_len;
  tl.template stage<false>(obs, L, 0, steps);
  tl.template stage<false>(obs, L, kRowsHalf, steps);
  for (int64_t t0 = 0; t0 < steps; t0 += kRowsHalf) {
    cp_async_wait<1>();  // this half is in; the next may be in flight
    const int n = (int)min((int64_t)kRowsHalf, steps - t0);
    for (int k = 0; k < n; ++k) {
      const int64_t t = t0 + k;
      float o[R], u[R], m[R];
      int arg[R];
      tl.template ring_obs<false>(L, t, o);
      if (t == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          u[r] = start_j + o[r];
          arg[r] = j;
        }
      } else {
        tl.product_argmax(u, arg);
#pragma unroll
        for (int r = 0; r < R; ++r) u[r] = u[r] + o[r];
      }
      tl.row_max(u, m, 0, kLogZero);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool valid = t < tl.len[r];
        if (valid) v[r] = u[r] - m[r];
        if (!tl.live[r]) continue;
        const int64_t pos = (tl.b0 + r) * L + t;
        if (has) ptr_out[pos * S + j] = (uint8_t)(valid ? arg[r] : j);
        if (j == 0) dm_out[pos] = valid ? m[r] : 0.0f;
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
      if (has) ptr_out[pos * S + j] = (uint8_t)j;
      if (j == 0) dm_out[pos] = 0.0f;
    }
  }
  if (has) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (tl.live[r]) v_last[(tl.b0 + r) * S + j] = v[r];
  }
}

// The chase: one thread per batch row walks the pointers back from the
// first-hit argmax of its last value row; zero-length rows get path 0.
template <typename PtrT>
__global__ void __launch_bounds__(kChaseThreads)
    pointer_chase_kernel(const PtrT* __restrict__ ptrs,
                         const float* __restrict__ v_last,
                         const int32_t* __restrict__ lens,
                         int32_t* __restrict__ path, int64_t B, int64_t L,
                         int S) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int32_t* out = path + b * L;
  if (lens[b] <= 0) {
    for (int64_t t = 0; t < L; ++t) out[t] = 0;
    return;
  }
  const float* v = v_last + b * S;
  int s = 0;
  float best = v[0];
  for (int i = 1; i < S; ++i) {
    const float x = v[i];
    if (x > best) {
      best = x;
      s = i;
    }
  }
  const PtrT* p = ptrs + b * L * S;
  out[L - 1] = s;
  for (int64_t t = L - 1; t > 0; --t) {
    s = p[t * S + s];
    out[t - 1] = s;
  }
}

// The log-space scans' launches by ``tile`` (scan_tile.cuh ScanTile):
// the block tile (the staged wide tile past 256 states), the cluster tile
// (257 to 1024 states), the lanes step (to 32), the rows kernels (33 to
// 256).
int launch_fwd(int tile, const float* obs, const int32_t* lens,
               const float* log_start, const float* carry_in,
               const float* trans_p, float* alpha_out, float* dm_out,
               float* carry_out, int64_t B, int64_t L, int S,
               void* stream) {
  if (tile == kTileCluster) {
    CLUSTER_KERNELS(ks, fwd_scaled_cluster_kernel);
    return launch_cluster_scan(ks, B, S, 1, stream, obs, lens, log_start,
                               carry_in, trans_p, alpha_out, dm_out,
                               carry_out, B, L, S);
  }
  if (tile == kTileLanes) {
    LANES_KERNELS(ks, fwd_scaled_lanes_kernel);
    return launch_lanes(ks, B, S, stream, obs, lens, log_start, carry_in,
                        trans_p, alpha_out, dm_out, carry_out, B, L, S);
  }
  if (tile == kTileRows) {
    ROWS_KERNELS(ks, fwd_scaled_rows_kernel);
    return launch_rows(ks, B, S, stream, obs, lens, log_start, carry_in,
                       trans_p, alpha_out, dm_out, carry_out, B, L, S);
  }
  TILE_KERNELS(ks, fwd_scaled_kernel);
  return launch_scan(ks, B, S, stream, obs, lens, log_start, carry_in,
                     trans_p, alpha_out, dm_out, carry_out, B, L, S);
}

int launch_bwd(int tile, const float* obs, const int32_t* lens,
               const float* x_carry, const int32_t* continuing,
               const float* trans_t, float* beta_out, float* dm_out,
               float* x_out, int64_t B, int64_t L, int S, void* stream) {
  if (tile == kTileCluster) {
    CLUSTER_KERNELS(ks, bwd_scaled_cluster_kernel);
    return launch_cluster_scan(ks, B, S, 2, stream, obs, lens, x_carry,
                               continuing, trans_t, beta_out, dm_out, x_out,
                               B, L, S);
  }
  if (tile == kTileLanes) {
    LANES_KERNELS(ks, bwd_scaled_lanes_kernel);
    return launch_lanes(ks, B, S, stream, obs, lens, x_carry, continuing,
                        trans_t, beta_out, dm_out, x_out, B, L, S);
  }
  if (tile == kTileRows) {
    ROWS_KERNELS(ks, bwd_scaled_rows_kernel);
    return launch_rows(ks, B, S, stream, obs, lens, x_carry, continuing,
                       trans_t, beta_out, dm_out, x_out, B, L, S);
  }
  TILE_KERNELS(ks, bwd_scaled_kernel);
  return launch_scan(ks, B, S, stream, obs, lens, x_carry, continuing,
                     trans_t, beta_out, dm_out, x_out, B, L, S);
}

}  // namespace

extern "C" {

// streaming.cu: K5's, K6a's and K6b's cluster plans, K6a's and K6b's rows
// plans
int tehmm_streaming_cluster_plan(int S, int64_t B, int kind, int64_t* out);
int tehmm_streaming_rows_plan(int S, int64_t B, int kind, int64_t* out);

// ``tile``: launch_fwd's.
int tehmm_fwd_scaled(const void* obs, const void* lens,
                     const void* log_start, const void* trans_p,
                     void* alpha_out, void* dm_out, int64_t B, int64_t L,
                     int S, int tile, void* stream) {
  return launch_fwd(tile, (const float*)obs, (const int32_t*)lens,
                    (const float*)log_start, nullptr, (const float*)trans_p,
                    (float*)alpha_out, (float*)dm_out, nullptr, B, L, S,
                    stream);
}

// X1's carry mode: hats (values mode) or dm (carry-only mode) may be null.
int tehmm_fwd_chunk_tile(const void* obs, const void* carry_in,
                         const void* lens, const void* trans_p, void* hats,
                         void* carry_out, void* dm, int64_t B, int64_t L,
                         int S, int tile, void* stream) {
  return launch_fwd(tile, (const float*)obs, (const int32_t*)lens,
                    nullptr, (const float*)carry_in, (const float*)trans_p,
                    (float*)hats, (float*)dm, (float*)carry_out, B, L, S,
                    stream);
}

int tehmm_bwd_scaled(const void* obs, const void* lens, const void* trans_t,
                     void* beta_out, void* dm_out, int64_t B, int64_t L,
                     int S, int tile, void* stream) {
  return launch_bwd(tile, (const float*)obs, (const int32_t*)lens,
                    nullptr, nullptr, (const float*)trans_t,
                    (float*)beta_out, (float*)dm_out, nullptr, B, L, S,
                    stream);
}

// X2's carry mode (L >= 1).
int tehmm_bwd_chunk_tile(const void* obs, const void* x_carry,
                         const void* continuing, const void* lens,
                         const void* trans_t, void* beta, void* x_out,
                         int64_t B, int64_t L, int S, int tile,
                         void* stream) {
  return launch_bwd(tile, (const float*)obs, (const int32_t*)lens,
                    (const float*)x_carry, (const int32_t*)continuing,
                    (const float*)trans_t, (float*)beta, nullptr,
                    (float*)x_out, B, L, S, stream);
}

// The cluster tile's plan of kernel ``kind`` (0 K7a/K8a, 1 K7b/K8b with
// its two max buffers, 2 K5 and K3's carry mode, 3 K8c, 4 K6a, 5 K6b with
// its two) at S states and B rows into out[12] (write_cluster_plan).
int tehmm_scan_cluster_plan(int S, int64_t B, int kind, int64_t* out) {
  if (kind == 0) {
    CLUSTER_KERNELS(ks, fwd_scaled_cluster_kernel);
    return write_cluster_plan(ks, S, B, 1, out);
  }
  if (kind == 1) {
    CLUSTER_KERNELS(ks, bwd_scaled_cluster_kernel);
    return write_cluster_plan(ks, S, B, 2, out);
  }
  if (kind == 3) {
    CLUSTER_KERNELS(ks, viterbi_ptrs_cluster_kernel);
    return write_cluster_plan(ks, S, B, 1, out);
  }
  return tehmm_streaming_cluster_plan(S, B, kind, out);
}

// The rows kernels' plan (scan_rows.cuh write_rows_plan) of kernel
// ``kind`` (0 K7a/K8a and X1's carry mode, 1 K7b/K8b and X2's, 2 K6a, 3
// K6b, 4 K5 and K3's carry mode, 5 K8c) at S states and B rows into
// out[8].
int tehmm_rows_plan(int S, int64_t B, int kind, int64_t* out) {
  if (kind == 0) {
    ROWS_KERNELS(ks, fwd_scaled_rows_kernel);
    return write_rows_plan(ks, B, S, out);
  }
  if (kind == 1) {
    ROWS_KERNELS(ks, bwd_scaled_rows_kernel);
    return write_rows_plan(ks, B, S, out);
  }
  if (kind == 5) {
    ROWS_KERNELS(ks, viterbi_ptrs_rows_kernel);
    return write_rows_plan(ks, B, S, out);
  }
  return tehmm_streaming_rows_plan(S, B, kind, out);
}

// ptr_out: uint8 for S <= 256, uint16 beyond; ``tile`` (scan_tile.cuh
// ScanTile): the block tile, the cluster tile (257 to 1024 states), the
// lanes step (to 32), the rows kernels (33 to 256).
int tehmm_viterbi_ptrs(const void* obs, const void* lens,
                       const void* log_start, const void* log_trans,
                       void* ptr_out, void* v_last, void* dm_out, int64_t B,
                       int64_t L, int S, int tile, void* stream) {
  const float* o = (const float*)obs;
  const int32_t* n = (const int32_t*)lens;
  const float* ls = (const float*)log_start;
  const float* lt = (const float*)log_trans;
  float* vl = (float*)v_last;
  float* dm = (float*)dm_out;
  if (tile == kTileCluster) {
    CLUSTER_KERNELS(ks, viterbi_ptrs_cluster_kernel);
    return launch_cluster_scan(ks, B, S, 1, stream, o, n, ls, lt, ptr_out,
                               vl, dm, B, L, S);
  }
  if (tile == kTileLanes) {
    LANES_KERNELS(ks, viterbi_ptrs_lanes_kernel);
    return launch_lanes(ks, B, S, stream, o, n, ls, lt, (uint8_t*)ptr_out,
                        vl, dm, B, L, S);
  }
  if (tile == kTileRows) {
    ROWS_KERNELS(ks, viterbi_ptrs_rows_kernel);
    return launch_rows(ks, B, S, stream, o, n, ls, lt, (uint8_t*)ptr_out,
                       vl, dm, B, L, S);
  }
  TILE_KERNELS(ks, viterbi_ptrs_kernel);
  return launch_scan(ks, B, S, stream, o, n, ls, lt, ptr_out, vl, dm, B, L,
                     S);
}

int tehmm_pointer_chase(const void* ptrs, const void* v_last,
                        const void* lens, void* path, int64_t B, int64_t L,
                        int S, void* stream) {
  if (S < 1 || states_per_thread(S) == 0) return (int)cudaErrorInvalidValue;
  const int64_t grid = (B + kChaseThreads - 1) / kChaseThreads;
  if (S <= kThreads) {
    pointer_chase_kernel<uint8_t><<<(unsigned)grid, kChaseThreads, 0,
                                    (cudaStream_t)stream>>>(
        (const uint8_t*)ptrs, (const float*)v_last, (const int32_t*)lens,
        (int32_t*)path, B, L, S);
  } else {
    pointer_chase_kernel<uint16_t><<<(unsigned)grid, kChaseThreads, 0,
                                     (cudaStream_t)stream>>>(
        (const uint16_t*)ptrs, (const float*)v_last, (const int32_t*)lens,
        (int32_t*)path, B, L, S);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
