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
//   viterbi_ptrs_kernel  K8c, _viterbi_kernel (:277) under viterbi_pallas
//                        (:333)
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
//             (the lowest index) on ties, as uint8 (S <= 256); only the
//             last value row is kept.  The chase walks the pointers back
//             from the first-hit argmax of that row.
// Positions at or past a row's length carry the row with a zero normalizer
// (the forward's position 0 excepted, as in the reference) and, in the
// Viterbi, the identity pointer, so paths replicate the last valid state.
//
// What bounds them on an H100: as streaming.cu's scans, the chain of L
// dependent steps; each step adds one expf and one logf per cell (the
// backward: a second max reduction) to K6's S-term product.  The chase is
// one dependent byte load per position.
//
// Design: scan_tile.cuh's tile (a block of 256 threads owns a tile of rows
// for the whole scan, one thread per state, one or two rows per thread, as
// many matrix rows as fit in shared memory and the rest through the
// read-only path).  The log-space scans keep the row's log values in
// registers and put its exp in the tile's state vectors, so the product
// is K6's (ProbOps) loop on the same matrix layout; the Viterbi's product
// tracks, beside each of its four partial maxima, the index that set it.
// The chase is one thread per batch row.
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

#include "scan_tile.cuh"

namespace {

constexpr int kChaseThreads = 32;  // threads per block of the chase

// K7a/K8a: log-space scaled forward values and their normalizers.
template <int RT>
__global__ void __launch_bounds__(kThreads)
    fwd_scaled_kernel(const float* __restrict__ obs,
                      const int32_t* __restrict__ lens,
                      const float* __restrict__ log_start,
                      const float* __restrict__ trans_p,
                      float* __restrict__ alpha_out,
                      float* __restrict__ dm_out, int64_t B, int64_t L,
                      int S, int n_s) {
  extern __shared__ __align__(16) float smem[];
  Tile<RT> tl(smem, trans_p, lens, B, L, S, n_s);
  const int j = tl.j;
  float a[RT], o_next[RT];
#pragma unroll
  for (int k = 0; k < RT; ++k) {
    a[k] = 0.0f;
    o_next[k] = tl.len[k] > 0 ? obs[(tl.b0 + k) * L * S + j] : 0.0f;
  }
  const float start_j = tl.active ? log_start[j] : 0.0f;

  for (int64_t t = 0; t < L; ++t) {
    if (t > 0 && t >= tl.max_len) {
      // every row of the block is past its end: carried rows, zeros
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        if (!tl.live[k]) continue;
        const int64_t pos = (tl.b0 + k) * L + t;
        alpha_out[pos * S + j] = a[k];
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
      for (int k = 0; k < RT; ++k)
        u[k] = tl.len[k] > 0 ? start_j + o[k] : kLogZero;
    } else if (tl.active) {
      float s[RT];
      tl.template product<ProbOps>(trans_p, S, n_s, s);
#pragma unroll
      for (int k = 0; k < RT; ++k)
        u[k] = (s[k] > 0.0f ? logf(s[k]) : kLogZero) + o[k];
    }
    if (tl.active) {
#pragma unroll
      for (int k = 0; k < RT; ++k) tl.s_u[(tl.row + k) * S + j] = u[k];
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
        const bool valid = t == 0 || t < tl.len[k];
        if (valid) a[k] = u[k] - m;
        tl.s_p[j * tl.R + tl.row + k] = expf(a[k]);
        if (tl.live[k]) {
          const int64_t pos = (tl.b0 + k) * L + t;
          alpha_out[pos * S + j] = a[k];
          if (j == 0) dm_out[pos] = valid ? m : 0.0f;
        }
      }
    }
    __syncthreads();
  }
}

// K7b/K8b: log-space scaled backward values and their normalizers.
// ``trans_t`` is exp(log_trans) transposed, so that
// s_i = sum_j trans[i][j] exp(x_j) runs through the tile's product loop.
template <int RT>
__global__ void __launch_bounds__(kThreads)
    bwd_scaled_kernel(const float* __restrict__ obs,
                      const int32_t* __restrict__ lens,
                      const float* __restrict__ trans_t,
                      float* __restrict__ beta_out,
                      float* __restrict__ dm_out, int64_t B, int64_t L,
                      int S, int n_s) {
  extern __shared__ __align__(16) float smem[];
  Tile<RT> tl(smem, trans_t, lens, B, L, S, n_s);
  const int j = tl.j;
  // A step consumes its observation row first thing, so the rows are
  // loaded two steps ahead (as in streaming.cu's backward).
  float b[RT], o_next[RT], o_next2[RT];
#pragma unroll
  for (int k = 0; k < RT; ++k) {
    b[k] = 0.0f;
    // the first step that runs reads position max_len - 1
    const int64_t t1 = tl.max_len - 1;
    o_next[k] = t1 >= 1 && t1 < tl.len[k]
                    ? obs[((tl.b0 + k) * L + t1) * S + j]
                    : 0.0f;
    o_next2[k] = t1 >= 2 && t1 - 1 < tl.len[k]
                     ? obs[((tl.b0 + k) * L + t1 - 1) * S + j]
                     : 0.0f;
  }

  for (int64_t t = L - 1; t >= 0; --t) {
    float d[RT];
#pragma unroll
    for (int k = 0; k < RT; ++k) d[k] = 0.0f;
    if (t + 1 < tl.max_len) {
      float o[RT], x[RT], xm[RT], s[RT];
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        o[k] = o_next[k];
        o_next[k] = o_next2[k];
        o_next2[k] = t >= 2 && t - 1 < tl.len[k]
                         ? obs[((tl.b0 + k) * L + t - 1) * S + j]
                         : 0.0f;
      }
      if (tl.active) {
#pragma unroll
        for (int k = 0; k < RT; ++k) {
          x[k] = o[k] + b[k];
          tl.s_u[(tl.row + k) * S + j] = x[k];
        }
      }
      __syncthreads();
      tl.rows_max(S, kLogZero);
      __syncthreads();
      if (tl.active) {
#pragma unroll
        for (int k = 0; k < RT; ++k) {
          xm[k] = tl.s_m[tl.row + k];
          tl.s_p[j * tl.R + tl.row + k] = expf(x[k] - xm[k]);
        }
      }
      __syncthreads();
      if (tl.active) {
        tl.template product<ProbOps>(trans_t, S, n_s, s);
#pragma unroll
        for (int k = 0; k < RT; ++k) {
          s[k] = s[k] > 0.0f ? logf(s[k]) : kLogZero;
          tl.s_u[(tl.row + k) * S + j] = s[k];
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
            b[k] = s[k] - nm;
            d[k] = xm[k] + nm;
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      if (!tl.live[k]) continue;
      const int64_t pos = (tl.b0 + k) * L + t;
      beta_out[pos * S + j] = b[k];
      if (j == 0) dm_out[pos] = d[k];
    }
  }
}

// best[k] = max_i (s_p[i][row + k] + M[i][j]) and arg[k] its first-hit i,
// over the rows of M below n_s from shared memory and the rest through the
// read-only path: four partial maxima over i = 0, 1, 2, 3 (mod 4), each
// with the index that set it (strict >, so the lowest within a chain),
// combined by value and then by the lower index.
template <int RT>
__device__ __forceinline__ void maxplus_argmax(const Tile<RT>& tl,
                                               const float* __restrict__ mat,
                                               int S, int n_s,
                                               float (&best)[RT],
                                               int (&arg)[RT]) {
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
  float pv[RT];
  for (int i = 0; i < n4; i += 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float tv = tl.s_T[(i + q) * S + j];
      load_rows<RT>(p + (i + q) * tl.R, pv);
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        const float c = pv[k] + tv;
        if (c > a[k][q]) {
          a[k][q] = c;
          ia[k][q] = i + q;
        }
      }
    }
  }
  for (int i = n4; i < S4; i += 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float tv = __ldg(mat + (int64_t)(i + q) * S + j);
      load_rows<RT>(p + (i + q) * tl.R, pv);
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        const float c = pv[k] + tv;
        if (c > a[k][q]) {
          a[k][q] = c;
          ia[k][q] = i + q;
        }
      }
    }
  }
  for (int i = S4; i < S; ++i) {
    const float tv =
        i < n_s ? tl.s_T[i * S + j] : __ldg(mat + (int64_t)i * S + j);
    load_rows<RT>(p + i * tl.R, pv);
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      const float c = pv[k] + tv;
      if (c > a[k][0]) {
        a[k][0] = c;
        ia[k][0] = i;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < RT; ++k) {
    best[k] = a[k][0];
    arg[k] = ia[k][0];
#pragma unroll
    for (int q = 1; q < 4; ++q) {
      if (a[k][q] > best[k] || (a[k][q] == best[k] && ia[k][q] < arg[k])) {
        best[k] = a[k][q];
        arg[k] = ia[k][q];
      }
    }
  }
}

// K8c: K5's max-plus forward with the argmax predecessor of every state
// written at every position (the identity at position 0 and at padding);
// the last value row and the normalizers go out.
template <int RT>
__global__ void __launch_bounds__(kThreads)
    viterbi_ptrs_kernel(const float* __restrict__ obs,
                        const int32_t* __restrict__ lens,
                        const float* __restrict__ log_start,
                        const float* __restrict__ log_trans,
                        uint8_t* __restrict__ ptr_out,
                        float* __restrict__ v_last,
                        float* __restrict__ dm_out, int64_t B, int64_t L,
                        int S, int n_s) {
  extern __shared__ __align__(16) float smem[];
  Tile<RT> tl(smem, log_trans, lens, B, L, S, n_s);
  const int j = tl.j;
  float v[RT], o_next[RT];
#pragma unroll
  for (int k = 0; k < RT; ++k) {
    v[k] = 0.0f;
    o_next[k] = tl.len[k] > 0 ? obs[(tl.b0 + k) * L * S + j] : 0.0f;
  }
  const float start_j = tl.active ? log_start[j] : 0.0f;

  for (int64_t t = 0; t < L; ++t) {
    if (t >= tl.max_len) {
      // every row of the block is past its end: identity pointers, zeros
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        if (!tl.live[k]) continue;
        const int64_t pos = (tl.b0 + k) * L + t;
        ptr_out[pos * S + j] = (uint8_t)j;
        if (j == 0) dm_out[pos] = 0.0f;
      }
      continue;
    }
    float o[RT], u[RT];
    int arg[RT];
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      o[k] = o_next[k];
      o_next[k] = t + 1 < tl.len[k]
                      ? obs[((tl.b0 + k) * L + t + 1) * S + j]
                      : 0.0f;
    }
    if (t == 0) {
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        u[k] = start_j;
        arg[k] = j;
      }
    } else if (tl.active) {
      maxplus_argmax<RT>(tl, log_trans, S, n_s, u, arg);
    }
    if (tl.active) {
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        u[k] = u[k] + o[k];
        tl.s_u[(tl.row + k) * S + j] = u[k];
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
        if (valid) v[k] = u[k] - m;
        tl.s_p[j * tl.R + tl.row + k] = v[k];
        if (tl.live[k]) {
          const int64_t pos = (tl.b0 + k) * L + t;
          ptr_out[pos * S + j] = (uint8_t)(valid ? arg[k] : j);
          if (j == 0) dm_out[pos] = valid ? m : 0.0f;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < RT; ++k)
    if (tl.live[k]) v_last[(tl.b0 + k) * S + j] = v[k];
}

// The chase: one thread per batch row walks the pointers back from the
// first-hit argmax of its last value row; zero-length rows get path 0.
__global__ void __launch_bounds__(kChaseThreads)
    pointer_chase_kernel(const uint8_t* __restrict__ ptrs,
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
  const uint8_t* p = ptrs + b * L * S;
  out[L - 1] = s;
  for (int64_t t = L - 1; t > 0; --t) {
    s = p[t * S + s];
    out[t - 1] = s;
  }
}

}  // namespace

extern "C" {

int tehmm_fwd_scaled(const void* obs, const void* lens,
                     const void* log_start, const void* trans_p,
                     void* alpha_out, void* dm_out, int64_t B, int64_t L,
                     int S, void* stream) {
  return launch_scan(fwd_scaled_kernel<1>, fwd_scaled_kernel<2>, B, S,
                     stream, (const float*)obs, (const int32_t*)lens,
                     (const float*)log_start, (const float*)trans_p,
                     (float*)alpha_out, (float*)dm_out, B, L, S);
}

int tehmm_bwd_scaled(const void* obs, const void* lens, const void* trans_t,
                     void* beta_out, void* dm_out, int64_t B, int64_t L,
                     int S, void* stream) {
  return launch_scan(bwd_scaled_kernel<1>, bwd_scaled_kernel<2>, B, S,
                     stream, (const float*)obs, (const int32_t*)lens,
                     (const float*)trans_t, (float*)beta_out,
                     (float*)dm_out, B, L, S);
}

int tehmm_viterbi_ptrs(const void* obs, const void* lens,
                       const void* log_start, const void* log_trans,
                       void* ptr_out, void* v_last, void* dm_out, int64_t B,
                       int64_t L, int S, void* stream) {
  return launch_scan(viterbi_ptrs_kernel<1>, viterbi_ptrs_kernel<2>, B, S,
                     stream, (const float*)obs, (const int32_t*)lens,
                     (const float*)log_start, (const float*)log_trans,
                     (uint8_t*)ptr_out, (float*)v_last, (float*)dm_out, B,
                     L, S);
}

int tehmm_pointer_chase(const void* ptrs, const void* v_last,
                        const void* lens, void* path, int64_t B, int64_t L,
                        int S, void* stream) {
  if (S < 1 || S > kThreads) return (int)cudaErrorInvalidValue;
  const int64_t grid = (B + kChaseThreads - 1) / kChaseThreads;
  pointer_chase_kernel<<<(unsigned)grid, kChaseThreads, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)ptrs, (const float*)v_last, (const int32_t*)lens,
      (int32_t*)path, B, L, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
