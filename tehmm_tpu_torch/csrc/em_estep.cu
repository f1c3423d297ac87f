// Hand-written Hopper (sm_90a) kernels for the fused Baum-Welch E-step.
//
// Built with viterbi.cu and posterior.cu into one shared library with a
// plain C interface (tehmm_tpu_torch/ops/cuda_kernels.py: one nvcc -c per
// source, then one link), loaded with ctypes; common.cuh holds the
// helpers the three share.  Every entry point launches on the stream it
// is given, allocates nothing (the Python wrapper allocates outputs with
// torch.empty) and returns the cudaGetLastError() that follows its launch.
//
// Kernels and the TPU kernels they replace
// (tehmm_tpu/ops/pallas_kernels.py, under em_counts_fused_pallas_v4
// :2127):
//
//   em_fwd_kernel        K1 forward, _make_forward_kernel_v4 (:1777)
//   em_bwd_stats_kernel  K1 reverse, _make_bwd_stats_kernel_v4 (:1931)
//
// What they compute, per batch row (one independent sequence):
//
//   forward, t = 0..L-1:  obs_p = exp(obs_log - max obs_log) with
//     obs_log[s] = sum_t log_em[s, t, x_t];  base = exp(log_start) at
//     t = 0, else sum_i T[i, j] p[i];  u = base * obs_p;
//     m = max(max u, 1e-37);  p <- u / m.  Writes alpha_p = p, dm =
//     log m + max obs_log (the loglik increment) and m_raw = m.
//   reverse, p = len-1..0, with b = 1 at the last valid position:
//     x = obs_p * b, xm = max(max x, 1e-37), xn = x / xm;
//     gamma = alpha_p * b / max(sum alpha_p * b, 1e-30) -> emission
//     counts at (s, t, x_t), start counts at p = 0;  for p >= 1,
//     pair[i, j] += alpha_{p-1}[i] * w * xn[j] with w = 1 / max(z, 1e-30)
//     and z = m_raw[p] * gden / xm (the forward-normalizer identity:
//     sum_ij alpha_{p-1}[i] T[i, j] xn[j] == m_p * sum_j alpha_p b / xm);
//     then b <- T xn / max(max T xn, 1e-37).
//   Positions t >= length carry p (and b) unchanged and count nothing.
//   With segment weights w and gaussian tracks (the optional streams of
//   common.cuh): obs_log is the categorical sum plus the gaussian term,
//   times w (obs_log); the emission counts take gamma * w, and the
//   gaussian moments (gn, gx, gx2)[j, g] sum gamma * w times (mask, x,
//   x^2) of track g; start counts and pairs stay unweighted.
//
// What bounds them on an H100: like the Viterbi kernels, each row is a
// chain of dependent steps (an S x S matrix-vector product from shared
// memory, a warp reduction or two, T table lookups), so per-step latency
// sets the time, not bytes or flops: at S = 20 a step is ~2*S*S = 800
// flops forward and ~3x that in reverse, against 4*S bytes of alpha
// written (forward) and read (reverse).  The design keeps every table
// (exp(trans), log_em, exp(start)) in shared memory, one warp per row with
// lane <-> state, obs recomputed from the symbols in registers in both
// kernels (never written to HBM), and in the reverse kernel each warp's
// statistics in its own shared-memory accumulators (lane j owns column j
// of pair and row j of the emission counts, so no atomics).  The reverse
// kernel runs 4, 2 or 1 warps per block, the most whose accumulators fit
// in shared memory (the caller picks, from S, T, V and the gaussian track
// count G), so the state envelope is set by one warp's copy of the
// statistics.  The gaussian coefficients [S, 3G] sit in shared memory
// beside log_em; the values (f32[B, L, G]) and weights (f32[B, L]) are
// read straight from global memory and mask, x and x^2 formed in
// registers, so the gaussian moments [S, 3G] accumulate like the
// emission counts (lane j owns row j).  Each block sums
// its warps' accumulators in warp order and writes one partial per block;
// the wrapper sums the partials over blocks.  Every sum has a fixed order,
// so two runs give the same bits.
//
// Numerics: FP32 FMA on the CUDA cores (no tensor cores: TF32 would miss
// the loglik contract of ~1e-7 relative, and at S <= 32 they buy
// nothing), full-precision expf/logf (no fast-math intrinsics), IEEE
// division, and every clamp of the TPU kernel kept exactly, so a model
// with zero transitions behaves as it does there.  All index arithmetic
// is 64-bit.

#include "common.cuh"

namespace {

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// K1 forward: symbols in; alpha_p [B, L, S], dm [B, L], m_raw [B, L] out.
template <int SPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    em_fwd_kernel(const int32_t* __restrict__ sym,
                  const int32_t* __restrict__ lens,
                  const float* __restrict__ start_p,
                  const float* __restrict__ trans_p,
                  const float* __restrict__ em,
                  float* __restrict__ alpha, float* __restrict__ dm_out,
                  float* __restrict__ mraw_out, int64_t B, int64_t L, int S,
                  int T, int V, ObsStreams st) {
  extern __shared__ float smem[];
  const int64_t TV = (int64_t)T * V;
  float* s_trans = smem;                       // exp(log_trans) [S, S]
  float* s_em = s_trans + (int64_t)S * S;      // log_em [S, T, V]
  float* s_start = s_em + S * TV;              // exp(log_start) [S]
  st.s_coef = s_start + S;                     // gaussian coefficients
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* s_p = st.s_coef + coef_floats(S, st.values, st.G) +
               (int64_t)warp * S;
  stage(s_trans, trans_p, (int64_t)S * S);
  stage(s_em, em, S * TV);
  stage(s_start, start_p, S);
  stage_coef(st, S);
  __syncthreads();

  const int64_t b = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;
  const int64_t len = lens[b];
  // zero-length rows carry this row of ones to every position
  for (int j = lane; j < S; j += 32) s_p[j] = 1.0f;
  __syncwarp();

  for (int64_t t = 0; t < L; ++t) {
    const int64_t pos = b * L + t;
    float obs_p[SPL];
    const float o_m = obs_probs<SPL>(s_em, sym + pos * T, S, T, V, lane,
                                     pos, st, obs_p);
    float u[SPL];
    float lmax = 0.0f;
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const int j = lane + 32 * k;
      if (j < S) {
        float base;
        if (t == 0) {
          base = s_start[j];
        } else {
          base = 0.0f;
          for (int i = 0; i < S; ++i)
            base = fmaf(s_trans[(int64_t)i * S + j], s_p[i], base);
        }
        u[k] = base * obs_p[k];
        lmax = fmaxf(lmax, u[k]);
      }
    }
    const float m = fmaxf(warp_max(lmax), 1e-37f);
    const bool valid = t < len;
    __syncwarp();  // every lane has read s_p for this step
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const int j = lane + 32 * k;
      if (j < S) {
        const float h = valid ? u[k] / m : s_p[j];
        s_p[j] = h;
        alpha[pos * S + j] = h;
      }
    }
    if (lane == 0) {
      dm_out[pos] = valid ? logf(m) + o_m : 0.0f;
      mraw_out[pos] = valid ? m : 1.0f;
    }
    __syncwarp();
  }
}

// per-warp shared-memory region of the reverse kernel:
// pair [S, S] | em [S, T, V] | start [S] | gaussian moments [S, 3G] |
// xn [S] | alpha_{p-1} [S]  (G3 = 3G, 0 without gaussian tracks)
__host__ __device__ __forceinline__ int64_t warp_region(int S, int T, int V,
                                                        int G3) {
  return (int64_t)S * S + (int64_t)S * T * V + (int64_t)S * G3 +
         3 * (int64_t)S;
}

// K1 reverse: alpha_p and m_raw in; per-block partial statistics out:
// pair_out [grid, S, S], em_out [grid, S, T, V], start_out [grid, S] and,
// with gaussian tracks, gmom_out [grid, S, 3G] (gn | gx | gx2).
// blockDim.x is 32 x (1, 2 or 4) warps, one row per warp.
template <int SPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    em_bwd_stats_kernel(const int32_t* __restrict__ sym,
                        const int32_t* __restrict__ lens,
                        const float* __restrict__ trans_p,
                        const float* __restrict__ em,
                        const float* __restrict__ alpha,
                        const float* __restrict__ mraw,
                        float* __restrict__ pair_out,
                        float* __restrict__ em_out,
                        float* __restrict__ start_out,
                        float* __restrict__ gmom_out, int64_t B, int64_t L,
                        int S, int T, int V, ObsStreams st) {
  extern __shared__ float smem[];
  const int64_t TV = (int64_t)T * V;
  const int64_t SS = (int64_t)S * S;
  const int G = st.values != nullptr ? st.G : 0;
  const int64_t SG3 = (int64_t)S * 3 * G;
  const int64_t region = warp_region(S, T, V, 3 * G);
  float* s_transT = smem;                      // exp(log_trans).T [S, S]
  float* s_em = s_transT + SS;                 // log_em [S, T, V]
  st.s_coef = s_em + S * TV;                   // gaussian coefficients
  float* s_warps = st.s_coef + SG3;            // one region per warp
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* acc_pair = s_warps + warp * region;
  float* acc_em = acc_pair + SS;
  float* acc_start = acc_em + S * TV;
  float* acc_g = acc_start + S;
  float* s_xn = acc_g + SG3;
  float* s_a = s_xn + S;

  stage_transposed(s_transT, trans_p, S);
  stage(s_em, em, S * TV);
  stage_coef(st, S);
  for (int64_t n = threadIdx.x; n < warps * region; n += blockDim.x)
    s_warps[n] = 0.0f;
  __syncthreads();

  const int64_t b = (int64_t)blockIdx.x * warps + warp;
  if (b < B) {
    const int64_t len = lens[b] < L ? (int64_t)lens[b] : L;
    float bv[SPL];
#pragma unroll
    for (int k = 0; k < SPL; ++k) bv[k] = 1.0f;

    for (int64_t p = len - 1; p >= 0; --p) {
      const int64_t pos = b * L + p;
      const int32_t* x = sym + pos * T;
      float xn[SPL];
      obs_probs<SPL>(s_em, x, S, T, V, lane, pos, st, xn);
      float ab[SPL];
      float xmax = 0.0f, abs_ = 0.0f;
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        const int j = lane + 32 * k;
        if (j < S) {
          xn[k] = xn[k] * bv[k];
          xmax = fmaxf(xmax, xn[k]);
          ab[k] = alpha[pos * S + j] * bv[k];
          abs_ += ab[k];
        }
      }
      const float xm = fmaxf(warp_max(xmax), 1e-37f);
      const float gden = fmaxf(warp_sum(abs_), 1e-30f);
      // gamma -> emission counts and gaussian moments (weighted by the
      // segment weight), start counts at p == 0 (unweighted)
      const float wp = st.w != nullptr ? st.w[pos] : 1.0f;
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        const int j = lane + 32 * k;
        if (j < S) {
          const float gamma = ab[k] / gden;
          const float gw = st.w != nullptr ? gamma * wp : gamma;
          float* row = acc_em + j * TV;
          for (int tt = 0; tt < T; ++tt) row[tt * V + x[tt]] += gw;
          if (G > 0) {
            const float* v = st.values + pos * G;
            float* mom = acc_g + (int64_t)j * 3 * G;
            for (int g = 0; g < G; ++g) {
              float m, xm, x2m;
              gauss_feats(v[g], m, xm, x2m);
              mom[g] += gw * m;
              mom[G + g] += gw * xm;
              mom[2 * G + g] += gw * x2m;
            }
          }
          if (p == 0) acc_start[j] += gamma;
          xn[k] = xn[k] / xm;
          s_xn[j] = xn[k];
        }
      }
      // pair: the transition into p (none into position 0)
      if (p >= 1) {
        const float z = mraw[pos] * gden / xm;
        const float w = 1.0f / fmaxf(z, 1e-30f);
#pragma unroll
        for (int k = 0; k < SPL; ++k) {
          const int j = lane + 32 * k;
          if (j < S) s_a[j] = alpha[(pos - 1) * S + j];
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < SPL; ++k) {
          const int j = lane + 32 * k;
          if (j < S) {
            const float c = w * xn[k];
            for (int i = 0; i < S; ++i)
              acc_pair[(int64_t)i * S + j] =
                  fmaf(s_a[i], c, acc_pair[(int64_t)i * S + j]);
          }
        }
      }
      __syncwarp();  // s_xn complete
      // b <- T xn / max(max T xn, 1e-37)
      float sb[SPL];
      float smax = 0.0f;
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        const int i = lane + 32 * k;
        if (i < S) {
          float acc = 0.0f;
          for (int j = 0; j < S; ++j)
            acc = fmaf(s_transT[(int64_t)j * S + i], s_xn[j], acc);
          sb[k] = acc;
          smax = fmaxf(smax, acc);
        }
      }
      const float nm = fmaxf(warp_max(smax), 1e-37f);
#pragma unroll
      for (int k = 0; k < SPL; ++k)
        if (lane + 32 * k < S) bv[k] = sb[k] / nm;
      __syncwarp();  // s_xn and s_a are free for the next step
    }
  }
  __syncthreads();

  // the block's partial: each entry summed over its warps in order
  const int64_t n_stats = SS + S * TV + S + SG3;
  const int64_t blk = blockIdx.x;
  for (int64_t n = threadIdx.x; n < n_stats; n += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < warps; ++w) s += s_warps[w * region + n];
    if (n < SS)
      pair_out[blk * SS + n] = s;
    else if (n < SS + S * TV)
      em_out[blk * S * TV + n - SS] = s;
    else if (n < SS + S * TV + S)
      start_out[blk * S + n - SS - S * TV] = s;
    else
      gmom_out[blk * SG3 + n - SS - S * TV - S] = s;
  }
}

template <int SPL>
int launch_fwd(const void* sym, const void* lens, const void* start_p,
               const void* trans_p, const void* em, void* alpha, void* dm,
               void* mraw, int64_t B, int64_t L, int S, int T, int V,
               const ObsStreams& st, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)S * S + (size_t)S * T * V + (size_t)S +
                       coef_floats(S, st.values, st.G) +
                       (size_t)kWarpsPerBlock * S);
  cudaError_t err = allow_smem(em_fwd_kernel<SPL>, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t grid = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  em_fwd_kernel<SPL><<<(unsigned)grid, kWarpsPerBlock * 32, smem, stream>>>(
      (const int32_t*)sym, (const int32_t*)lens, (const float*)start_p,
      (const float*)trans_p, (const float*)em, (float*)alpha, (float*)dm,
      (float*)mraw, B, L, S, T, V, st);
  return (int)cudaGetLastError();
}

template <int SPL>
int launch_bwd(const void* sym, const void* lens, const void* trans_p,
               const void* em, const void* alpha, const void* mraw,
               void* pair_out, void* em_out, void* start_out, void* gmom_out,
               int64_t B, int64_t L, int S, int T, int V, int warps,
               const ObsStreams& st, cudaStream_t stream) {
  const int G3 = (int)coef_floats(1, st.values, st.G);
  const size_t smem =
      sizeof(float) * ((size_t)S * S + (size_t)S * T * V + (size_t)S * G3 +
                       (size_t)warps * warp_region(S, T, V, G3));
  cudaError_t err = allow_smem(em_bwd_stats_kernel<SPL>, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t grid = (B + warps - 1) / warps;
  em_bwd_stats_kernel<SPL><<<(unsigned)grid, warps * 32, smem, stream>>>(
      (const int32_t*)sym, (const int32_t*)lens, (const float*)trans_p,
      (const float*)em, (const float*)alpha, (const float*)mraw,
      (float*)pair_out, (float*)em_out, (float*)start_out, (float*)gmom_out,
      B, L, S, T, V, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// w, values and coef may be null (no segment weights / gaussian tracks).
int tehmm_em_fwd(const void* sym, const void* lens, const void* start_p,
                 const void* trans_p, const void* em, void* alpha, void* dm,
                 void* mraw, int64_t B, int64_t L, int S, int T, int V,
                 const void* w, const void* values, const void* coef, int G,
                 void* stream) {
  cudaStream_t cs = (cudaStream_t)stream;
  const ObsStreams st = make_streams(w, values, coef, G);
  switch (states_per_lane(S)) {
    case 1:
      return launch_fwd<1>(sym, lens, start_p, trans_p, em, alpha, dm, mraw,
                           B, L, S, T, V, st, cs);
    case 2:
      return launch_fwd<2>(sym, lens, start_p, trans_p, em, alpha, dm, mraw,
                           B, L, S, T, V, st, cs);
    case 4:
      return launch_fwd<4>(sym, lens, start_p, trans_p, em, alpha, dm, mraw,
                           B, L, S, T, V, st, cs);
    case 8:
      return launch_fwd<8>(sym, lens, start_p, trans_p, em, alpha, dm, mraw,
                           B, L, S, T, V, st, cs);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// w, values, coef and gmom_out may be null (no segment weights /
// gaussian tracks).
int tehmm_em_bwd_stats(const void* sym, const void* lens,
                       const void* trans_p, const void* em,
                       const void* alpha, const void* mraw, void* pair_out,
                       void* em_out, void* start_out, void* gmom_out,
                       int64_t B, int64_t L, int S, int T, int V, int warps,
                       const void* w, const void* values, const void* coef,
                       int G, void* stream) {
  cudaStream_t cs = (cudaStream_t)stream;
  const ObsStreams st = make_streams(w, values, coef, G);
  if (warps != 1 && warps != 2 && warps != kWarpsPerBlock)
    return (int)cudaErrorInvalidValue;
  switch (states_per_lane(S)) {
    case 1:
      return launch_bwd<1>(sym, lens, trans_p, em, alpha, mraw, pair_out,
                           em_out, start_out, gmom_out, B, L, S, T, V, warps,
                           st, cs);
    case 2:
      return launch_bwd<2>(sym, lens, trans_p, em, alpha, mraw, pair_out,
                           em_out, start_out, gmom_out, B, L, S, T, V, warps,
                           st, cs);
    case 4:
      return launch_bwd<4>(sym, lens, trans_p, em, alpha, mraw, pair_out,
                           em_out, start_out, gmom_out, B, L, S, T, V, warps,
                           st, cs);
    case 8:
      return launch_bwd<8>(sym, lens, trans_p, em, alpha, mraw, pair_out,
                           em_out, start_out, gmom_out, B, L, S, T, V, warps,
                           st, cs);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
