// Helpers shared by the port's kernels (viterbi.cu, em_estep.cu,
// posterior.cu): one warp per batch row with lane <-> state, up to 8
// states per lane, tables staged into shared memory by the whole block,
// and the one in-register observation routine (obs_log) with its optional
// segment-weight and gaussian streams.  Everything is in an anonymous
// namespace: each source gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLogZero = -1e30f;  // tehmm_tpu_torch.utils.common.LOG_ZERO
constexpr int kWarpsPerBlock = 4;   // one warp per batch row
constexpr int kSmemLimit = 232448;  // bytes a block may opt in to (sm_90)

// states per lane for one warp: S <= 32 * SPL (0: S is too large)
inline int states_per_lane(int S) {
  if (S <= 32) return 1;
  if (S <= 64) return 2;
  if (S <= 128) return 4;
  if (S <= 256) return 8;
  return 0;
}

__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int64_t n) {
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// dst[j * S + i] = src[i * S + j]
__device__ __forceinline__ void stage_transposed(float* dst, const float* src,
                                                 int S) {
  const int64_t SS = (int64_t)S * S;
  for (int64_t n = threadIdx.x; n < SS; n += blockDim.x)
    dst[(n % S) * S + n / S] = src[n];
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// The optional observation streams of the fused kernels (K1, K2's
// forward, K4): segment weights and gaussian-track values, read straight
// from global memory, and the gaussian coefficients [c0 | c1 | c2]
// (models/gauss.coeff_table: f32[S, 3G]) staged into shared memory.
struct ObsStreams {
  const float* w;       // [B, L] segment weights, or nullptr
  const float* values;  // [B, L, G] gaussian values (NaN missing), or nullptr
  const float* coef;    // [S, 3G] in global memory (staged by the kernel)
  float* s_coef;        // its shared-memory copy
  int G;                // gaussian tracks (0 without values)
};

// Stage the coefficient table (call with the whole block, before the
// block's __syncthreads).
__device__ __forceinline__ void stage_coef(const ObsStreams& st, int S) {
  if (st.values != nullptr)
    for (int64_t i = threadIdx.x; i < (int64_t)S * 3 * st.G; i += blockDim.x)
      st.s_coef[i] = st.coef[i];
}

// mask, x and x^2 of one gaussian value (NaN or inf = missing), exactly
// as models/gauss.features computes them
__device__ __forceinline__ void gauss_feats(float v, float& m, float& xm,
                                            float& x2m) {
  const bool fin = isfinite(v);
  m = fin ? 1.0f : 0.0f;
  const float x = fin ? v : 0.0f;
  xm = __fmul_rn(x, m);
  x2m = __fmul_rn(__fmul_rn(x, x), m);
}

// obs_log of state j at flat position pos (symbols x):
//   1. the categorical sum in track order t = 0..T-1
//      (models/emission.track_log_likelihoods);
//   2. plus the gaussian term (sum_g m c0) + (sum_g xm c1) + (sum_g x2m c2),
//      each block summed in track order g = 0..G-1 (models/gauss);
//   3. times the segment weight.
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn: nvcc
// contracts nothing into an FMA), so the result is bit-equal to the plain
// torch versions (models/emission.obs_log_likelihoods).
__device__ __forceinline__ float obs_log(const float* s_em, const int32_t* x,
                                         int T, int V, int j, int64_t pos,
                                         const ObsStreams& st) {
  const float* row = s_em + (int64_t)j * T * V;
  float o = row[x[0]];
  for (int tt = 1; tt < T; ++tt) o += row[tt * V + x[tt]];
  if (st.values != nullptr) {
    const int G = st.G;
    const float* v = st.values + pos * G;
    const float* c = st.s_coef + (int64_t)j * 3 * G;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
    for (int g = 0; g < G; ++g) {
      float m, xm, x2m;
      gauss_feats(v[g], m, xm, x2m);
      const float t0 = __fmul_rn(m, c[g]);
      const float t1 = __fmul_rn(xm, c[G + g]);
      const float t2 = __fmul_rn(x2m, c[2 * G + g]);
      if (g == 0) {
        s0 = t0;
        s1 = t1;
        s2 = t2;
      } else {
        s0 = __fadd_rn(s0, t0);
        s1 = __fadd_rn(s1, t1);
        s2 = __fadd_rn(s2, t2);
      }
    }
    o = __fadd_rn(o, __fadd_rn(__fadd_rn(s0, s1), s2));
  }
  if (st.w != nullptr) o = __fmul_rn(o, st.w[pos]);
  return o;
}

// obs_p[k] = exp(obs_log[j] - max_s obs_log[s]) for this lane's states
// j = lane + 32k at flat position pos (symbols x).  Returns the max.
template <int SPL>
__device__ __forceinline__ float obs_probs(const float* s_em,
                                           const int32_t* x, int S, int T,
                                           int V, int lane, int64_t pos,
                                           const ObsStreams& st,
                                           float (&obs_p)[SPL]) {
  float lmax = -INFINITY;
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int j = lane + 32 * k;
    if (j < S) {
      const float o = obs_log(s_em, x, T, V, j, pos, st);
      obs_p[k] = o;
      lmax = fmaxf(lmax, o);
    }
  }
  const float o_m = warp_max(lmax);
#pragma unroll
  for (int k = 0; k < SPL; ++k)
    if (lane + 32 * k < S) obs_p[k] = expf(obs_p[k] - o_m);
  return o_m;
}

// The streams as the C entry points receive them (null pointers: absent).
inline ObsStreams make_streams(const void* w, const void* values,
                               const void* coef, int G) {
  ObsStreams st;
  st.w = (const float*)w;
  st.values = (const float*)values;
  st.coef = (const float*)coef;
  st.s_coef = nullptr;
  st.G = values != nullptr ? G : 0;
  return st;
}

// Floats of shared memory the coefficient table takes (0 without values).
__host__ __device__ __forceinline__ size_t coef_floats(int S,
                                                      const void* values,
                                                      int G) {
  return values != nullptr ? (size_t)S * 3 * G : 0;
}

// Opt a kernel in to ``smem`` bytes of dynamic shared memory (above 48 KB
// a kernel must ask).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
