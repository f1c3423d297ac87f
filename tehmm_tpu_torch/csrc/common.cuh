// Helpers shared by the port's kernels (viterbi.cu, em_estep.cu,
// posterior.cu): one warp per batch row with lane <-> state, up to 8
// states per lane, tables staged into shared memory by the whole block.
// Everything is in an anonymous namespace: each source gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLogZero = -1e30f;  // tehmm_tpu.utils.common.LOG_ZERO
constexpr int kWarpsPerBlock = 4;   // one warp per batch row

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

// obs_p[k] = exp(obs_log[j] - max_s obs_log[s]) for this lane's states
// j = lane + 32k, obs_log summed in track order t = 0..T-1 (as
// models/emission.track_log_likelihoods does).  Returns the max.
template <int SPL>
__device__ __forceinline__ float obs_probs(const float* s_em,
                                           const int32_t* x, int S, int T,
                                           int V, int lane,
                                           float (&obs_p)[SPL]) {
  const int64_t TV = (int64_t)T * V;
  float lmax = -INFINITY;
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int j = lane + 32 * k;
    if (j < S) {
      const float* row = s_em + j * TV;
      float o = row[x[0]];
      for (int tt = 1; tt < T; ++tt) o += row[tt * V + x[tt]];
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

// Opt a kernel in to ``smem`` bytes of dynamic shared memory (above 48 KB
// a kernel must ask).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
