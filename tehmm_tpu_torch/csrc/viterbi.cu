// Hand-written Hopper (sm_90a) kernels for the Viterbi decode path.
//
// Built with em_estep.cu and posterior.cu into one shared library with a
// plain C interface (tehmm_tpu_torch/ops/cuda_kernels.py: one
// nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c per source,
// then one link), loaded with ctypes; common.cuh holds the helpers the
// three share.  Every entry point launches on the stream it is given,
// allocates nothing (the Python wrapper allocates outputs with
// torch.empty) and returns the cudaGetLastError() that follows its launch.
//
// Kernels and the TPU kernels they replace
// (tehmm_tpu/ops/pallas_kernels.py):
//
//   viterbi_fwd_kernel          K2 forward, _make_viterbi_fwd_kernel_v4
//                               (:2386) under viterbi_fused_pallas_v4
//                               (:2600)
//   viterbi_backtrace_kernel    K2 backtrace, _viterbi_backtrace_kernel_v4
//                               (:2517); also the exact decoder's
//                               per-chunk backtrace
//   viterbi_chunk_values_kernel K3, _make_viterbi_kernel_v3(carry_mode=
//                               True) (:1284) under
//                               viterbi_chunk_values_pallas (:1492); with
//                               carry_only it is also the exact decoder's
//                               forward carry sweep
//
// What bounds them on an H100: the max-plus recurrence is a sequential
// scan over positions with an S x S max-reduction per step, so each row
// is a chain of dependent steps whose latency (shared-memory reads and a
// warp shuffle reduction per step) sets the time; at S = 10 the
// arithmetic is ~2*S*S = 200 flops per position and the HBM traffic is
// the value rows written out (S floats per position).  The design keeps
// every table (trans, and for K2 log_em and log_start) in shared memory,
// one warp per batch row with lane <-> state, so rows run in parallel
// across warps and SMs and no step touches HBM for a table.  It is the
// simple right design; many rows per warp, cp.async/TMA staging of
// symbols and uint8 symbols are later work.
//
// Numerics: every operation on the value path is a float32 add,
// subtract, max or (with the optional streams) a product rounded on its
// own, and the in-kernel obs is common.cuh's obs_log: the T track terms
// summed in track order t = 0..T-1, as models/emission.
// track_log_likelihoods does, plus the gaussian tracks' term in the order
// of models/gauss, times the segment weight.  So the kernels agree bit
// for bit with the plain torch versions in ops/dp.py and
// ops/cuda_kernels.py.  Argmax is first-hit (strict '>'
// scanning states upward): ties go to the lowest state index.
//
// All index arithmetic is 64-bit.

#include "common.cuh"

namespace {

constexpr int kBacktraceThreads = 32;

// best[k] = max_i(v[i] + trans[i, j]) for this lane's states j
template <int SPL>
__device__ __forceinline__ void maxplus_best(const float* s_v,
                                             const float* s_trans, int S,
                                             int lane, float (&best)[SPL]) {
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int j = lane + 32 * k;
    if (j < S) {
      float b = s_v[0] + s_trans[j];
      for (int i = 1; i < S; ++i)
        b = fmaxf(b, s_v[i] + s_trans[(int64_t)i * S + j]);
      best[k] = b;
    }
  }
}

// v_hat = new - max(max_j new, LOG_ZERO) where the position is valid,
// else the carried row; stores the row (and the normalizer) if asked.
template <int SPL>
__device__ __forceinline__ void renorm_store(const float (&nv)[SPL],
                                             float* s_v, int S, int lane,
                                             bool valid, float* out_row,
                                             float* dm_out) {
  float lmax = -INFINITY;
#pragma unroll
  for (int k = 0; k < SPL; ++k)
    if (lane + 32 * k < S) lmax = fmaxf(lmax, nv[k]);
  const float m = fmaxf(warp_max(lmax), kLogZero);
  __syncwarp();  // every lane has read s_v for this step
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int j = lane + 32 * k;
    if (j < S) {
      const float h = valid ? nv[k] - m : s_v[j];
      s_v[j] = h;
      if (out_row != nullptr) out_row[j] = h;
    }
  }
  if (dm_out != nullptr && lane == 0) *dm_out = valid ? m : 0.0f;
  __syncwarp();
}

// K2 forward: symbols in, max-normalized value rows + normalizers out.
// obs_j (common.cuh obs_log: sum_t log_em[j, t, x_t], plus the gaussian
// term, times the segment weight) is formed per step in registers and
// never written to memory.
template <int SPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    viterbi_fwd_kernel(const int32_t* __restrict__ sym,
                       const int32_t* __restrict__ lens,
                       const float* __restrict__ start,
                       const float* __restrict__ trans,
                       const float* __restrict__ em,
                       float* __restrict__ v_out,
                       float* __restrict__ dm_out, int64_t B, int64_t L,
                       int S, int T, int V, ObsStreams st) {
  extern __shared__ float smem[];
  const int64_t TV = (int64_t)T * V;
  float* s_trans = smem;
  float* s_em = s_trans + (int64_t)S * S;
  float* s_start = s_em + S * TV;
  st.s_coef = s_start + S;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* s_v = st.s_coef + coef_floats(S, st.values, st.G) +
               (int64_t)warp * S;
  stage(s_trans, trans, (int64_t)S * S);
  stage(s_em, em, S * TV);
  stage(s_start, start, S);
  stage_coef(st, S);
  __syncthreads();

  const int64_t b = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;
  const int64_t len = lens[b];
  // zero-length rows carry this zero row to every output position
  for (int j = lane; j < S; j += 32) s_v[j] = 0.0f;
  __syncwarp();

  for (int64_t t = 0; t < L; ++t) {
    const int64_t pos = b * L + t;
    const int32_t* x = sym + pos * T;
    float nv[SPL];
    if (t == 0) {
#pragma unroll
      for (int k = 0; k < SPL; ++k)
        if (lane + 32 * k < S) nv[k] = s_start[lane + 32 * k];
    } else {
      maxplus_best<SPL>(s_v, s_trans, S, lane, nv);
    }
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const int j = lane + 32 * k;
      if (j < S) nv[k] = nv[k] + obs_log(s_em, x, T, V, j, pos, st);
    }
    renorm_store<SPL>(nv, s_v, S, lane, t < len, v_out + pos * S,
                      dm_out + pos);
  }
}

// K3: value rows of one chunk from its incoming carry over precomputed
// obs; every position applies a transition.  carry_out != nullptr
// writes only the final carry (v_out is then nullptr).
template <int SPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    viterbi_chunk_values_kernel(const float* __restrict__ obs,
                                const float* __restrict__ carry,
                                const int32_t* __restrict__ lens,
                                const float* __restrict__ trans,
                                float* __restrict__ v_out,
                                float* __restrict__ carry_out, int64_t B,
                                int64_t L, int S) {
  extern __shared__ float smem[];
  float* s_trans = smem;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* s_v = s_trans + (int64_t)S * S + (int64_t)warp * S;
  stage(s_trans, trans, (int64_t)S * S);
  __syncthreads();

  const int64_t b = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;
  const int64_t len = lens[b];
  for (int j = lane; j < S; j += 32) s_v[j] = carry[b * S + j];
  __syncwarp();

  for (int64_t t = 0; t < L; ++t) {
    const int64_t pos = b * L + t;
    float nv[SPL];
    maxplus_best<SPL>(s_v, s_trans, S, lane, nv);
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const int j = lane + 32 * k;
      if (j < S) nv[k] = nv[k] + obs[pos * S + j];
    }
    renorm_store<SPL>(nv, s_v, S, lane, t < len,
                      v_out != nullptr ? v_out + pos * S : nullptr,
                      nullptr);
  }
  if (carry_out != nullptr)
    for (int j = lane; j < S; j += 32) carry_out[b * S + j] = s_v[j];
}

// Backtrace from value rows: one thread per batch row walks back from
// its end state; prev = argmax_i(v[t-1, i] + trans[i, state]), first
// hit, held at state for t >= length.  Row t-1 of position 0 is the
// entry row.  Writes path[b, t] and the state at position -1.  The first
// n_s rows of trans are in shared memory (all of them up to S = 241); the
// rest are read through the read-only path from global memory.
__global__ void __launch_bounds__(kBacktraceThreads)
    viterbi_backtrace_kernel(const float* __restrict__ trans,
                             const float* __restrict__ rows,
                             int64_t row_stride,
                             const float* __restrict__ entry,
                             int64_t entry_stride,
                             const int32_t* __restrict__ end_state,
                             const int32_t* __restrict__ lens,
                             int32_t* __restrict__ path,
                             int32_t* __restrict__ entry_state, int64_t B,
                             int64_t L, int S, int n_s) {
  extern __shared__ float s_trans[];
  stage(s_trans, trans, (int64_t)n_s * S);
  __syncthreads();

  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int64_t len = lens[b];
  const float* rb = rows + b * row_stride;
  int state = end_state[b];
  for (int64_t t = L - 1; t >= 0; --t) {
    path[b * L + t] = state;
    if (t < len) {
      const float* vp = t > 0 ? rb + (t - 1) * S : entry + b * entry_stride;
      float best = vp[0] + s_trans[state];
      int arg = 0;
      for (int i = 1; i < n_s; ++i) {
        const float c = vp[i] + s_trans[(int64_t)i * S + state];
        if (c > best) {
          best = c;
          arg = i;
        }
      }
      for (int i = n_s; i < S; ++i) {
        const float c = vp[i] + __ldg(trans + (int64_t)i * S + state);
        if (c > best) {
          best = c;
          arg = i;
        }
      }
      state = arg;
    }
  }
  entry_state[b] = state;
}

template <int SPL>
int launch_fwd(const void* sym, const void* lens, const void* start,
               const void* trans, const void* em, void* v_out,
               void* dm_out, int64_t B, int64_t L, int S, int T, int V,
               const ObsStreams& st, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)S * S + (size_t)S * T * V + (size_t)S +
                       coef_floats(S, st.values, st.G) +
                       (size_t)kWarpsPerBlock * S);
  cudaError_t err = allow_smem(viterbi_fwd_kernel<SPL>, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t grid = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  viterbi_fwd_kernel<SPL><<<(unsigned)grid, kWarpsPerBlock * 32, smem,
                            stream>>>(
      (const int32_t*)sym, (const int32_t*)lens, (const float*)start,
      (const float*)trans, (const float*)em, (float*)v_out,
      (float*)dm_out, B, L, S, T, V, st);
  return (int)cudaGetLastError();
}

template <int SPL>
int launch_chunk_values(const void* obs, const void* carry,
                        const void* lens, const void* trans, void* v_out,
                        void* carry_out, int64_t B, int64_t L, int S,
                        cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)S * S + (size_t)kWarpsPerBlock * S);
  cudaError_t err = allow_smem(viterbi_chunk_values_kernel<SPL>, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t grid = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  viterbi_chunk_values_kernel<SPL><<<(unsigned)grid, kWarpsPerBlock * 32,
                                     smem, stream>>>(
      (const float*)obs, (const float*)carry, (const int32_t*)lens,
      (const float*)trans, (float*)v_out, (float*)carry_out, B, L, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tehmm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// w, values and coef may be null (no segment weights / gaussian tracks).
int tehmm_viterbi_fwd(const void* sym, const void* lens, const void* start,
                      const void* trans, const void* em, void* v_out,
                      void* dm_out, int64_t B, int64_t L, int S, int T,
                      int V, const void* w, const void* values,
                      const void* coef, int G, void* stream) {
  cudaStream_t cs = (cudaStream_t)stream;
  const ObsStreams st = make_streams(w, values, coef, G);
  switch (states_per_lane(S)) {
    case 1:
      return launch_fwd<1>(sym, lens, start, trans, em, v_out, dm_out, B,
                           L, S, T, V, st, cs);
    case 2:
      return launch_fwd<2>(sym, lens, start, trans, em, v_out, dm_out, B,
                           L, S, T, V, st, cs);
    case 4:
      return launch_fwd<4>(sym, lens, start, trans, em, v_out, dm_out, B,
                           L, S, T, V, st, cs);
    case 8:
      return launch_fwd<8>(sym, lens, start, trans, em, v_out, dm_out, B,
                           L, S, T, V, st, cs);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int tehmm_viterbi_chunk_values(const void* obs, const void* carry,
                               const void* lens, const void* trans,
                               void* v_out, void* carry_out, int64_t B,
                               int64_t L, int S, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (states_per_lane(S)) {
    case 1:
      return launch_chunk_values<1>(obs, carry, lens, trans, v_out,
                                    carry_out, B, L, S, st);
    case 2:
      return launch_chunk_values<2>(obs, carry, lens, trans, v_out,
                                    carry_out, B, L, S, st);
    case 4:
      return launch_chunk_values<4>(obs, carry, lens, trans, v_out,
                                    carry_out, B, L, S, st);
    case 8:
      return launch_chunk_values<8>(obs, carry, lens, trans, v_out,
                                    carry_out, B, L, S, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int tehmm_viterbi_backtrace(const void* trans, const void* rows,
                            int64_t row_stride, const void* entry,
                            int64_t entry_stride, const void* end_state,
                            const void* lens, void* path, void* entry_state,
                            int64_t B, int64_t L, int S, void* stream) {
  if (S < 1) return (int)cudaErrorInvalidValue;
  const int fit = kSmemLimit / (int)(sizeof(float) * S);
  const int n_s = fit < S ? fit : S;  // at least 1: row 0 is read from it
  const size_t smem = sizeof(float) * (size_t)n_s * S;
  cudaError_t err = allow_smem(viterbi_backtrace_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t grid = (B + kBacktraceThreads - 1) / kBacktraceThreads;
  viterbi_backtrace_kernel<<<(unsigned)grid, kBacktraceThreads, smem,
                             (cudaStream_t)stream>>>(
      (const float*)trans, (const float*)rows, row_stride,
      (const float*)entry, entry_stride, (const int32_t*)end_state,
      (const int32_t*)lens, (int32_t*)path, (int32_t*)entry_state, B, L,
      S, n_s);
  return (int)cudaGetLastError();
}

}  // extern "C"
