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
//   viterbi_sweep_lanes_kernel  K3, _make_viterbi_kernel_v3(carry_mode=
//   viterbi_sweep_smem_kernel   True) (:1284) under
//                               viterbi_chunk_values_pallas (:1492): the
//                               exact decoder's recompute (value rows)
//                               and, in the checkpoint mode, its forward
//                               sweep (the carry leaving every chunk)
//
// What bounds them on an H100: the max-plus recurrence is a sequential
// scan over positions with an S x S max-reduction per step, so each row
// is a chain of dependent steps whose latency sets the time; at S = 10
// the arithmetic is ~2*S*S = 200 flops per position and the HBM traffic
// is obs in and the value rows out (S floats each per position).  K2
// keeps every table (trans, log_em, log_start) in shared memory, one warp
// per batch row with lane <-> state, so rows run in parallel across warps
// and SMs and no step touches HBM for a table.  K3 runs on one row of a
// whole chromosome in its checkpoint mode (one warp for ~1M steps), so
// its step is cut to its latency: to 32 states no shared memory, no
// barrier and no warp reduction on the chain, and obs read ahead of
// it; its recompute gives every (chunk, table) a warp, each from its
// stored carry.
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

// K3, every mode: value rows (v_out), or the carry leaving every chunk of
// `chunk` positions (ckpt [B, n_ck, S]; the carry mode is one chunk of L),
// from each row's incoming carry over precomputed obs; every position
// applies a transition.  Past a row's length the carry holds: the value
// rows repeat it and the checkpoints take it.
//
// The step is a chain: each position needs the whole previous row.  Two
// variants of it, chosen by S (ops/cuda_kernels.k3_step):
//
//   lanes (S <= 32)  lane j keeps column j of trans in registers, and
//       every lane the whole row; lane j's new value goes to every lane
//       by S shuffles, and each lane forms the normaliser and the
//       renormalised row from them, so a step has no shared memory, no
//       __syncwarp and no warp reduction;
//   shared (33..239) the row and trans in shared memory (maxplus_best,
//       renorm_store), as K2's forward.
//
// Both read obs ahead of the chain (common.cuh: the lanes step a cp.async
// ring, stage_column; the shared step registers, load_obs), so no global
// load sits between two dependent steps, and both stop at the row's
// length.  X1's sweeps (posterior.cu) share these helpers.  Neither unrolls a tile of steps: a single warp walking a long row
// streams its code from the instruction caches, so the step's code stays
// small.

// One step of the lanes variant: lane j's new value from the row and its
// trans column, then the new row from every lane, renormalised in each.
// Returns lane j's renormalised value.  Entries past S are -inf in the
// row and in trans (and the lanes past S produce -inf), so they stay
// -inf and never change a max.  The adds and subtractions round once
// each and the max is exact, so the bits are dp._maxplus_step's.
template <int NS>
__device__ __forceinline__ float lanes_step(float (&row)[NS],
                                            const float (&tc)[NS],
                                            float o) {
  float a[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) a[i] = row[i] + tc[i];
  const float nv = row_max<NS>(a) + o;
#pragma unroll
  for (int i = 0; i < NS; ++i) a[i] = __shfl_sync(0xffffffffu, nv, i);
  const float m = fmaxf(row_max<NS>(a), kLogZero);
#pragma unroll
  for (int i = 0; i < NS; ++i) row[i] = a[i] - m;
  return nv - m;
}

template <int NS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    viterbi_sweep_lanes_kernel(const float* __restrict__ obs,
                               const float* __restrict__ carry,
                               const int32_t* __restrict__ lens,
                               const float* __restrict__ trans,
                               float* __restrict__ v_out,
                               float* __restrict__ ckpt, int64_t B,
                               int64_t L, int S, int64_t chunk,
                               int64_t n_ck) {
  extern __shared__ float smem[];  // a ring of 2 kHalf x 32 floats a warp
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
    tc[i] = (mine && i < S) ? trans[(int64_t)i * S + lane] : -INFINITY;
  float own = mine ? carry[b * S + lane] : -INFINITY;
  float row[NS];  // the row, row[i] for i < S, -inf beyond
#pragma unroll
  for (int i = 0; i < NS; ++i) row[i] = __shfl_sync(0xffffffffu, own, i);

  const int64_t n = max((int64_t)0, min((int64_t)lens[b], L));
  const float* ob = obs + b * L * S + lane;
  // the values' and checkpoints' next stores, walked by pointer
  float* vb = v_out != nullptr ? v_out + b * L * S + lane : nullptr;
  float* cb = ckpt != nullptr ? ckpt + b * n_ck * S + lane : nullptr;
  float* const cb_end = cb != nullptr ? cb + n_ck * S : nullptr;
  int64_t to_ck = chunk;  // steps to the next checkpoint
  stage_column(ring, ob, 0, n, S, mine);
  stage_column(ring, ob, kHalf, n, S, mine);
  for (int64_t t0 = 0; t0 < n; t0 += kHalf) {
    cp_async_wait<1>();  // this half is in; the next may be in flight
    const float* src = ring + ((t0 / kHalf) & 1) * kHalf * 32;
    const int steps = (int)min((int64_t)kHalf, n - t0);
#pragma unroll 2
    for (int k = 0; k < steps; ++k) {
      own = lanes_step<NS>(row, tc, src[k * 32]);
      if (vb != nullptr) {
        if (mine) *vb = own;
        vb += S;
      }
      if (cb != nullptr && --to_ck == 0) {
        if (mine) *cb = own;
        cb += S;
        to_ck = chunk;
      }
    }
    stage_column(ring, ob, t0 + 2 * kHalf, n, S, mine);
  }
  cp_async_wait<0>();
  if (!mine) return;
  if (vb != nullptr)
    for (int64_t t = n; t < L; ++t, vb += S) *vb = own;
  if (cb != nullptr)
    for (; cb < cb_end; cb += S) *cb = own;
}

template <int SPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    viterbi_sweep_smem_kernel(const float* __restrict__ obs,
                              const float* __restrict__ carry,
                              const int32_t* __restrict__ lens,
                              const float* __restrict__ trans,
                              float* __restrict__ v_out,
                              float* __restrict__ ckpt, int64_t B,
                              int64_t L, int S, int64_t chunk,
                              int64_t n_ck) {
  extern __shared__ float smem[];
  float* s_trans = smem;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* s_v = s_trans + (int64_t)S * S + (int64_t)warp * S;
  stage(s_trans, trans, (int64_t)S * S);
  __syncthreads();

  const int64_t b = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;
  const int64_t n = max((int64_t)0, min((int64_t)lens[b], L));
  for (int j = lane; j < S; j += 32) s_v[j] = carry[b * S + j];
  __syncwarp();

  const float* ob = obs + b * L * S;
  int64_t next_ck = chunk, ck_i = 0;
  float ahead[kAhead][SPL];  // slot d: the obs of position t0 + d
#pragma unroll
  for (int d = 0; d < kAhead; ++d) load_obs<SPL>(ahead[d], ob, d, n, S, lane);
  for (int64_t t0 = 0; t0 < n; t0 += kAhead) {
#pragma unroll
    for (int d = 0; d < kAhead; ++d) {
      const int64_t t = t0 + d;
      if (t < n) {
        float nv[SPL];
        maxplus_best<SPL>(s_v, s_trans, S, lane, nv);
#pragma unroll
        for (int q = 0; q < SPL; ++q)
          if (lane + 32 * q < S) nv[q] = nv[q] + ahead[d][q];
        load_obs<SPL>(ahead[d], ob, t + kAhead, n, S, lane);
        renorm_store<SPL>(nv, s_v, S, lane, true,
                          v_out != nullptr ? v_out + (b * L + t) * S
                                           : nullptr,
                          nullptr);
        if (ckpt != nullptr && t + 1 == next_ck) {
          for (int j = lane; j < S; j += 32)
            ckpt[(b * n_ck + ck_i) * S + j] = s_v[j];
          ++ck_i;
          next_ck += chunk;
        }
      }
    }
  }
  if (v_out != nullptr)
    for (int64_t t = n; t < L; ++t)
      for (int j = lane; j < S; j += 32) v_out[(b * L + t) * S + j] = s_v[j];
  if (ckpt != nullptr)
    for (; ck_i < n_ck; ++ck_i)
      for (int j = lane; j < S; j += 32)
        ckpt[(b * n_ck + ck_i) * S + j] = s_v[j];
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

struct SweepArgs {
  const float* obs;
  const float* carry;
  const int32_t* lens;
  const float* trans;
  float* v_out;
  float* ckpt;
  int64_t B, L;
  int S;
  int64_t chunk, n_ck;
};

template <int NS>
int launch_sweep_lanes(const SweepArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarpsPerBlock * 2 * kHalf * 32;
  const int64_t grid = (a.B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  viterbi_sweep_lanes_kernel<NS><<<(unsigned)grid, kWarpsPerBlock * 32,
                                   smem, stream>>>(a.obs, a.carry, a.lens,
                                             a.trans, a.v_out, a.ckpt, a.B,
                                             a.L, a.S, a.chunk, a.n_ck);
  return (int)cudaGetLastError();
}

template <int SPL>
int launch_sweep_smem(const SweepArgs& a, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)a.S * a.S + (size_t)kWarpsPerBlock * a.S);
  cudaError_t err = allow_smem(viterbi_sweep_smem_kernel<SPL>, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t grid = (a.B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  viterbi_sweep_smem_kernel<SPL><<<(unsigned)grid, kWarpsPerBlock * 32,
                                   smem, stream>>>(
      a.obs, a.carry, a.lens, a.trans, a.v_out, a.ckpt, a.B, a.L, a.S,
      a.chunk, a.n_ck);
  return (int)cudaGetLastError();
}

SweepArgs sweep_args(const void* obs, const void* carry, const void* lens,
                     const void* trans, void* v_out, void* ckpt, int64_t B,
                     int64_t L, int S, int64_t chunk, int64_t n_ck) {
  return SweepArgs{(const float*)obs, (const float*)carry,
                   (const int32_t*)lens, (const float*)trans,
                   (float*)v_out, (float*)ckpt, B, L, S, chunk, n_ck};
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

// K3's sweep, either step variant (ops/cuda_kernels.k3_step picks by S).
// v_out: value rows [B, L, S], or ckpt: the carry leaving every chunk of
// `chunk` positions [B, n_ck, S] (the other null).
int tehmm_viterbi_sweep_lanes(const void* obs, const void* carry,
                              const void* lens, const void* trans,
                              void* v_out, void* ckpt, int64_t B, int64_t L,
                              int S, int64_t chunk, int64_t n_ck,
                              void* stream) {
  const SweepArgs a = sweep_args(obs, carry, lens, trans, v_out, ckpt, B, L,
                                 S, chunk, n_ck);
  cudaStream_t st = (cudaStream_t)stream;
  // the row's registers: S rounded up to a multiple of 4
  switch ((S + 3) / 4) {
    case 1:
      return launch_sweep_lanes<4>(a, st);
    case 2:
      return launch_sweep_lanes<8>(a, st);
    case 3:
      return launch_sweep_lanes<12>(a, st);
    case 4:
      return launch_sweep_lanes<16>(a, st);
    case 5:
      return launch_sweep_lanes<20>(a, st);
    case 6:
      return launch_sweep_lanes<24>(a, st);
    case 7:
      return launch_sweep_lanes<28>(a, st);
    case 8:
      return launch_sweep_lanes<32>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int tehmm_viterbi_sweep_smem(const void* obs, const void* carry,
                             const void* lens, const void* trans,
                             void* v_out, void* ckpt, int64_t B, int64_t L,
                             int S, int64_t chunk, int64_t n_ck,
                             void* stream) {
  const SweepArgs a = sweep_args(obs, carry, lens, trans, v_out, ckpt, B, L,
                                 S, chunk, n_ck);
  cudaStream_t st = (cudaStream_t)stream;
  switch (states_per_lane(S)) {  // the lanes step takes S <= 32
    case 2:
      return launch_sweep_smem<2>(a, st);
    case 4:
      return launch_sweep_smem<4>(a, st);
    case 8:
      return launch_sweep_smem<8>(a, st);
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
