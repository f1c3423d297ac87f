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
//   viterbi_fwd_lanes_kernel    K2 forward, _make_viterbi_fwd_kernel_v4
//   viterbi_fwd_kernel          (:2386) under viterbi_fused_pallas_v4
//                               (:2600): value rows, or in the pointer
//                               mode first-hit pointers, which
//                               chunk_chase_kernel walks (K2's backtrace,
//                               _viterbi_backtrace_kernel_v4 :2517)
//   viterbi_backtrace_kernel    the XLA backtrace of viterbi_pallas_v3
//                               (:1475) over K5's value rows
//                               (dp.viterbi_streaming), and past 239
//                               states the exact decoder's a chunk
//                               (dp.viterbi_backtrace_chunk): a warp a
//                               row, a warp-wide first-hit argmax a step
//   viterbi_sweep_lanes_kernel  K3, _make_viterbi_kernel_v3(carry_mode=
//   viterbi_sweep_smem_kernel   True) (:1284) under
//                               viterbi_chunk_values_pallas (:1492): value
//                               rows; in the checkpoint mode the exact
//                               decoder's forward sweep (the carry
//                               leaving every chunk), in the pointer
//                               mode its recompute (first-hit pointers)
//   chunk_entry_map_kernel      no Pallas kernel: the exact decoder's
//   chunk_compose_kernel        backtrace (tehmm_tpu/ops/dp.py
//   chunk_chase_kernel          viterbi_backtrace_chunk, an XLA scan a
//                               chunk) from the pointer mode's pointers:
//                               each chunk's map of end states, the maps
//                               composed, every chunk chased
//
// What bounds them on an H100: the max-plus recurrence is a sequential
// scan over positions with an S x S max-reduction per step, so each row
// is a chain of dependent steps whose latency sets the time; at S = 10
// the arithmetic is ~2*S*S = 200 flops per position and the HBM traffic
// is obs in and the value rows out (S floats each per position).  K2
// and K3 give a batch row a warp with lane <-> state, so rows run in
// parallel across warps and SMs, and cut the step to its latency: to 32
// states (the lanes kernels) no shared memory, no barrier and no warp
// reduction on the chain, and obs read ahead of it (K2 forms them from
// symbols staged a half ahead, K3 reads them); beyond, the row and the
// tables in shared memory.  K3 runs on one row of a whole chromosome in
// its checkpoint mode (one warp for ~1M steps); its recompute gives
// every (chunk, table) a warp, each from its stored carry.
//
// The exact decoder's backtrace is chunk-parallel: the chain that cannot
// be split is one end state a chunk (chunk_compose_kernel); every
// position's walk back is a dependent byte load from shared memory,
// each chunk's row on its own block (the map from all S end states at
// once, then the chase from the known one).  K2's backtrace is the
// chase alone, from the argmax of each row's last value row.
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

// best[k] = max_i(v[i] + trans[i, j]) for this lane's states j, and
// where ``arg`` is given arg[k] = the first i that reaches it (a strict
// '>' from i = 0, as the backtrace kernel's); the max's operations are
// the same either way
template <int SPL>
__device__ __forceinline__ void maxplus_best(const float* s_v,
                                             const float* s_trans, int S,
                                             int lane, float (&best)[SPL],
                                             int* arg = nullptr) {
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int j = lane + 32 * k;
    if (j < S) {
      float b = s_v[0] + s_trans[j];
      int at = 0;
      for (int i = 1; i < S; ++i) {
        const float c = s_v[i] + s_trans[(int64_t)i * S + j];
        if (arg != nullptr && c > b) at = i;
        b = fmaxf(b, c);
      }
      best[k] = b;
      if (arg != nullptr) arg[k] = at;
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

// K2 forward, shared variant (S from 33 to K2's envelope; to 32 only
// where forced: viterbi_fwd_lanes_kernel below takes them): symbols in,
// max-normalized value rows + normalizers out, or (kPtr) in place of the
// value rows the pointer mode's first-hit argmax predecessors ptr_out [B,
// L, S] uint8 (maxplus_best's arg: the candidates v_hat[t-1, i] + trans[i,
// j] the backtrace kernel forms from the value rows, the lowest index on
// ties; the identity at position 0 and past the row's length) and the
// last row last_out [B, S].  obs_j (common.cuh obs_log: sum_t log_em[j,
// t, x_t], plus the gaussian term, times the segment weight) is formed
// per step in registers and never written to memory.
template <int SPL, bool kPtr>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    viterbi_fwd_kernel(const int32_t* __restrict__ sym,
                       const int32_t* __restrict__ lens,
                       const float* __restrict__ start,
                       const float* __restrict__ trans,
                       const float* __restrict__ em,
                       float* __restrict__ v_out,
                       uint8_t* __restrict__ ptr_out,
                       float* __restrict__ last_out,
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
    int arg[SPL];
    if (t == 0) {
#pragma unroll
      for (int k = 0; k < SPL; ++k)
        if (lane + 32 * k < S) nv[k] = s_start[lane + 32 * k];
    } else {
      maxplus_best<SPL>(s_v, s_trans, S, lane, nv, kPtr ? arg : nullptr);
    }
    if constexpr (kPtr) {
      const bool step = t > 0 && t < len;
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        const int j = lane + 32 * k;
        if (j < S) ptr_out[pos * S + j] = (uint8_t)(step ? arg[k] : j);
      }
    }
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const int j = lane + 32 * k;
      if (j < S) nv[k] = nv[k] + obs_log(s_em, x, T, V, j, pos, st);
    }
    renorm_store<SPL>(nv, s_v, S, lane, t < len,
                      kPtr ? nullptr : v_out + pos * S, dm_out + pos);
  }
  if constexpr (kPtr)
    for (int j = lane; j < S; j += 32) last_out[b * S + j] = s_v[j];
}

// K3, every mode: value rows (v_out), or the carry leaving every chunk of
// `chunk` positions (ckpt [B, n_ck, S]; the carry mode is one chunk of L),
// or (kPtr, ptr_out [B, L, S] uint8) at every position and for every
// state j the first-hit argmax predecessor argmax_i(v[t-1, i] +
// trans[i, j]), from each row's incoming carry over precomputed obs;
// every position applies a transition.  Past a row's length the carry
// holds: the value rows repeat it, the checkpoints take it and the
// pointers are the identity.  The pointer mode's candidates are the
// float32 sums the backtrace kernel forms from the value rows, and its
// argmax is the backtrace's (first hit, lowest index), so a walk over
// the pointers is the backtrace over the values.
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

template <int NS, bool kPtr>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    viterbi_sweep_lanes_kernel(const float* __restrict__ obs,
                               const float* __restrict__ carry,
                               const int32_t* __restrict__ lens,
                               const float* __restrict__ trans,
                               float* __restrict__ v_out,
                               float* __restrict__ ckpt,
                               uint8_t* __restrict__ ptr_out, int64_t B,
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
  uint8_t* pb = kPtr ? ptr_out + b * L * S + lane : nullptr;
  int64_t to_ck = chunk;  // steps to the next checkpoint
  stage_column(ring, ob, 0, n, S, mine);
  stage_column(ring, ob, kHalf, n, S, mine);
  for (int64_t t0 = 0; t0 < n; t0 += kHalf) {
    cp_async_wait<1>();  // this half is in; the next may be in flight
    const float* src = ring + ((t0 / kHalf) & 1) * kHalf * 32;
    const int steps = (int)min((int64_t)kHalf, n - t0);
#pragma unroll 2
    for (int k = 0; k < steps; ++k) {
      if constexpr (kPtr) {
        int arg;
        own = lanes_step<NS>(row, tc, src[k * 32], &arg);
        if (mine) *pb = (uint8_t)arg;
        pb += S;
      } else {
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
    }
    stage_column(ring, ob, t0 + 2 * kHalf, n, S, mine);
  }
  cp_async_wait<0>();
  if (!mine) return;
  if constexpr (kPtr) {
    for (int64_t t = n; t < L; ++t, pb += S) *pb = (uint8_t)lane;
    return;
  }
  if (vb != nullptr)
    for (int64_t t = n; t < L; ++t, vb += S) *vb = own;
  if (cb != nullptr)
    for (; cb < cb_end; cb += S) *cb = own;
}

template <int SPL, bool kPtr>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    viterbi_sweep_smem_kernel(const float* __restrict__ obs,
                              const float* __restrict__ carry,
                              const int32_t* __restrict__ lens,
                              const float* __restrict__ trans,
                              float* __restrict__ v_out,
                              float* __restrict__ ckpt,
                              uint8_t* __restrict__ ptr_out, int64_t B,
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
        int arg[SPL];
        maxplus_best<SPL>(s_v, s_trans, S, lane, nv,
                          kPtr ? arg : nullptr);
        if constexpr (kPtr) {
#pragma unroll
          for (int q = 0; q < SPL; ++q)
            if (lane + 32 * q < S)
              ptr_out[(b * L + t) * S + lane + 32 * q] = (uint8_t)arg[q];
        }
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
  if (ptr_out != nullptr)
    for (int64_t t = n; t < L; ++t)
      for (int j = lane; j < S; j += 32)
        ptr_out[(b * L + t) * S + j] = (uint8_t)j;
  if (v_out != nullptr)
    for (int64_t t = n; t < L; ++t)
      for (int j = lane; j < S; j += 32) v_out[(b * L + t) * S + j] = s_v[j];
  if (ckpt != nullptr)
    for (; ck_i < n_ck; ++ck_i)
      for (int j = lane; j < S; j += 32)
        ckpt[(b * n_ck + ck_i) * S + j] = s_v[j];
}

// K2 forward, lanes variant (S <= 32, one state a lane), with
// viterbi_fwd_kernel's inputs, outputs and bits in either mode.  Its step
// is K3's (lanes_step): lane j holds column j of trans in registers (tc,
// -inf past S) and the whole row (row, -inf past S), the new row goes
// round by NS shuffles and each lane renormalises it, so the chain has no
// shared memory, no warp reduction and no __syncwarp.  Position 0 is the
// start row plus obs (lanes_renorm), not a max-plus step.  The symbols
// and streams come through the lanes kernels' ring (common.cuh
// stage_slot) a half of kHalf positions ahead, and a half's obs are
// formed before its steps, lane k position k (slot_obs_row: obs_log's
// operations in its order, so its bits), into the warp's col [kHalf][S];
// a half's normalisers go out after its steps, lane k position k.  The
// pointer mode takes each step's first-hit argmax (row_argmax over the
// step's candidates row[i] + tc[i], the backtrace kernel's float32 sums)
// off the chain.  The row stops at its length: past it the value rows
// repeat the last row (a zero row for a zero-length row), dm is 0 and
// the pointers are the identity, written after the chain.
__host__ __device__ __forceinline__ int64_t k2_lanes_warp_floats(int S,
                                                                 int T,
                                                                 int G) {
  return 2 * slot_floats(S, T, G, 0) + (int64_t)kHalf * S;
}

// Shared-memory floats a block of the lanes forward takes: log_em and
// the gaussian coefficients, then a ring and a half's obs a warp.
int64_t k2_lanes_smem_floats(int S, int T, int V, int G) {
  return (int64_t)S * T * V + (int64_t)S * 3 * G +
         kWarpsPerBlock * k2_lanes_warp_floats(S, T, G);
}

template <int NS, bool kPtr>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    viterbi_fwd_lanes_kernel(const int32_t* __restrict__ sym,
                             const int32_t* __restrict__ lens,
                             const float* __restrict__ start,
                             const float* __restrict__ trans,
                             const float* __restrict__ em,
                             float* __restrict__ v_out,
                             uint8_t* __restrict__ ptr_out,
                             float* __restrict__ last_out,
                             float* __restrict__ dm_out, int64_t B,
                             int64_t L, int S, int T, int V,
                             ObsStreams st) {
  extern __shared__ float smem[];
  const int64_t TV = (int64_t)T * V;
  const int G = st.values != nullptr ? st.G : 0;
  const int64_t slot_f = slot_floats(S, T, G, 0);
  float* s_em = smem;                          // log_em [S, T, V]
  st.s_coef = s_em + S * TV;                   // gaussian coefficients
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* ring = st.s_coef + coef_floats(S, st.values, st.G) +
                warp * k2_lanes_warp_floats(S, T, G);
  float* col = ring + 2 * slot_f;              // obs [kHalf][S]
  stage(s_em, em, S * TV);
  stage_coef(st, S);
  __syncthreads();

  const int64_t b = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;
  const bool mine = lane < S;                  // lanes past S carry -inf
  const int me = mine ? lane : S - 1;
  float tc[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i)
    tc[i] = (mine && i < S) ? trans[(int64_t)i * S + lane] : -INFINITY;
  const float sv = mine ? start[lane] : -INFINITY;
  float row[NS];  // zero-length rows carry the zero row
#pragma unroll
  for (int i = 0; i < NS; ++i) row[i] = i < S ? 0.0f : -INFINITY;
  float own = mine ? 0.0f : -INFINITY;

  const int64_t n = max((int64_t)0, min((int64_t)lens[b], L));
  const int64_t rb = b * L;
  // the value rows' or pointers' next store, walked by pointer
  float* vp = kPtr ? nullptr : v_out + rb * S + lane;
  uint8_t* pp = kPtr ? ptr_out + rb * S + lane : nullptr;
  float m_k = 0.0f;                            // the normaliser of step lane
  stage_slot(ring, rb, min(n, (int64_t)kHalf), sym, S, T, st, nullptr,
             nullptr, lane);
  stage_slot(ring + slot_f, rb + kHalf, min(n - kHalf, (int64_t)kHalf),
             sym, S, T, st, nullptr, nullptr, lane);
  for (int64_t t0 = 0; t0 < n; t0 += kHalf) {
    cp_async_wait<1>();  // this half is in; the next may be in flight
    __syncwarp();        // and every lane's words of it
    float* slot = ring + ((t0 / kHalf) & 1) * slot_f;
    const int cnt = (int)min((int64_t)kHalf, n - t0);
    if (lane < cnt) {
      float o[NS];
      slot_obs_row<NS>(slot, s_em, S, T, V, st, lane, o);
#pragma unroll
      for (int j = 0; j < NS; ++j)
        if (j < S) col[lane * S + j] = o[j];
    }
    __syncwarp();        // col is whole, and every lane has read the slot
    stage_slot(slot, rb + t0 + 2 * kHalf,
               min(n - t0 - 2 * kHalf, (int64_t)kHalf), sym, S, T, st,
               nullptr, nullptr, lane);
    int k = 0;
    if (t0 == 0) {       // position 0: the start row plus obs
      float m;
      own = lanes_renorm<NS>(row, sv + (mine ? col[me] : 0.0f), &m);
      m_k = lane == 0 ? m : m_k;
      if constexpr (kPtr) {
        if (mine) *pp = (uint8_t)lane;
        pp += S;
      } else {
        if (mine) *vp = own;
        vp += S;
      }
      k = 1;
    }
#pragma unroll 2
    for (; k < cnt; ++k) {
      float m;
      const float o = mine ? col[k * S + me] : 0.0f;
      if constexpr (kPtr) {
        int arg;
        own = lanes_step<NS>(row, tc, o, &arg, &m);
        if (mine) *pp = (uint8_t)arg;
        pp += S;
      } else {
        own = lanes_step<NS>(row, tc, o, nullptr, &m);
        if (mine) *vp = own;
        vp += S;
      }
      m_k = k == lane ? m : m_k;
    }
    if (lane < cnt) dm_out[rb + t0 + lane] = m_k;
    __syncwarp();        // every lane has read col
  }
  cp_async_wait<0>();
  // past the length: dm 0, and the carried row or the identity
  for (int64_t t = n + lane; t < L; t += 32) dm_out[rb + t] = 0.0f;
  if (!mine) return;
  if constexpr (kPtr) {
    for (int64_t t = n; t < L; ++t, pp += S) *pp = (uint8_t)lane;
    last_out[b * S + lane] = own;
  } else {
    for (int64_t t = n; t < L; ++t, vp += S) *vp = own;
  }
}

// Backtrace from value rows: each batch row walks back from its end
// state, prev = argmax_i(v[t-1, i] + trans[i, state]), first hit, held
// at state for t >= length; row t-1 of position 0 is the entry row.
// Writes path[b, t] and the state at position -1.
//
// Replaces the XLA backtrace of viterbi_pallas_v3
// (tehmm_tpu/ops/pallas_kernels.py:1475, under K5's route past K2's
// envelope) and, a chunk, dp.viterbi_backtrace_chunk (tehmm_tpu/ops/
// dp.py:601, the exact decoder past 239 states).  Bound on an H100: the
// function moves the value rows once (B L S floats) and does S adds and
// compares a position, far under a microsecond at these shapes; what
// sets the time is the chain of L dependent S-wide argmaxes a row, each
// step's row of trans chosen by the step before.  Design: a warp a row,
// so a block's rows and the card's SMs run their chains side by side,
// and a step is one warp-wide argmax.  Each lane forms c_i = v[t-1, i] +
// transT[state, i], the plain version's float add, over its states:
// trans^T, so the step reads one contiguous row, as the JAX scan reads
// trans_T[state] (its rows padded to S4 = S rounded up to 4 floats).
// The lane's first hit is a pairwise tree over its states in increasing
// order; then the warp takes the greatest value by one redux.sync on an
// order-preserving key and the lowest index that holds it by a second:
// exactly the serial first-hit scan's choice (ties and all-LOG_ZERO
// columns to the lowest index), and every lane ends the step holding the
// new state, with no barrier on the chain.  The value rows do not depend
// on the chain: the warp copies the rows ahead into a ring of kBtSlots
// slots of P positions with cp.async, walked from the row's end, so the
// step waits on nothing but trans^T's row.  Where trans^T fits in shared
// memory beside one warp's ring (S <= 236) the block stages it once and
// its rows share it, and lane l owns states l + 32 k (one shared load
// each).  Beyond, the row is read from L2 (4 MB in all at S = 1024), the
// step's one dependent load, and lane l owns the quads 4 l + 128 k + e,
// read by 16-byte loads and copied by 16-byte cp.async where the rows
// are 16-byte aligned: a quarter of the memory instructions, which at
// these widths set the step (on shared memory, below 237 states, single
// states ran faster).
// The path goes out 32 positions at a time, one store a lane.
constexpr int kBtSlots = 4;      // ring slots a warp; three in flight
constexpr int kBtMaxWarps = 16;  // rows a block

// states a chunk: 1 where trans^T is staged, a quad where it is read
// from L2
template <bool kStaged>
__host__ __device__ constexpr int bt_chunk() {
  return kStaged ? 1 : 4;
}

// chunks a lane: S <= 32 CW NC
inline int bt_chunks_per_lane(int S, int cw) {
  int nc = 1;
  while (32 * cw * nc < S) nc *= 2;
  return nc;
}

__host__ __device__ __forceinline__ int padded_states(int S) {
  return (S + 3) & ~3;
}

// A float's key for an unsigned max: greater floats get greater keys,
// +0 and -0 one key (they compare equal)
__device__ __forceinline__ unsigned ordered_key(float x) {
  const unsigned u = __float_as_uint(x == 0.0f ? 0.0f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// argmax_i(vrow[i] + trow[i]), the first hit, for the whole warp; lane l
// owns states CW l + 32 CW k + e; both rows 16-byte aligned where CW is
// 4, trow in shared memory where staged, else global
template <int NC, bool kStaged>
__device__ __forceinline__ int warp_first_argmax(const float* vrow,
                                                 const float* trow, int S,
                                                 int lane) {
  constexpr int CW = bt_chunk<kStaged>(), E = CW * NC;
  float c[E];
  int at[E];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int j = CW * lane + 32 * CW * k;
    if constexpr (CW == 1) {
      c[k] = j < S ? vrow[j] + trow[j] : -INFINITY;
      at[k] = j;
    } else {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f), t = v;
      if (j < S) {
        v = *reinterpret_cast<const float4*>(vrow + j);
        t = __ldg(reinterpret_cast<const float4*>(trow + j));
      }
      c[4 * k] = j < S ? v.x + t.x : -INFINITY;
      c[4 * k + 1] = j + 1 < S ? v.y + t.y : -INFINITY;
      c[4 * k + 2] = j + 2 < S ? v.z + t.z : -INFINITY;
      c[4 * k + 3] = j + 3 < S ? v.w + t.w : -INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) at[4 * k + e] = j + e;
    }
  }
  // pairs of neighbouring runs, the lower states on the left: the right
  // only where strictly greater (a pad, -inf, never beats a state)
#pragma unroll
  for (int w = 1; w < E; w *= 2) {
#pragma unroll
    for (int k = 0; k + w < E; k += 2 * w) {
      if (c[k + w] > c[k]) {
        c[k] = c[k + w];
        at[k] = at[k + w];
      }
    }
  }
  const unsigned key = CW * lane < S ? ordered_key(c[0]) : 0u;
  const unsigned top = __reduce_max_sync(0xffffffffu, key);
  return (int)__reduce_min_sync(0xffffffffu,
                                key == top ? (unsigned)at[0] : 0xffffffffu);
}

// Start the copies of a row's states into a ring row: each lane its own
// states, 16 bytes a copy where a lane owns quads and both S and the row
// allow it
template <int NC, bool kStaged>
__device__ __forceinline__ void copy_value_row(float* dst, const float* src,
                                               int S, int lane) {
  constexpr int CW = bt_chunk<kStaged>();
  if (CW == 4 && (S & 3) == 0 && ((uintptr_t)src & 15) == 0) {
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int j = 4 * lane + 128 * k;
      if (j < S) cp_async16(dst + j, src + j);
    }
  } else {
#pragma unroll
    for (int m = 0; m < CW * NC; ++m) {
      const int j = CW * lane + 32 * CW * (m / CW) + m % CW;
      if (j < S) cp_async4(dst + j, src + j);
    }
  }
}

template <int NC, bool kStaged>
__global__ void __launch_bounds__(kBtMaxWarps * 32)
    viterbi_backtrace_kernel(const float* __restrict__ trans_t,
                             const float* __restrict__ rows,
                             int64_t row_stride,
                             const float* __restrict__ entry,
                             int64_t entry_stride,
                             const int32_t* __restrict__ end_state,
                             const int32_t* __restrict__ lens,
                             int32_t* __restrict__ path,
                             int32_t* __restrict__ entry_state, int64_t B,
                             int64_t L, int S, int P) {
  extern __shared__ __align__(16) float s_bt[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S4 = padded_states(S);
  const int64_t SS = kStaged ? (int64_t)S * S4 : 0;
  if constexpr (kStaged) {
    const float4* src = reinterpret_cast<const float4*>(trans_t);
    float4* dst = reinterpret_cast<float4*>(s_bt);
    for (int64_t i = threadIdx.x; i < SS / 4; i += blockDim.x)
      dst[i] = __ldg(src + i);
    __syncthreads();
  }
  const float* tt = kStaged ? s_bt : trans_t;
  float* ring = s_bt + SS + (int64_t)warp * kBtSlots * P * S4;

  const int64_t b = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  const int64_t n = max((int64_t)0, min((int64_t)lens[b], L));
  const float* rb = rows + b * row_stride;
  const float* eb = entry + b * entry_stride;
  int32_t* out = path + b * L;
  int state = end_state[b];
  // past the walk's last group of 32 positions the end state holds
  const int64_t top = n > 0 ? ((n - 1) & ~(int64_t)31) + 32 : 0;
  for (int64_t t = top + lane; t < L; t += 32) out[t] = state;

  // slot k holds steps [k P, k P + P); step s reads row n - 2 - s (the
  // entry row at -1), at S4 floats a position
  const auto issue = [&](int64_t k) {
    float* slot = ring + (k % kBtSlots) * P * S4;
    for (int q = 0; q < P; ++q) {
      const int64_t s = k * P + q;
      if (s >= n) break;
      const int64_t p = n - 2 - s;
      copy_value_row<NC, kStaged>(slot + q * S4, p >= 0 ? rb + p * S : eb,
                                  S, lane);
    }
    cp_async_commit();
  };
  const int64_t n_slots = (n + P - 1) / P;
  for (int k = 0; k < kBtSlots - 1; ++k) issue(k);
  int mine = state;  // the state at position t for t & 31 == lane
  for (int64_t k = 0; k < n_slots; ++k) {
    __syncwarp();  // slot k - 1's reads come before its refill
    issue(k + kBtSlots - 1);
    cp_async_wait<kBtSlots - 1>();
    __syncwarp();  // and slot k's reads after its copies
    const float* slot = ring + (k % kBtSlots) * P * S4;
    const int q_end = (int)min((int64_t)P, n - k * P);
    for (int q = 0; q < q_end; ++q) {
      const int64_t t = n - 1 - (k * P + q);
      if (lane == (int)(t & 31)) mine = state;
      if ((t & 31) == 0 && t + lane < L) out[t + lane] = mine;
      state = warp_first_argmax<NC, kStaged>(
          slot + q * S4, tt + (int64_t)state * S4, S, lane);
    }
  }
  cp_async_wait<0>();
  if (lane == 0) entry_state[b] = state;
}

// The backtrace's launch: trans^T staged where it fits beside one warp's
// ring of P >= 2 positions; P about 4 KB of a row a slot (to 16
// positions); R rows a block, enough that one block an SM holds B rows
// where shared memory allows.
struct BtPlan {
  bool staged;
  int nc, P, R;
  size_t smem;
  int64_t grid;
};

inline BtPlan bt_plan(int S, int64_t B, int sms) {
  BtPlan pl;
  const int64_t S4 = padded_states(S);
  const int64_t room = kSmemLimit / (int64_t)sizeof(float);
  const int64_t per_pos = (int64_t)kBtSlots * S4;  // a warp's ring a position
  pl.staged = S * S4 + 2 * per_pos <= room;
  pl.nc = bt_chunks_per_lane(S, pl.staged ? bt_chunk<true>()
                                          : bt_chunk<false>());
  const int64_t free = room - (pl.staged ? S * S4 : 0);
  int64_t P = 1024 / S;
  P = P < 1 ? 1 : (P > 16 ? 16 : P);
  if (P > free / per_pos) P = free / per_pos;
  pl.P = (int)P;
  const int64_t fit = free / (P * per_pos);
  int64_t R = (B + sms - 1) / sms;
  R = R < 1 ? 1 : R;
  R = R > kBtMaxWarps ? kBtMaxWarps : R;
  pl.R = (int)(R > fit ? fit : R);
  pl.smem = sizeof(float) * ((pl.staged ? (size_t)(S * S4) : 0) +
                             (size_t)pl.R * P * per_pos);
  pl.grid = (B + pl.R - 1) / pl.R;
  return pl;
}

struct BtArgs {
  const float* trans_t;
  const float* rows;
  int64_t row_stride;
  const float* entry;
  int64_t entry_stride;
  const int32_t* end_state;
  const int32_t* lens;
  int32_t* path;
  int32_t* entry_state;
  int64_t B, L;
  int S;
};

template <int NC, bool kStaged>
int launch_backtrace(const BtArgs& a, const BtPlan& pl, cudaStream_t st) {
  const auto kernel = viterbi_backtrace_kernel<NC, kStaged>;
  cudaError_t err = allow_smem(kernel, pl.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)pl.grid, pl.R * 32, pl.smem, st>>>(
      a.trans_t, a.rows, a.row_stride, a.entry, a.entry_stride,
      a.end_state, a.lens, a.path, a.entry_state, a.B, a.L, a.S, pl.P);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// The exact decoder's backtrace from K3's pointers (rows: every (table,
// chunk) of a group, each [L, S] uint8): chunk_entry_map_kernel walks
// each row back from all S end states at once (a thread an end state),
// giving the state at position -1 for each; chunk_compose_kernel
// composes those maps from a group's end state back, a thread a table,
// giving every chunk's end state; chunk_chase_kernel walks each row back
// from its own end state and writes its path.  Bound on an H100: a walk
// is a chain of dependent loads, one a position.  Design: a block a row
// stages the row's pointers from its end in windows of kWindowBytes, two
// in a cp.async ring, so each step is a byte load from shared memory and
// not a round trip to L2; rows run in parallel, so a group's backtrace
// is one row's walk long, and the sequential part is the n lookups a
// table of the compose.  Past a row's length the state holds, as in the
// backtrace kernel (K3 writes identity pointers there).
constexpr int kWindowBytes = 16384;  // pointer bytes a window holds
constexpr int kChaseThreads = 32;

// A row's windows, walked from its end: window k holds positions
// [lo, hi), hi = n - k W, lo = max(hi - W, 0).  The ring's slots hold
// the window's bytes from a 16-byte boundary below its first one.
struct PtrWindows {
  const uint8_t* row;  // the row's pointer at position 0
  const uint8_t* end;  // one past the tensor's last byte
  int64_t n;           // positions walked, [0, n)
  int S, W, slot;      // states; positions a window; bytes a slot
};

__host__ __device__ __forceinline__ int window_positions(int S) {
  return kWindowBytes / S > 0 ? kWindowBytes / S : 1;
}

// a slot holds W S bytes from up to 15 bytes before the window, to a
// 16-byte boundary past it; a multiple of 16
__host__ __device__ __forceinline__ int window_slot(int S) {
  return (window_positions(S) * S + 47) & ~15;
}

// Start window k's copy into slot k & 1 and commit it (an empty group
// past position 0).  Pieces of 16 bytes with cp.async; the tensor's last
// piece, where it ends short of 16 bytes, by plain loads.  Call with the
// whole block.
__device__ __forceinline__ void stage_window(uint8_t* ring,
                                             const PtrWindows& w,
                                             int64_t k) {
  const int64_t hi = w.n - k * w.W;
  if (hi > 0) {
    const int64_t lo = hi - w.W > 0 ? hi - w.W : 0;
    const uintptr_t a_hi = (uintptr_t)(w.row + hi * w.S);
    const uintptr_t a0 = (uintptr_t)(w.row + lo * w.S) & ~(uintptr_t)15;
    const uintptr_t end = (uintptr_t)w.end;
    uint8_t* dst = ring + (k & 1) * w.slot;
    for (uintptr_t p = a0 + 16 * threadIdx.x; p < a_hi;
         p += 16 * blockDim.x) {
      uint8_t* d = dst + (p - a0);
      if (p + 16 <= end)
        cp_async16(reinterpret_cast<float*>(d),
                   reinterpret_cast<const float*>(p));
      else
        for (uintptr_t q = p; q < end; ++q)
          d[q - p] = *reinterpret_cast<const uint8_t*>(q);
    }
  }
  cp_async_commit();
}

// Walk the row back over [0, n) from each thread's state, window by
// window; step(t, p) sees position t's pointers at p (p[state] is the
// state at t - 1).  Call with the whole block.
template <typename Step>
__device__ __forceinline__ void walk_windows(uint8_t* ring,
                                             const PtrWindows& w,
                                             bool walks, Step step) {
  const int64_t n_win = (w.n + w.W - 1) / w.W;
  stage_window(ring, w, 0);
  stage_window(ring, w, 1);
  for (int64_t k = 0; k < n_win; ++k) {
    cp_async_wait<1>();  // window k is in; k + 1 may be in flight
    __syncthreads();     // every thread's pieces of it
    const int64_t hi = w.n - k * w.W;
    const int64_t lo = hi - w.W > 0 ? hi - w.W : 0;
    const int d = (int)((uintptr_t)(w.row + lo * w.S) & 15);
    const uint8_t* p = ring + (k & 1) * w.slot + d + (hi - 1 - lo) * w.S;
    if (walks) {
#pragma unroll 4
      for (int64_t t = hi - 1; t >= lo; --t, p -= w.S) step(t, p);
    }
    __syncthreads();  // the slot may be refilled
    stage_window(ring, w, k + 2);
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(256)
    chunk_entry_map_kernel(const uint8_t* __restrict__ ptrs,
                           const int32_t* __restrict__ lens,
                           int32_t* __restrict__ map, int64_t R, int64_t L,
                           int S) {
  extern __shared__ __align__(16) uint8_t s_ring[];
  const int64_t r = blockIdx.x;
  const int64_t n = max((int64_t)0, min((int64_t)lens[r], L));
  const PtrWindows w{ptrs + r * L * S, ptrs + R * L * S, n, S,
                     window_positions(S), window_slot(S)};
  const int s = threadIdx.x;
  int state = s;
  walk_windows(s_ring, w, s < S,
               [&](int64_t, const uint8_t* p) { state = p[state]; });
  if (s < S) map[r * S + s] = state;
}

__global__ void __launch_bounds__(128)
    chunk_compose_kernel(const int32_t* __restrict__ map,
                         const int32_t* __restrict__ end_state,
                         int32_t* __restrict__ ends,
                         int32_t* __restrict__ entry, int64_t B, int64_t n,
                         int S) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int e = end_state[b];
  for (int64_t c = n - 1; c >= 0; --c) {
    ends[b * n + c] = e;
    e = map[(b * n + c) * S + e];
  }
  entry[b] = e;
}

__global__ void __launch_bounds__(kChaseThreads)
    chunk_chase_kernel(const uint8_t* __restrict__ ptrs,
                       const int32_t* __restrict__ end_state,
                       const int32_t* __restrict__ lens,
                       int32_t* __restrict__ path, int64_t R, int64_t L,
                       int S) {
  extern __shared__ __align__(16) uint8_t s_ring[];
  const int64_t r = blockIdx.x;
  const int64_t n = max((int64_t)0, min((int64_t)lens[r], L));
  const PtrWindows w{ptrs + r * L * S, ptrs + R * L * S, n, S,
                     window_positions(S), window_slot(S)};
  int state = end_state[r];
  int32_t* out = path + r * L;
  for (int64_t t = n + threadIdx.x; t < L; t += blockDim.x) out[t] = state;
  walk_windows(s_ring, w, threadIdx.x == 0,
               [&](int64_t t, const uint8_t* p) {
                 out[t] = state;
                 state = p[state];
               });
}

// K2's forward arguments: v_out (the value rows), or ptr_out and
// last_out (the pointer mode), the other null
struct K2Args {
  const int32_t* sym;
  const int32_t* lens;
  const float* start;
  const float* trans;
  const float* em;
  float* v_out;
  uint8_t* ptr_out;
  float* last_out;
  float* dm_out;
  int64_t B, L;
  int S, T, V;
  ObsStreams st;
};

int64_t fwd_grid(int64_t B) {
  return (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

template <int SPL>
int launch_fwd(const K2Args& a, cudaStream_t stream) {
  const auto kernel = a.ptr_out != nullptr ? viterbi_fwd_kernel<SPL, true>
                                           : viterbi_fwd_kernel<SPL, false>;
  const size_t smem =
      sizeof(float) * ((size_t)a.S * a.S + (size_t)a.S * a.T * a.V +
                       (size_t)a.S + coef_floats(a.S, a.st.values, a.st.G) +
                       (size_t)kWarpsPerBlock * a.S);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)fwd_grid(a.B), kWarpsPerBlock * 32, smem, stream>>>(
      a.sym, a.lens, a.start, a.trans, a.em, a.v_out, a.ptr_out, a.last_out,
      a.dm_out, a.B, a.L, a.S, a.T, a.V, a.st);
  return (int)cudaGetLastError();
}

template <int NS>
int launch_fwd_lanes(const K2Args& a, cudaStream_t stream) {
  const auto kernel = a.ptr_out != nullptr
                          ? viterbi_fwd_lanes_kernel<NS, true>
                          : viterbi_fwd_lanes_kernel<NS, false>;
  const size_t smem =
      sizeof(float) * k2_lanes_smem_floats(a.S, a.T, a.V, a.st.G);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)fwd_grid(a.B), kWarpsPerBlock * 32, smem, stream>>>(
      a.sym, a.lens, a.start, a.trans, a.em, a.v_out, a.ptr_out, a.last_out,
      a.dm_out, a.B, a.L, a.S, a.T, a.V, a.st);
  return (int)cudaGetLastError();
}

K2Args k2_args(const void* sym, const void* lens, const void* start,
               const void* trans, const void* em, void* v_out,
               void* ptr_out, void* last_out, void* dm_out, int64_t B,
               int64_t L, int S, int T, int V, const void* w,
               const void* values, const void* coef, int G) {
  return K2Args{(const int32_t*)sym, (const int32_t*)lens,
                (const float*)start, (const float*)trans, (const float*)em,
                (float*)v_out, (uint8_t*)ptr_out, (float*)last_out,
                (float*)dm_out, B, L, S, T, V,
                make_streams(w, values, coef, G)};
}

int fwd_shared(const K2Args& a, cudaStream_t st) {
  switch (states_per_lane(a.S)) {
    case 1:
      return launch_fwd<1>(a, st);
    case 2:
      return launch_fwd<2>(a, st);
    case 4:
      return launch_fwd<4>(a, st);
    case 8:
      return launch_fwd<8>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int fwd_lanes(const K2Args& a, cudaStream_t st) {
  // the row's registers: S rounded up to a multiple of 4
  switch ((a.S + 3) / 4) {
    case 1:
      return launch_fwd_lanes<4>(a, st);
    case 2:
      return launch_fwd_lanes<8>(a, st);
    case 3:
      return launch_fwd_lanes<12>(a, st);
    case 4:
      return launch_fwd_lanes<16>(a, st);
    case 5:
      return launch_fwd_lanes<20>(a, st);
    case 6:
      return launch_fwd_lanes<24>(a, st);
    case 7:
      return launch_fwd_lanes<28>(a, st);
    case 8:
      return launch_fwd_lanes<32>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K3's arguments: exactly one of v_out, ckpt and ptr_out is non-null
struct SweepArgs {
  const float* obs;
  const float* carry;
  const int32_t* lens;
  const float* trans;
  float* v_out;
  float* ckpt;
  uint8_t* ptr_out;
  int64_t B, L;
  int S;
  int64_t chunk, n_ck;
};

template <int NS>
int launch_sweep_lanes(const SweepArgs& a, cudaStream_t stream) {
  const auto kernel = a.ptr_out != nullptr
                          ? viterbi_sweep_lanes_kernel<NS, true>
                          : viterbi_sweep_lanes_kernel<NS, false>;
  const size_t smem = sizeof(float) * kWarpsPerBlock * 2 * kHalf * 32;
  const int64_t grid = (a.B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  kernel<<<(unsigned)grid, kWarpsPerBlock * 32, smem, stream>>>(
      a.obs, a.carry, a.lens, a.trans, a.v_out, a.ckpt, a.ptr_out, a.B, a.L,
      a.S, a.chunk, a.n_ck);
  return (int)cudaGetLastError();
}

template <int SPL>
int launch_sweep_smem(const SweepArgs& a, cudaStream_t stream) {
  const auto kernel = a.ptr_out != nullptr
                          ? viterbi_sweep_smem_kernel<SPL, true>
                          : viterbi_sweep_smem_kernel<SPL, false>;
  const size_t smem =
      sizeof(float) * ((size_t)a.S * a.S + (size_t)kWarpsPerBlock * a.S);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t grid = (a.B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  kernel<<<(unsigned)grid, kWarpsPerBlock * 32, smem, stream>>>(
      a.obs, a.carry, a.lens, a.trans, a.v_out, a.ckpt, a.ptr_out, a.B, a.L,
      a.S, a.chunk, a.n_ck);
  return (int)cudaGetLastError();
}

SweepArgs sweep_args(const void* obs, const void* carry, const void* lens,
                     const void* trans, void* v_out, void* ckpt,
                     void* ptr_out, int64_t B, int64_t L, int S,
                     int64_t chunk, int64_t n_ck) {
  return SweepArgs{(const float*)obs, (const float*)carry,
                   (const int32_t*)lens, (const float*)trans,
                   (float*)v_out, (float*)ckpt, (uint8_t*)ptr_out,
                   B, L, S, chunk, n_ck};
}

int sweep_lanes(const SweepArgs& a, cudaStream_t st) {
  if ((a.v_out != nullptr) + (a.ckpt != nullptr) + (a.ptr_out != nullptr) !=
      1)
    return (int)cudaErrorInvalidValue;
  // the row's registers: S rounded up to a multiple of 4
  switch ((a.S + 3) / 4) {
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

int sweep_smem(const SweepArgs& a, cudaStream_t st) {
  if ((a.v_out != nullptr) + (a.ckpt != nullptr) + (a.ptr_out != nullptr) !=
      1)
    return (int)cudaErrorInvalidValue;
  // to 32 states only where the shared step is forced (the lanes step
  // takes them)
  switch (states_per_lane(a.S)) {
    case 1:
      return launch_sweep_smem<1>(a, st);
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

}  // namespace

extern "C" {

const char* tehmm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K2's forward, either variant (ops/cuda_kernels.k2_step picks by S):
// value rows v_out [B, L, S] and dm_out [B, L].  w, values and coef may
// be null (no segment weights / gaussian tracks).
int tehmm_viterbi_fwd(const void* sym, const void* lens, const void* start,
                      const void* trans, const void* em, void* v_out,
                      void* dm_out, int64_t B, int64_t L, int S, int T,
                      int V, const void* w, const void* values,
                      const void* coef, int G, void* stream) {
  return fwd_shared(k2_args(sym, lens, start, trans, em, v_out, nullptr,
                            nullptr, dm_out, B, L, S, T, V, w, values, coef,
                            G),
                    (cudaStream_t)stream);
}

int tehmm_viterbi_fwd_lanes(const void* sym, const void* lens,
                            const void* start, const void* trans,
                            const void* em, void* v_out, void* dm_out,
                            int64_t B, int64_t L, int S, int T, int V,
                            const void* w, const void* values,
                            const void* coef, int G, void* stream) {
  return fwd_lanes(k2_args(sym, lens, start, trans, em, v_out, nullptr,
                           nullptr, dm_out, B, L, S, T, V, w, values, coef,
                           G),
                   (cudaStream_t)stream);
}

// K2's forward in pointer mode, either variant: ptr_out [B, L, S] uint8
// (the first-hit argmax predecessor of every state at every position; the
// identity at position 0 and past a row's length), last_out [B, S] (the
// last value row) and dm_out [B, L].
int tehmm_viterbi_fwd_ptrs(const void* sym, const void* lens,
                           const void* start, const void* trans,
                           const void* em, void* ptr_out, void* last_out,
                           void* dm_out, int64_t B, int64_t L, int S, int T,
                           int V, const void* w, const void* values,
                           const void* coef, int G, void* stream) {
  return fwd_shared(k2_args(sym, lens, start, trans, em, nullptr, ptr_out,
                            last_out, dm_out, B, L, S, T, V, w, values, coef,
                            G),
                    (cudaStream_t)stream);
}

int tehmm_viterbi_fwd_ptrs_lanes(const void* sym, const void* lens,
                                 const void* start, const void* trans,
                                 const void* em, void* ptr_out,
                                 void* last_out, void* dm_out, int64_t B,
                                 int64_t L, int S, int T, int V,
                                 const void* w, const void* values,
                                 const void* coef, int G, void* stream) {
  return fwd_lanes(k2_args(sym, lens, start, trans, em, nullptr, ptr_out,
                           last_out, dm_out, B, L, S, T, V, w, values, coef,
                           G),
                   (cudaStream_t)stream);
}

// The shared-memory floats a block of K2's lanes forward takes at S
// states, T tracks of V symbols and G gaussian tracks: ops/cuda_kernels.
// k2_step's fit test is held to it.
int64_t tehmm_k2_lanes_smem_floats(int S, int T, int V, int G) {
  return k2_lanes_smem_floats(S, T, V, G);
}

// K3's sweep, either step variant (ops/cuda_kernels.k3_step picks by S).
// v_out: value rows [B, L, S], or ckpt: the carry leaving every chunk of
// `chunk` positions [B, n_ck, S] (the other null).
int tehmm_viterbi_sweep_lanes(const void* obs, const void* carry,
                              const void* lens, const void* trans,
                              void* v_out, void* ckpt, int64_t B, int64_t L,
                              int S, int64_t chunk, int64_t n_ck,
                              void* stream) {
  return sweep_lanes(sweep_args(obs, carry, lens, trans, v_out, ckpt,
                                nullptr, B, L, S, chunk, n_ck),
                     (cudaStream_t)stream);
}

int tehmm_viterbi_sweep_smem(const void* obs, const void* carry,
                             const void* lens, const void* trans,
                             void* v_out, void* ckpt, int64_t B, int64_t L,
                             int S, int64_t chunk, int64_t n_ck,
                             void* stream) {
  return sweep_smem(sweep_args(obs, carry, lens, trans, v_out, ckpt,
                               nullptr, B, L, S, chunk, n_ck),
                    (cudaStream_t)stream);
}

// K3's pointer mode, either step variant: ptr_out [B, L, S] uint8, the
// first-hit argmax predecessor of every state at every position (the
// identity at and past a row's length).
int tehmm_viterbi_pointers_lanes(const void* obs, const void* carry,
                                 const void* lens, const void* trans,
                                 void* ptr_out, int64_t B, int64_t L, int S,
                                 void* stream) {
  return sweep_lanes(sweep_args(obs, carry, lens, trans, nullptr, nullptr,
                                ptr_out, B, L, S, 0, 0),
                     (cudaStream_t)stream);
}

int tehmm_viterbi_pointers_smem(const void* obs, const void* carry,
                                const void* lens, const void* trans,
                                void* ptr_out, int64_t B, int64_t L, int S,
                                void* stream) {
  return sweep_smem(sweep_args(obs, carry, lens, trans, nullptr, nullptr,
                               ptr_out, B, L, S, 0, 0),
                    (cudaStream_t)stream);
}

// The pointer backtrace's three launches (S <= 256, uint8 pointers
// [R, L, S] 16-byte aligned; int32 lengths [R]).  map: the state at
// position -1 of each row from each end state, int32 [R, S].
int tehmm_chunk_entry_map(const void* ptrs, const void* lens, void* map,
                          int64_t R, int64_t L, int S, void* stream) {
  if (S < 1 || S > 256) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)window_slot(S);
  const int threads = 32 * ((S + 31) / 32);
  chunk_entry_map_kernel<<<(unsigned)R, threads, smem,
                           (cudaStream_t)stream>>>(
      (const uint8_t*)ptrs, (const int32_t*)lens, (int32_t*)map, R, L, S);
  return (int)cudaGetLastError();
}

// compose: map [B, n, S] from end_state [B] back; ends [B, n] (each
// chunk's end state), entry [B] (the state before the first chunk).
int tehmm_chunk_compose(const void* map, const void* end_state, void* ends,
                        void* entry, int64_t B, int64_t n, int S,
                        void* stream) {
  const int64_t grid = (B + 127) / 128;
  chunk_compose_kernel<<<(unsigned)grid, 128, 0, (cudaStream_t)stream>>>(
      (const int32_t*)map, (const int32_t*)end_state, (int32_t*)ends,
      (int32_t*)entry, B, n, S);
  return (int)cudaGetLastError();
}

// chase: path [R, L] of each row from its end state [R].
int tehmm_chunk_chase(const void* ptrs, const void* end_state,
                      const void* lens, void* path, int64_t R, int64_t L,
                      int S, void* stream) {
  if (S < 1 || S > 256) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)window_slot(S);
  chunk_chase_kernel<<<(unsigned)R, kChaseThreads, smem,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)ptrs, (const int32_t*)end_state, (const int32_t*)lens,
      (int32_t*)path, R, L, S);
  return (int)cudaGetLastError();
}

// The value-row backtrace; trans_t is trans^T with its rows padded to
// S4 = S rounded up to 4 floats, [S, S4] dense.
int tehmm_viterbi_backtrace(const void* trans_t, const void* rows,
                            int64_t row_stride, const void* entry,
                            int64_t entry_stride, const void* end_state,
                            const void* lens, void* path, void* entry_state,
                            int64_t B, int64_t L, int S, void* stream) {
  if (S < 1 || S > 1024) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const BtPlan pl = bt_plan(S, B, sms);
  const BtArgs a{(const float*)trans_t, (const float*)rows, row_stride,
                 (const float*)entry,   entry_stride,
                 (const int32_t*)end_state, (const int32_t*)lens,
                 (int32_t*)path, (int32_t*)entry_state, B, L, S};
  const cudaStream_t st = (cudaStream_t)stream;
  if (pl.staged) {
    switch (pl.nc) {
      case 1:
        return launch_backtrace<1, true>(a, pl, st);
      case 2:
        return launch_backtrace<2, true>(a, pl, st);
      case 4:
        return launch_backtrace<4, true>(a, pl, st);
      case 8:
        return launch_backtrace<8, true>(a, pl, st);
    }
  } else {
    switch (pl.nc) {
      case 2:
        return launch_backtrace<2, false>(a, pl, st);
      case 4:
        return launch_backtrace<4, false>(a, pl, st);
      case 8:
        return launch_backtrace<8, false>(a, pl, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
