// Helpers shared by the port's kernels (viterbi.cu, em_estep.cu,
// posterior.cu; through scan_tile.cuh streaming.cu and scans.cu;
// maxplus.cu): one warp per batch row with lane <-> state, up to 8
// states per lane, tables staged into shared memory by the whole block,
// the one in-register observation routine (obs_log) with its optional
// segment-weight and gaussian streams, the cp.async staging of matrix
// rows, the long sweeps' obs read ahead of their chain (K3, X1, X2) with
// the exact maxes of the lanes steps (theirs, K1's and K4's), and the
// staging ring of the lanes kernels that form obs themselves (K1, K2's
// forward, K4).
// Everything is in an anonymous namespace: each source gets its own copy.

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

// The gaussian term of one state's obs_log at one position, from its G
// values v and the state's coefficients c [c0 | c1 | c2]:
// (sum_g m c0) + (sum_g xm c1) + (sum_g x2m c2), each block summed in
// track order g = 0..G-1 (models/gauss).
__device__ __forceinline__ float gauss_term(const float* v, const float* c,
                                            int G) {
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
  return __fadd_rn(__fadd_rn(s0, s1), s2);
}

// obs_log of state j at flat position pos (symbols x):
//   1. the categorical sum in track order t = 0..T-1
//      (models/emission.track_log_likelihoods);
//   2. plus the gaussian term (gauss_term);
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
  if (st.values != nullptr)
    o = __fadd_rn(o, gauss_term(st.values + pos * st.G,
                                st.s_coef + (int64_t)j * 3 * st.G, st.G));
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

// cp.async: copies from global into shared memory that the thread does
// not wait for until cp_async_wait (sm_80 and later).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The long sweeps' obs read ahead of their chain (K3 in viterbi.cu, X1
// and X2 in posterior.cu): one warp walks a row whose every step needs the
// whole previous row, so no global load may sit between two dependent
// steps.
//
//   lanes step   each lane copies its own column of the next positions
//                into a ring in shared memory with cp.async, kHalf
//                positions at a time, two halves in flight (only the lane
//                that copied an element reads it, so the copy needs no
//                barrier): stage_column, or stage_column_reverse for X2,
//                which walks the row from its end;
//   shared step  each lane keeps its states' obs kAhead positions ahead
//                in registers: load_obs, or load_obs_reverse.
constexpr int kHalf = 32;  // positions a lane stages at a time (lanes)
constexpr int kAhead = 4;  // positions of obs held ahead (shared)

// Copy this lane's column of positions [p0, min(p0 + kHalf, n)) into
// its ring half and commit the copy (an empty group past n).  ``ring``
// is the lane's first slot of 2 kHalf, 32 floats apart.
__device__ __forceinline__ void stage_column(float* ring, const float* ob,
                                             int64_t p0, int64_t n,
                                             int S, bool mine) {
  float* dst = ring + ((p0 / kHalf) & 1) * kHalf * 32;
  if (mine)
    for (int k = 0; k < kHalf && p0 + k < n; ++k)
      cp_async4(dst + k * 32, ob + (p0 + k) * S);
  cp_async_commit();
}

// this lane's obs of its states at position t (0 past n)
template <int SPL>
__device__ __forceinline__ void load_obs(float (&o)[SPL], const float* ob,
                                         int64_t t, int64_t n, int S,
                                         int lane) {
#pragma unroll
  for (int q = 0; q < SPL; ++q) {
    const int j = lane + 32 * q;
    o[q] = (j < S && t < n) ? ob[t * S + j] : 0.0f;
  }
}

// The same two for a walk from position n-1 down to 0: step r reads
// position n-1-r.  stage_column_reverse copies this lane's column of steps
// [r0, min(r0 + kHalf, n)) into its ring half (slot k: step r0 + k);
// load_obs_reverse reads step r's obs (0 past n).
__device__ __forceinline__ void stage_column_reverse(float* ring,
                                                     const float* ob,
                                                     int64_t r0, int64_t n,
                                                     int S, bool mine) {
  float* dst = ring + ((r0 / kHalf) & 1) * kHalf * 32;
  if (mine)
    for (int k = 0; k < kHalf && r0 + k < n; ++k)
      cp_async4(dst + k * 32, ob + (n - 1 - r0 - k) * S);
  cp_async_commit();
}

template <int SPL>
__device__ __forceinline__ void load_obs_reverse(float (&o)[SPL],
                                                 const float* ob, int64_t r,
                                                 int64_t n, int S,
                                                 int lane) {
#pragma unroll
  for (int q = 0; q < SPL; ++q) {
    const int j = lane + 32 * q;
    o[q] = (j < S && r < n) ? ob[(n - 1 - r) * S + j] : 0.0f;
  }
}

// max over a[0..NS) by a pairwise tree (entries past S hold -inf or a
// value no larger than the caller's clamp, so the result is the max over
// the S states); NS is S rounded up to a multiple of 4.  max is exact,
// so any order gives the bits of a sequential max.
template <int NS>
__device__ __forceinline__ float row_max(const float (&src)[NS]) {
  float a[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) a[i] = src[i];
#pragma unroll
  for (int w = 1; w < NS; w <<= 1)
#pragma unroll
    for (int i = 0; i + w < NS; i += 2 * w) a[i] = fmaxf(a[i], a[i + w]);
  return a[0];
}

// The exact max over a row held one state a lane (lanes past S at or
// below the callers' clamp): to kGatherStates states the NS values
// gathered by shuffles and a tree (row_max), beyond a butterfly over the
// warp (warp_max), whichever read faster on an H100 80GB HBM3
// (tools/time_x2's sweep, PERF.md: the gather 0.314 against 0.368 us a
// step at S=10, the butterfly 0.451 against 0.478 at 32, level at 20).
// Any order of an exact max gives the same bits.  The lanes steps of X2
// and K4's decode (posterior.cu) and K1 (em_estep.cu).
constexpr int kGatherStates = 16;

template <int NS>
__device__ __forceinline__ float lanes_row_max(float v) {
  if constexpr (NS <= kGatherStates) {
    float r[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) r[j] = __shfl_sync(0xffffffffu, v, j);
    return row_max<NS>(r);
  } else {
    return warp_max(v);
  }
}

// The max-plus lanes step (S <= 32, lane j state j, every lane the
// whole row): K2's forward and K3 (viterbi.cu), K5 (streaming.cu) and
// K8c (scans.cu) to 32 states.

// The first i with a[i] the max over a[0..NS) (row_max's pairwise tree,
// each node keeping the index of its value: the left node holds the lower
// indices and keeps ties, a strict '>' takes the right one), so for
// ordered values the first hit of a scan from i = 0 with a strict '>'.
template <int NS>
__device__ __forceinline__ int row_argmax(const float (&src)[NS]) {
  float a[NS];
  int k[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    a[i] = src[i];
    k[i] = i;
  }
#pragma unroll
  for (int w = 1; w < NS; w <<= 1)
#pragma unroll
    for (int i = 0; i + w < NS; i += 2 * w)
      if (a[i + w] > a[i]) {
        a[i] = a[i + w];
        k[i] = k[i + w];
      }
  return k[0];
}

// The new row from every lane's value nv (lanes past S: -inf): the row
// (row[i] = nv_i - m) and lane j's nv - m, m = max(max_i nv_i, LOG_ZERO)
// (renorm_store's normaliser; with ``m_out``, stored there).
template <int NS>
__device__ __forceinline__ float lanes_renorm(float (&row)[NS], float nv,
                                              float* m_out = nullptr) {
  float a[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) a[i] = __shfl_sync(0xffffffffu, nv, i);
  const float m = fmaxf(row_max<NS>(a), kLogZero);
#pragma unroll
  for (int i = 0; i < NS; ++i) row[i] = a[i] - m;
  if (m_out != nullptr) *m_out = m;
  return nv - m;
}

// One step of the lanes variant: lane j's new value from the row and its
// trans column, then the new row from every lane, renormalised in each.
// Returns lane j's renormalised value; with ``arg``, lane j's first-hit
// argmax predecessor (row_argmax: entries past S are -inf and never
// win).  Entries past S are -inf in the
// row and in trans (and the lanes past S produce -inf), so they stay
// -inf and never change a max.  The adds and subtractions round once
// each and the max is exact, so the bits are dp._maxplus_step's.
template <int NS>
__device__ __forceinline__ float lanes_step(float (&row)[NS],
                                            const float (&tc)[NS],
                                            float o, int* arg = nullptr,
                                            float* m_out = nullptr) {
  float a[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) a[i] = row[i] + tc[i];
  if (arg != nullptr) *arg = row_argmax<NS>(a);  // off the chain
  return lanes_renorm<NS>(row, row_max<NS>(a) + o, m_out);
}

// The lanes kernels' staging ring (K1's in em_estep.cu, K2's forward in
// viterbi.cu, K4's decode in posterior.cu; S <= 32, one state a lane):
// each warp stages its row's streams into a ring of two slots of kHalf
// positions with cp.async, the
// lanes taking every 32nd word of each stream's block, so every lane
// reads every word after a __syncwarp.  A slot holds, in this order:
// symbols [kHalf][T], segment weights [kHalf] (its room kept without the
// stream), gaussian values [kHalf][G] and, in the reverse walks, alpha_p
// rows [kHalf][S] (and K1's m_raw [kHalf]), each position at its offset
// from the slot's first.

// x / y with IEEE float division's bits, for a divisor y that is a normal
// float (the lanes kernels' divisors are clamped at 1e-37 or 1e-30 and
// finite) and a finite x, without the float divide's slow-path branch:
// with it the forward step at S=10 took 0.46 us on an H100 80GB HBM3,
// with this 0.32 (tools/time_k1, PERF.md).  A double reciprocal
// estimate, two Newton steps (~2^-53) and a Markstein correction give the
// quotient within an ulp of double, and a quotient of two floats lies at
// least 2^-50 of itself from a float rounding boundary or exactly on one
// (then the correction makes it exact), so rounding it to float gives
// the IEEE quotient.
__device__ __forceinline__ float div_rn(float x, float y) {
  const double xd = x, yd = y;
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(yd));
  double e = fma(-yd, r, 1.0);
  r = fma(r, e, r);
  e = fma(-yd, r, 1.0);
  r = fma(r, e, r);
  const double q = xd * r;
  return (float)fma(fma(-yd, q, xd), r, q);
}

// Floats of one slot, with ``rows`` floats a position past the streams:
// 0 (K1's forward), S + 1 (K1's reverse: alpha_p and m_raw) or S (K4's
// decode: alpha_p).
__host__ __device__ __forceinline__ int64_t slot_floats(int S, int T, int G,
                                                        int rows) {
  return (int64_t)kHalf * (T + 1 + G + rows);
}

// Issue the copy of n 4-byte words from src to dst, each lane every 32nd.
__device__ __forceinline__ void copy_words(float* dst, const void* src,
                                           int64_t n, int lane) {
  const float* s = static_cast<const float*>(src);
  for (int64_t e = lane; e < n; e += 32) cp_async4(dst + e, s + e);
}

// Stage the ``cnt`` positions from flat position ``pos`` (0 or fewer:
// nothing) into ``slot`` and commit the copy.  alpha: the reverse walks'
// alpha_p rows (K1's reverse, K4's decode), else nullptr; mraw: K1's
// reverse's m_raw after them, else nullptr.
__device__ __forceinline__ void stage_slot(float* slot, int64_t pos,
                                           int64_t cnt, const int32_t* sym,
                                           int S, int T,
                                           const ObsStreams& st,
                                           const float* alpha,
                                           const float* mraw, int lane) {
  if (cnt > 0) {
    const int G = st.values != nullptr ? st.G : 0;
    float* w = slot + kHalf * T;
    float* v = w + kHalf;
    copy_words(slot, sym + pos * T, cnt * T, lane);
    if (st.w != nullptr) copy_words(w, st.w + pos, cnt, lane);
    if (G > 0) copy_words(v, st.values + pos * G, cnt * G, lane);
    if (alpha != nullptr) {
      float* a = v + kHalf * G;
      copy_words(a, alpha + pos * S, cnt * S, lane);
      if (mraw != nullptr) copy_words(a + kHalf * S, mraw + pos, cnt, lane);
    }
  }
  cp_async_commit();
}

// obs_log of every state at one position, as common.cuh obs_log computes
// each (the same operations in the same order, so the same bits), with the
// loops over tracks and states interchanged so the states' sums advance
// together: o[j] for j < S.
template <int NS>
__device__ __forceinline__ void obs_row(const float* s_em, const int32_t* x,
                                        int S, int T, int V, const float* v,
                                        const float* s_coef, int G,
                                        const float* w, float (&o)[NS]) {
  const int64_t TV = (int64_t)T * V;
  const float* e = s_em + x[0];
#pragma unroll
  for (int j = 0; j < NS; ++j) o[j] = j < S ? e[j * TV] : 0.0f;
  for (int tt = 1; tt < T; ++tt) {
    e = s_em + tt * V + x[tt];
#pragma unroll
    for (int j = 0; j < NS; ++j)
      if (j < S) o[j] += e[j * TV];
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (j < S && v != nullptr)
      o[j] = __fadd_rn(o[j], gauss_term(v, s_coef + (int64_t)j * 3 * G, G));
    if (j < S && w != nullptr) o[j] = __fmul_rn(o[j], *w);
  }
}

// obs_log of every state at the slot's position ``lane`` (obs_row over
// the slot's symbols and streams): o[j] for j < S.  slot_obs forms obs_p
// from it; K2's lanes forward (viterbi.cu) keeps it as it is.
template <int NS>
__device__ __forceinline__ void slot_obs_row(const float* slot,
                                             const float* s_em, int S, int T,
                                             int V, const ObsStreams& st,
                                             int lane, float (&o)[NS]) {
  const int G = st.values != nullptr ? st.G : 0;
  const float* ws = slot + kHalf * T;
  obs_row<NS>(s_em, reinterpret_cast<const int32_t*>(slot) + lane * T, S,
              T, V, G > 0 ? ws + kHalf + lane * G : nullptr, st.s_coef, G,
              st.w != nullptr ? ws + lane : nullptr, o);
}

// obs_p = exp(obs_log - max obs_log) of the slot's first ``cnt``
// positions into col [kHalf][S], lane k taking position k: obs_probs<1>'s
// operations (its max is exact, so any order gives its bits) with no
// shuffle, the states' sums side by side.  Returns lane k's max (0 past
// cnt).
template <int NS>
__device__ __forceinline__ float slot_obs(const float* slot, int cnt,
                                          const float* s_em, int S, int T,
                                          int V, const ObsStreams& st,
                                          int lane, float* col) {
  if (lane >= cnt) return 0.0f;
  float o[NS];
  slot_obs_row<NS>(slot, s_em, S, T, V, st, lane, o);
  float o_m = -INFINITY;
#pragma unroll
  for (int j = 0; j < NS; ++j)
    if (j < S) o_m = fmaxf(o_m, o[j]);
#pragma unroll
  for (int j = 0; j < NS; ++j)
    if (j < S) col[lane * S + j] = expf(o[j] - o_m);
  return o_m;
}

// Issue the copy of T's rows [i0, min(i0 + blk, Sp)) into dst (16-byte
// pieces where Sp is a multiple of 4 and T 16-byte aligned, else 4-byte
// ones) and commit it.  dst must be 16-byte aligned.
__device__ __forceinline__ void stage_rows_async(float* dst, const float* T,
                                                 int i0, int blk, int Sp) {
  const int rows = min(blk, Sp - i0);
  const float* src = T + (int64_t)i0 * Sp;
  const int n = rows * Sp;
  if ((Sp & 3) == 0 && (reinterpret_cast<uintptr_t>(T) & 15) == 0) {
    for (int k = threadIdx.x * 4; k < n; k += blockDim.x * 4)
      cp_async16(dst + k, src + k);
  } else {
    for (int k = threadIdx.x; k < n; k += blockDim.x)
      cp_async4(dst + k, src + k);
  }
  cp_async_commit();
}

// The staging ring: fold(cur, i0, i1) for the blocks of blk rows of T
// [Sp][Sp] in order, cur the rows [i0, i1) in shared memory (dst holds
// n_slots slots of blk * Sp floats).  With two slots block k + 1 is in
// flight while block k is folded; with one the next copy starts after the
// fold.  Call with the whole block; it synchronizes.
template <typename Fold>
__device__ __forceinline__ void for_each_staged_block(float* dst,
                                                      const float* T, int Sp,
                                                      int blk, int n_slots,
                                                      Fold fold) {
  const int n_blk = (Sp + blk - 1) / blk;
  const int slot = blk * Sp;
  stage_rows_async(dst, T, 0, blk, Sp);
  for (int k = 0; k < n_blk; ++k) {
    const float* cur = dst + (n_slots == 2 ? (k & 1) * slot : 0);
    if (n_slots == 2 && k + 1 < n_blk) {
      // the other slot was last read by block k - 1, which every thread
      // finished before the barrier that ended its fold
      stage_rows_async(dst + ((k + 1) & 1) * slot, T, (k + 1) * blk, blk,
                       Sp);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // block k is in shared memory for every thread
    const int i0 = k * blk;
    fold(cur, i0, min(i0 + blk, Sp));
    __syncthreads();  // the slot may be refilled
    if (n_slots == 1 && k + 1 < n_blk)
      stage_rows_async(dst, T, (k + 1) * blk, blk, Sp);
  }
}

// Opt a kernel in to ``smem`` bytes of dynamic shared memory (above 48 KB
// a kernel must ask).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
