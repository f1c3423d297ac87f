// Hand-written Hopper (sm_90a) kernels for max-posterior decoding and the
// carried forward/backward chunk sweeps (whole-chromosome scoring, the
// exact chunked posteriors and --pd).
//
// Built with viterbi.cu and em_estep.cu into one shared library with a
// plain C interface (tehmm_tpu_torch/ops/cuda_kernels.py: one nvcc -c per
// source, then one link), loaded with ctypes; common.cuh holds the
// helpers the three share.  Every entry point launches
// on the stream it is given, allocates nothing (the Python wrapper
// allocates outputs with torch.empty) and returns the cudaGetLastError()
// that follows its launch.
//
// Kernels and what they replace:
//
//   post_decode_lanes_kernel, post_decode_kernel
//                       K4 decode, _make_post_decode_kernel_v4
//                       (tehmm_tpu/ops/pallas_kernels.py:2765, launched at
//                       :3015 under posterior_decode_fused_pallas_v4
//                       :2911), the lanes variant to 32 states and the
//                       shared one from 33 to K4's envelope
//                       (ops/cuda_kernels.k4_step).  K4's forward is K1's
//                       (em_estep.cu), whose alpha_p rows it reads.
//   fwd_sweep_lanes_kernel, fwd_sweep_smem_kernel
//                       X1: the XLA scans of dp.forward_chunk_values
//                       (tehmm_tpu/ops/dp.py:480) and, in carry-only
//                       mode, dp.forward_final (:378); in the checkpoint
//                       mode the exact posteriors' forward sweep (that
//                       carry chained chunk by chunk, one launch a group).
//   bwd_sweep_lanes_kernel, bwd_sweep_smem_kernel
//                       X2: the XLA scan of dp.backward_chunk_values
//                       (tehmm_tpu/ops/dp.py:507); in the checkpoint mode
//                       the exact posteriors' backward sweep (its x_out
//                       chained chunk by chunk from the last, one launch
//                       a group).
//   fwd_piece_ops_kernel, fwd_piece_compose_kernel
//                       X1's carry-only function (dp.forward_final :378)
//                       as a piece-operator scan: the score's route.
//   X1 and X2 have no Pallas counterpart.
//
// What they compute, per batch row (one independent sequence):
//
//   decode, p = len-1..0, with b = 1 at the last valid position:
//     path[p] = first-hit argmax (lowest state on ties) of alpha_p[p] * b;
//     x = obs_p * b with obs_p = exp(obs_log - max obs_log) (common.cuh
//     obs_log, with the optional segment-weight and gaussian streams),
//     xm = max(max x, 1e-37);  b <- T (x / xm) / max(max T (x / xm), 1e-37).
//     Positions at or past the row's length get path 0.
//   X1, t = 0..Lc-1, from the carry a (max 0):  s_j = sum_i exp(a_i) T[i, j];
//     new_j = (s_j > 0 ? log s_j : LOG_ZERO) + obs_j;
//     m = max(max new, LOG_ZERO);  a <- new - m and dm = m where t < len,
//     else a is carried and dm = 0.  Values mode writes every a; carry-only
//     mode writes dm (the wrapper sums it in one reduction); both write
//     the final carry; the checkpoint mode writes the carry leaving every
//     chunk of ``chunk`` positions of the row.
//   X2, t = Lc-1..0, from x_carry (the next chunk's normalized obs + beta
//     row):  the step from x is  s_i = sum_j exp(x_j) T[i, j],
//     l_i = s_i > 0 ? log s_i : LOG_ZERO,  beta = l - max(max l, LOG_ZERO);
//     the step to x is  x = (obs + beta) - max(max(obs + beta), LOG_ZERO).
//     At t = Lc-1 beta comes from x_carry where the row continues past the
//     chunk, else beta = 0; at t < Lc-1 it comes from the x of position
//     t+1 where t+1 < len, else it is carried.  x at position 0 is x_out.
//     The checkpoint mode walks a span of chunks as one row and writes
//     the x of every chunk's first position, each chunk's last position
//     taking beta = 0 where the row ends inside the span at or before it.
//
// One step, one copy of its code: each kernel runs its step in a single
// loop, and X2 takes the boundary step (beta from x_carry) and x_out with
// the same step functions, so a sweep cut into chunks runs the same
// operations on the same values as one chunk over the whole row and is
// bit-identical to it (the carries pass through memory exactly).
//
// What bounds them on an H100: each row is a chain of dependent steps (an
// S x S product from shared memory, S expf and, in X1/X2, S logf, one or
// two warp reductions), so per-step latency sets the time, not bytes or
// flops: at S = 10 a step is ~2*S*S = 200 flops against 4*S bytes of
// obs/alpha read and 4*S of values written.  The design is K1's: one warp
// per row with lane <-> state (up to 8 states per lane), exp(trans) and
// (decode) log_em in shared memory, the row's state in registers and one
// S-float exchange row per warp in shared memory.  A single chromosome is
// one row, so one warp walks it.
//
// X1 and X2 each walk a whole chromosome on one warp in their checkpoint
// modes (the exact posteriors' forward and backward sweeps), so, as K3
// (viterbi.cu), their steps are cut to their latency, in two variants
// chosen by S (ops/cuda_kernels.x1_step, x2_step):
//
//   lanes (S <= 32)  lane j keeps column j (X1; X2: row j) of exp(trans)
//       in registers and forms expf of its own state; the row of expf
//       values goes round by S shuffles, lane j runs its fmaf chain over
//       them, and the new row goes round by S more for the max (common.cuh
//       row_max; X2 twice, for beta and for x, and past 16 states by a
//       butterfly): no shared memory, barrier or __syncwarp on the chain;
//   shared (33..239) logdot_renorm, the row and exp(trans) in shared
//       memory.
//
// Both read obs ahead of the chain (common.cuh: the lanes step a per-lane
// cp.async ring, stage_column, or stage_column_reverse for X2's walk from
// the end; the shared step kAhead positions in registers, load_obs or
// load_obs_reverse) and stop at the row's length, and both run the same
// operations in the same order (the same expf, the fmaf chain over i =
// 0..S-1 from 0, logf, the clamps, + obs, the exact max), so every mode
// of either gives the plain version's and the other variant's bits.  The
// recomputes of the exact posteriors give every (table, chunk) of a group
// a warp, each from its stored carry.
//
// K4's decode walks every chunk of a stitched decode from its end, a
// warp a row, so its step too is cut to its latency to 32 states
// (post_decode_lanes_kernel, K1's reverse lanes kernel without the
// statistics): exp(trans) in registers, the row round by shuffles, the
// divides by div_rn, the symbols, the streams and alpha_p staged a half
// ahead through common.cuh's ring and a half's obs formed before its
// steps, and the argmax, which nothing on the chain needs, left to the
// half's end; past 32 states post_decode_kernel, obs, the argmax and the
// b product from shared memory in the step.
//
// The piece-operator scan splits the row instead (Sarkka &
// Garcia-Fernandez; across devices the JAX package's parallel/seqpar.py
// _chunk_operator :58 and _compose_and_reduce :77).  Phase A cuts the
// chunk into pieces of ``piece`` positions (dp.PIECE, 128) and gives
// each (row, piece, state i) a warp that runs X1's step over the piece
// from e_i: its final a and the sum n_i of its normalizers are row i of
// the piece's operator, log M[i, j] = a_j + n_i, so the longest chain is
// 128 steps and a row of 16384 at S = 10 is 1280 warps, one wave.
// Phase B, one warp per row, composes the row's pieces behind the
// incoming carry: 128 more steps, each X1's step with the piece's
// exp(a) rows as the matrix.  The arithmetic is S times the chain's;
// what it buys is 256 dependent steps for 16384.  n and the increments
// are summed in double, so the composition adds no float32 rounding of a
// ~1e3 log scale to the carry or the loglik.
//
// Numerics: FP32 FMA on the CUDA cores, full-precision expf/logf (no
// fast-math intrinsics), IEEE division, every clamp of the reference
// (1e-37, LOG_ZERO) kept, so a model with zero transitions behaves as it
// does there; every sum in a fixed order and no atomics, so two runs give
// the same bits.  All index arithmetic is 64-bit.

#include "common.cuh"

namespace {

// The state of argmax_j v[j] with the lowest j among equal maxima, over
// the whole warp (every lane gets it).
template <int SPL>
__device__ __forceinline__ int first_hit_argmax(const float (&v)[SPL], int S,
                                                int lane) {
  float best = -INFINITY;
  int arg = S;
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int j = lane + 32 * k;
    if (j < S && v[k] > best) {
      best = v[k];
      arg = j;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
    if (ob > best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
  return arg;
}

// out_k = log(sum_i exp(in_i) M[i, j]) (LOG_ZERO where the sum is 0) for
// this lane's states j = lane + 32k, with s_m[i * S + j] = M[i, j]; then
// renormalized to max 0.  Returns the normalizer max(max out, LOG_ZERO).
// With kAdd, add[k] is added to each log-sum before the max.
template <int SPL, bool kAdd>
__device__ __forceinline__ float logdot_renorm(float* s_row, const float* s_m,
                                               const float (&in)[SPL],
                                               const float (&add)[SPL],
                                               int S, int lane,
                                               float (&out)[SPL]) {
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int j = lane + 32 * k;
    if (j < S) s_row[j] = expf(in[k]);
  }
  __syncwarp();
  float lmax = -INFINITY;
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int j = lane + 32 * k;
    if (j < S) {
      float s = 0.0f;
      for (int i = 0; i < S; ++i)
        s = fmaf(s_row[i], s_m[(int64_t)i * S + j], s);
      float l = s > 0.0f ? logf(s) : kLogZero;
      if (kAdd) l = l + add[k];
      out[k] = l;
      lmax = fmaxf(lmax, l);
    }
  }
  const float m = fmaxf(warp_max(lmax), kLogZero);
  __syncwarp();  // every lane has read s_row for this step
#pragma unroll
  for (int k = 0; k < SPL; ++k)
    if (lane + 32 * k < S) out[k] = out[k] - m;
  return m;
}

// K4 decode: symbols, alpha_p [B, L, S] in; int32 path [B, L] out.
template <int SPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    post_decode_kernel(const int32_t* __restrict__ sym,
                       const int32_t* __restrict__ lens,
                       const float* __restrict__ trans_p,
                       const float* __restrict__ em,
                       const float* __restrict__ alpha,
                       int32_t* __restrict__ path, int64_t B, int64_t L,
                       int S, int T, int V, ObsStreams st) {
  extern __shared__ float smem[];
  const int64_t TV = (int64_t)T * V;
  float* s_transT = smem;                      // exp(log_trans).T [S, S]
  float* s_em = s_transT + (int64_t)S * S;     // log_em [S, T, V]
  st.s_coef = s_em + S * TV;                   // gaussian coefficients
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* s_xn = st.s_coef + coef_floats(S, st.values, st.G) +
                (int64_t)warp * S;
  stage_transposed(s_transT, trans_p, S);
  stage(s_em, em, S * TV);
  stage_coef(st, S);
  __syncthreads();

  const int64_t b = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;
  const int64_t len = lens[b] < 0 ? 0 : (lens[b] < L ? (int64_t)lens[b] : L);
  int32_t* prow = path + b * L;
  for (int64_t p = len + lane; p < L; p += 32) prow[p] = 0;
  float bv[SPL];
#pragma unroll
  for (int k = 0; k < SPL; ++k) bv[k] = 1.0f;

  for (int64_t p = len - 1; p >= 0; --p) {
    const int64_t pos = b * L + p;
    float ab[SPL];
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const int j = lane + 32 * k;
      if (j < S) ab[k] = alpha[pos * S + j] * bv[k];
    }
    const int state = first_hit_argmax<SPL>(ab, S, lane);
    if (lane == 0) prow[p] = state;

    float x[SPL];
    obs_probs<SPL>(s_em, sym + pos * T, S, T, V, lane, pos, st, x);
    float xmax = 0.0f;
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      if (lane + 32 * k < S) {
        x[k] = x[k] * bv[k];
        xmax = fmaxf(xmax, x[k]);
      }
    }
    const float xm = fmaxf(warp_max(xmax), 1e-37f);
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const int j = lane + 32 * k;
      if (j < S) s_xn[j] = x[k] / xm;
    }
    __syncwarp();
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
    __syncwarp();  // s_xn is free for the next step
  }
}

// Floats of one warp's region of the lanes decode: the ring (a slot
// holding alpha_p rows after the streams) and a half's obs_p [kHalf][S],
// each entry, once read, taking alpha_p b.
__host__ __device__ __forceinline__ int64_t decode_lanes_warp_floats(int S,
                                                                     int T,
                                                                     int G) {
  return 2 * slot_floats(S, T, G, S) + (int64_t)kHalf * S;
}

// Shared-memory floats a block of the lanes decode takes: log_em and the
// gaussian coefficients, then a region a warp.
int64_t decode_lanes_smem_floats(int S, int T, int V, int G) {
  return (int64_t)S * T * V + (int64_t)S * 3 * G +
         kWarpsPerBlock * decode_lanes_warp_floats(S, T, G);
}

// K4 decode, lanes variant (S <= 32, one state a lane), with
// post_decode_kernel's inputs, outputs and bits.  Lane i holds row i of
// exp(log_trans) in registers (tr, 0 past S) and b_i (0 past S).  A step
// is em_bwd_stats_lanes_kernel's b step with no statistics: x = obs_p b,
// xm = max(max x, 1e-37) (exact), xn = x / xm (div_rn); xn goes round by
// NS shuffles into lane i's fmaf chain over j = 0..NS-1 from 0
// (post_decode_kernel's operands in its order; the terms past S are
// exact zeros), and b <- that / max(max, 1e-37) (div_rn).  Off the
// chain, each step stores alpha_p b into the obs_p entry it has just read
// (lane j, state j); at the half's end lane k takes position k's
// first-hit argmax, a scan over j = 0..S-1 with strict > (the lowest
// state on ties, first_hit_argmax's choice), and the half's states go
// out in one store.  The symbols, the streams and the alpha_p rows come
// through the ring in reverse from the row's last valid position, and a
// half's obs_p is formed before its steps (slot_obs); positions at or
// past the row's length get 0.  The bounds ask for 4 blocks an SM to 20
// states and 3 beyond (at 4, ptxas spilled from 24 states), more than a
// pass of 512 rows (128 blocks) needs to run in one wave.
template <int NS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, NS <= 20 ? 4 : 3)
    post_decode_lanes_kernel(const int32_t* __restrict__ sym,
                             const int32_t* __restrict__ lens,
                             const float* __restrict__ trans_p,
                             const float* __restrict__ em,
                             const float* __restrict__ alpha,
                             int32_t* __restrict__ path, int64_t B,
                             int64_t L, int S, int T, int V, ObsStreams st) {
  extern __shared__ float smem[];
  const int64_t TV = (int64_t)T * V;
  const int G = st.values != nullptr ? st.G : 0;
  const int64_t slot_f = slot_floats(S, T, G, S);
  float* s_em = smem;                          // log_em [S, T, V]
  st.s_coef = s_em + S * TV;                   // gaussian coefficients
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* ring = st.s_coef + coef_floats(S, st.values, st.G) +
                warp * decode_lanes_warp_floats(S, T, G);
  float* col = ring + 2 * slot_f;              // obs_p, then alpha_p b
  stage(s_em, em, S * TV);
  stage_coef(st, S);
  __syncthreads();

  const int64_t b = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;
  const bool mine = lane < S;
  const int me = mine ? lane : S - 1;
  float tr[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j)
    tr[j] = (mine && j < S) ? trans_p[(int64_t)lane * S + j] : 0.0f;
  float bv = mine ? 1.0f : 0.0f;
  const int64_t n = max((int64_t)0, min((int64_t)lens[b], L));
  const int64_t row = b * L;
  int32_t* prow = path + row;
  for (int64_t p = n + lane; p < L; p += 32) prow[p] = 0;
  // half h: positions [max(n - (h+1) kHalf, 0), n - h kHalf)
  auto lo_of = [&](int64_t r0) { return max((int64_t)0, n - r0 - kHalf); };
  stage_slot(ring, row + lo_of(0), n - lo_of(0), sym, S, T, st, alpha,
             nullptr, lane);
  stage_slot(ring + slot_f, row + lo_of(kHalf), n - kHalf - lo_of(kHalf),
             sym, S, T, st, alpha, nullptr, lane);
  for (int64_t r0 = 0; r0 < n; r0 += kHalf) {
    cp_async_wait<1>();  // this half is in; the next may be in flight
    __syncwarp();        // and every lane's words of it
    float* slot = ring + ((r0 / kHalf) & 1) * slot_f;
    const float* as = slot + kHalf * (T + 1 + G);   // alpha_p rows
    const int64_t lo = lo_of(r0);
    const int cnt = (int)(n - r0 - lo);
    slot_obs<NS>(slot, cnt, s_em, S, T, V, st, lane, col);
    __syncwarp();        // col is whole
#pragma unroll 2
    for (int k = cnt - 1; k >= 0; --k) {       // positions lo + k, down
      const float x = (mine ? col[k * S + me] : 0.0f) * bv;
      if (mine) col[k * S + lane] = as[k * S + lane] * bv;
      const float xm = fmaxf(lanes_row_max<NS>(x), 1e-37f);
      const float xn = div_rn(x, xm);
      // b <- T xn / max(max T xn, 1e-37)
      float sb = 0.0f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        sb = fmaf(tr[j], __shfl_sync(0xffffffffu, xn, j), sb);
      const float nm = fmaxf(lanes_row_max<NS>(sb), 1e-37f);
      bv = div_rn(sb, nm);
    }
    __syncwarp();        // the half's alpha_p b rows are whole
    if (lane < cnt) {
      const float* ab = col + lane * S;
      float best = -INFINITY;
      int arg = S;
      for (int j = 0; j < S; ++j) {
        if (ab[j] > best) {
          best = ab[j];
          arg = j;
        }
      }
      prow[lo + lane] = arg;
    }
    __syncwarp();        // every lane has read the slot and col: refill
    const int64_t r2 = r0 + 2 * kHalf;
    stage_slot(slot, row + lo_of(r2), n - r2 - lo_of(r2), sym, S, T, st,
               alpha, nullptr, lane);
  }
  cp_async_wait<0>();
}

// X1, every mode, either step: from each row's incoming carry [B, S] over
// obs [B, L, S], every position applying a transition.  hats [B, L, S]
// (values mode) and dm [B, L] (carry-only mode: each position's
// normalizer, 0 past the length) may be null; ckpt [B, n_ck, S], the
// carry leaving every chunk of ``chunk`` positions, is always written
// (the final carry is the one chunk of L).  Past a row's length the
// carry holds: hats repeat it and the checkpoints take it.

// One step of the lanes variant.  Lane j holds a_j (``own``), e_j =
// expf(a_j) and column j of exp(log_trans) (tc, 0 past S); lanes past S
// hold a = -inf, e = 0 and obs -inf, so every sum gains exact zeros and
// every max -inf from them.  Lane j's sum runs fmaf over i = 0..NS-1 from
// 0, its log, clamp and + obs are logdot_renorm's, and the max is exact:
// the bits are the shared step's.  Returns the normalizer.
template <int NS>
__device__ __forceinline__ float lanes_logdot_step(float& own, float& e,
                                                   const float (&tc)[NS],
                                                   float o) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < NS; ++i)
    s = fmaf(__shfl_sync(0xffffffffu, e, i), tc[i], s);
  const float l = (s > 0.0f ? logf(s) : kLogZero) + o;
  float r[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) r[i] = __shfl_sync(0xffffffffu, l, i);
  const float m = fmaxf(row_max<NS>(r), kLogZero);
  own = l - m;
  e = expf(own);
  return m;
}

template <int NS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    fwd_sweep_lanes_kernel(const float* __restrict__ obs,
                           const float* __restrict__ carry,
                           const int32_t* __restrict__ lens,
                           const float* __restrict__ trans_p,
                           float* __restrict__ hats, float* __restrict__ dm,
                           float* __restrict__ ckpt, int64_t B, int64_t L,
                           int S, int64_t chunk, int64_t n_ck) {
  extern __shared__ float smem[];  // a ring of 2 kHalf x 32 floats a warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t b = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;
  const bool mine = lane < S;
  float* ring = smem + warp * (2 * kHalf * 32) + lane;
  if (!mine)  // their obs stay -inf, so their values stay -inf
    for (int k = 0; k < 2 * kHalf; ++k) ring[k * 32] = -INFINITY;
  float tc[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i)
    tc[i] = (mine && i < S) ? trans_p[(int64_t)i * S + lane] : 0.0f;
  float own = mine ? carry[b * S + lane] : -INFINITY;
  float e = expf(own);

  const int64_t n = max((int64_t)0, min((int64_t)lens[b], L));
  const float* ob = obs + b * L * S + lane;
  // the next stores of each output, walked by pointer
  float* hb = hats != nullptr ? hats + b * L * S + lane : nullptr;
  float* db = dm != nullptr ? dm + b * L : nullptr;
  float* cb = ckpt + b * n_ck * S + lane;
  float* const cb_end = cb + n_ck * S;
  int64_t to_ck = chunk;  // steps to the next checkpoint
  stage_column(ring, ob, 0, n, S, mine);
  stage_column(ring, ob, kHalf, n, S, mine);
  for (int64_t t0 = 0; t0 < n; t0 += kHalf) {
    cp_async_wait<1>();  // this half is in; the next may be in flight
    const float* src = ring + ((t0 / kHalf) & 1) * kHalf * 32;
    const int steps = (int)min((int64_t)kHalf, n - t0);
#pragma unroll 2
    for (int k = 0; k < steps; ++k) {
      const float m = lanes_logdot_step<NS>(own, e, tc, src[k * 32]);
      if (hb != nullptr) {
        if (mine) *hb = own;
        hb += S;
      }
      if (db != nullptr) {
        if (lane == 0) *db = m;
        ++db;
      }
      if (--to_ck == 0) {
        if (mine) *cb = own;
        cb += S;
        to_ck = chunk;
      }
    }
    stage_column(ring, ob, t0 + 2 * kHalf, n, S, mine);
  }
  cp_async_wait<0>();
  if (db != nullptr && lane == 0)
    for (int64_t t = n; t < L; ++t, ++db) *db = 0.0f;
  if (!mine) return;
  if (hb != nullptr)
    for (int64_t t = n; t < L; ++t, hb += S) *hb = own;
  for (; cb < cb_end; cb += S) *cb = own;
}

// this lane's states of a row to memory
template <int SPL>
__device__ __forceinline__ void store_row(float* dst, const float (&a)[SPL],
                                          int S, int lane) {
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int j = lane + 32 * k;
    if (j < S) dst[j] = a[k];
  }
}

template <int SPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    fwd_sweep_smem_kernel(const float* __restrict__ obs,
                          const float* __restrict__ carry,
                          const int32_t* __restrict__ lens,
                          const float* __restrict__ trans_p,
                          float* __restrict__ hats, float* __restrict__ dm,
                          float* __restrict__ ckpt, int64_t B, int64_t L,
                          int S, int64_t chunk, int64_t n_ck) {
  extern __shared__ float smem[];
  float* s_trans = smem;                       // exp(log_trans) [S, S]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* s_row = s_trans + (int64_t)S * S + (int64_t)warp * S;
  stage(s_trans, trans_p, (int64_t)S * S);
  __syncthreads();

  const int64_t b = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;
  const int64_t n = max((int64_t)0, min((int64_t)lens[b], L));
  float a[SPL];
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int j = lane + 32 * k;
    if (j < S) a[k] = carry[b * S + j];
  }
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
        const float m = logdot_renorm<SPL, true>(s_row, s_trans, a,
                                                 ahead[d], S, lane, nv);
        load_obs<SPL>(ahead[d], ob, t + kAhead, n, S, lane);
#pragma unroll
        for (int k = 0; k < SPL; ++k) a[k] = nv[k];
        if (hats != nullptr) store_row<SPL>(hats + (b * L + t) * S, a, S, lane);
        if (dm != nullptr && lane == 0) dm[b * L + t] = m;
        if (t + 1 == next_ck) {
          store_row<SPL>(ckpt + (b * n_ck + ck_i) * S, a, S, lane);
          ++ck_i;
          next_ck += chunk;
        }
      }
    }
  }
  if (hats != nullptr)
    for (int64_t t = n; t < L; ++t)
      store_row<SPL>(hats + (b * L + t) * S, a, S, lane);
  if (dm != nullptr && lane == 0)
    for (int64_t t = n; t < L; ++t) dm[b * L + t] = 0.0f;
  for (; ck_i < n_ck; ++ck_i)
    store_row<SPL>(ckpt + (b * n_ck + ck_i) * S, a, S, lane);
}

// X2, every mode, either step: each row walked from its end over obs
// [B, L, S] from x_carry [B, S] (the normalized obs + beta row of the
// position after L-1), continuing [B] (0/1: the row runs past L-1) and
// lengths [B].  beta [B, L, S] (values mode) may be null; ckpt [B, n_ck,
// S] takes x at the first position of every chunk of ``chunk`` positions,
// row c the x_out of chunk c (values mode: chunk = L, one row, x_out).
// The step to beta at t, from x at t+1, is taken where t = L-1 and the
// row continues, or t < L-1 and t + 1 < len; elsewhere beta is 0 at a
// chunk's last position and carried inside a chunk.  So a row holds a
// constant beta from its end down to position len-1, and its x is formed
// at every position below the length and, past it, only at the chunks'
// first positions: the chain stops at the row's length.

// The beta step of the lanes variant.  Lane i holds row i of
// exp(log_trans) (tr, 0 past S) and e = expf(x_i) of the position after
// (0 past S); lane i's sum runs fmaf over j = 0..NS-1 from 0, then its
// log and clamp, and the max is exact: logdot_renorm<SPL, false>'s
// operations on s_transT in its order, so the bits are the shared
// step's.  Lanes past S sum 0 and take LOG_ZERO, the max's own clamp.
template <int NS>
__device__ __forceinline__ float lanes_beta_step(float e,
                                                 const float (&tr)[NS]) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < NS; ++j)
    s = fmaf(__shfl_sync(0xffffffffu, e, j), tr[j], s);
  const float l = s > 0.0f ? logf(s) : kLogZero;
  return l - fmaxf(lanes_row_max<NS>(l), kLogZero);
}

// The x step of the lanes variant: (obs + beta) renormalized to max 0
// (clamped at LOG_ZERO); lanes past S hold obs -inf, so x -inf.
template <int NS>
__device__ __forceinline__ float lanes_x_step(float o, float bv) {
  const float x = o + bv;
  return x - fmaxf(lanes_row_max<NS>(x), kLogZero);
}

template <int NS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    bwd_sweep_lanes_kernel(const float* __restrict__ obs,
                           const float* __restrict__ x_carry,
                           const int32_t* __restrict__ continuing,
                           const int32_t* __restrict__ lens,
                           const float* __restrict__ trans_p,
                           float* __restrict__ beta, float* __restrict__ ckpt,
                           int64_t B, int64_t L, int S, int64_t chunk,
                           int64_t n_ck) {
  extern __shared__ float smem[];  // a ring of 2 kHalf x 32 floats a warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t b = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;
  const bool mine = lane < S;
  float* ring = smem + warp * (2 * kHalf * 32) + lane;
  if (!mine)  // their obs stay -inf, so their x stays -inf
    for (int k = 0; k < 2 * kHalf; ++k) ring[k * 32] = -INFINITY;
  float tr[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j)
    tr[j] = (mine && j < S) ? trans_p[(int64_t)lane * S + j] : 0.0f;
  float x = mine ? x_carry[b * S + lane] : -INFINITY;
  float e = expf(x);
  float bv = 0.0f;

  const int64_t n = max((int64_t)0, min((int64_t)lens[b], L));
  const bool cont = continuing[b] != 0;
  const float* ob = obs + b * L * S + lane;
  float* bb = beta != nullptr ? beta + b * L * S + lane : nullptr;
  float* cb = ckpt + b * n_ck * S + lane;
  // positions at or past the length, from the end (warp-uniform branches)
  for (int64_t t = L - 1; t >= n; --t) {
    if (t == L - 1)
      bv = cont ? lanes_beta_step<NS>(e, tr) : 0.0f;
    else if ((t + 1) % chunk == 0)
      bv = 0.0f;
    if (bb != nullptr && mine) bb[t * S] = bv;
    if (t % chunk == 0) {
      x = lanes_x_step<NS>(mine ? ob[t * S] : -INFINITY, bv);
      if (mine) cb[t / chunk * S] = x;
    }
  }
  if (n == 0) return;
  // the chain, positions n-1 down to 0 (step r at n-1-r): at n-1 the step
  // from x_carry where n = L and the row continues, else beta 0 at a
  // chunk's last position or the carried beta; below, every step
  bool take = n == L && cont;
  if (!take && (n == L || n % chunk == 0)) bv = 0.0f;
  float* bp = bb != nullptr ? bb + (n - 1) * S : nullptr;
  float* cp = cb + (n - 1) / chunk * S;
  int64_t to_ck = (n - 1) % chunk;  // steps to the next chunk's start
  stage_column_reverse(ring, ob, 0, n, S, mine);
  stage_column_reverse(ring, ob, kHalf, n, S, mine);
  for (int64_t r0 = 0; r0 < n; r0 += kHalf) {
    cp_async_wait<1>();  // this half is in; the next may be in flight
    const float* src = ring + ((r0 / kHalf) & 1) * kHalf * 32;
    const int steps = (int)min((int64_t)kHalf, n - r0);
#pragma unroll 2
    for (int k = 0; k < steps; ++k) {
      if (take) bv = lanes_beta_step<NS>(e, tr);
      take = true;
      if (bp != nullptr) {
        if (mine) *bp = bv;
        bp -= S;
      }
      x = lanes_x_step<NS>(src[k * 32], bv);
      e = expf(x);
      if (to_ck-- == 0) {
        if (mine) *cp = x;
        cp -= S;
        to_ck = chunk - 1;
      }
    }
    stage_column_reverse(ring, ob, r0 + 2 * kHalf, n, S, mine);
  }
  cp_async_wait<0>();
}

// The x step of the shared variant: x = (obs + beta) - max(max(obs +
// beta), LOG_ZERO) for this lane's states.
template <int SPL>
__device__ __forceinline__ void x_renorm(float (&x)[SPL],
                                         const float (&o)[SPL],
                                         const float (&bv)[SPL], int S,
                                         int lane) {
  float lmax = -INFINITY;
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    if (lane + 32 * k < S) {
      x[k] = o[k] + bv[k];
      lmax = fmaxf(lmax, x[k]);
    }
  }
  const float xm = fmaxf(warp_max(lmax), kLogZero);
#pragma unroll
  for (int k = 0; k < SPL; ++k)
    if (lane + 32 * k < S) x[k] = x[k] - xm;
}

template <int SPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    bwd_sweep_smem_kernel(const float* __restrict__ obs,
                          const float* __restrict__ x_carry,
                          const int32_t* __restrict__ continuing,
                          const int32_t* __restrict__ lens,
                          const float* __restrict__ trans_p,
                          float* __restrict__ beta, float* __restrict__ ckpt,
                          int64_t B, int64_t L, int S, int64_t chunk,
                          int64_t n_ck) {
  extern __shared__ float smem[];
  float* s_transT = smem;                      // exp(log_trans).T [S, S]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* s_row = s_transT + (int64_t)S * S + (int64_t)warp * S;
  stage_transposed(s_transT, trans_p, S);
  __syncthreads();

  const int64_t b = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;
  const int64_t n = max((int64_t)0, min((int64_t)lens[b], L));
  const bool cont = continuing[b] != 0;
  float x[SPL], bv[SPL];
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int j = lane + 32 * k;
    bv[k] = 0.0f;
    if (j < S) x[k] = x_carry[b * S + j];
  }
  const float* ob = obs + b * L * S;
  // positions at or past the length, from the end (warp-uniform branches)
  for (int64_t t = L - 1; t >= n; --t) {
    if (t == L - 1 && cont) {
      logdot_renorm<SPL, false>(s_row, s_transT, x, x, S, lane, bv);
    } else if (t == L - 1 || (t + 1) % chunk == 0) {
#pragma unroll
      for (int k = 0; k < SPL; ++k) bv[k] = 0.0f;
    }
    if (beta != nullptr) store_row<SPL>(beta + (b * L + t) * S, bv, S, lane);
    if (t % chunk == 0) {
      float o[SPL];
      load_obs<SPL>(o, ob, t, L, S, lane);
      x_renorm<SPL>(x, o, bv, S, lane);
      store_row<SPL>(ckpt + (b * n_ck + t / chunk) * S, x, S, lane);
    }
  }
  if (n == 0) return;
  // the chain, as the lanes variant's
  bool take = n == L && cont;
  if (!take && (n == L || n % chunk == 0)) {
#pragma unroll
    for (int k = 0; k < SPL; ++k) bv[k] = 0.0f;
  }
  int64_t ck_i = (n - 1) / chunk, to_ck = (n - 1) % chunk;
  // slot d: the obs of step r + d, the window moved down a slot a step
  // (in registers: the moves are cheap, and the loop body stays one step,
  // unrolled twice, which read faster on an H100 than kAhead steps
  // unrolled with a slot each; PERF.md)
  float ahead[kAhead][SPL];
#pragma unroll
  for (int d = 0; d < kAhead; ++d)
    load_obs_reverse<SPL>(ahead[d], ob, d, n, S, lane);
#pragma unroll 2
  for (int64_t r = 0; r < n; ++r) {
    const int64_t t = n - 1 - r;
    if (take)
      logdot_renorm<SPL, false>(s_row, s_transT, x, x, S, lane, bv);
    take = true;
    if (beta != nullptr) store_row<SPL>(beta + (b * L + t) * S, bv, S, lane);
    x_renorm<SPL>(x, ahead[0], bv, S, lane);
#pragma unroll
    for (int d = 0; d + 1 < kAhead; ++d)
#pragma unroll
      for (int k = 0; k < SPL; ++k) ahead[d][k] = ahead[d + 1][k];
    load_obs_reverse<SPL>(ahead[kAhead - 1], ob, r + kAhead, n, S, lane);
    if (to_ck-- == 0) {
      store_row<SPL>(ckpt + (b * n_ck + ck_i) * S, x, S, lane);
      --ck_i;
      to_ck = chunk - 1;
    }
  }
}

// logdot_renorm's function and bits (each out_k the same fmaf chain over
// i = 0..S-1) with its loops interchanged: a lane's SPL chains advance
// together, one read of s_row[i] serving them all, so they overlap where
// logdot_renorm runs them one after another.  The piece-operator scan's
// step; X1's shared step and X2 keep logdot_renorm.
template <int SPL>
__device__ __forceinline__ float logdot_renorm_lanes(
    float* s_row, const float* s_m, const float (&in)[SPL], const float* add,
    int S, int lane, float (&out)[SPL]) {
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int j = lane + 32 * k;
    if (j < S) s_row[j] = expf(in[k]);
  }
  __syncwarp();
  float acc[SPL];
#pragma unroll
  for (int k = 0; k < SPL; ++k) acc[k] = 0.0f;
  const float* col = s_m + lane;
  for (int i = 0; i < S; ++i, col += S) {
    const float x = s_row[i];
#pragma unroll
    for (int k = 0; k < SPL; ++k)
      if (lane + 32 * k < S) acc[k] = fmaf(x, col[32 * k], acc[k]);
  }
  float lmax = -INFINITY;
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int j = lane + 32 * k;
    if (j < S) {
      float l = acc[k] > 0.0f ? logf(acc[k]) : kLogZero;
      if (add != nullptr) l = l + add[j];
      out[k] = l;
      lmax = fmaxf(lmax, l);
    }
  }
  const float m = fmaxf(warp_max(lmax), kLogZero);
  __syncwarp();  // every lane has read s_row and s_m for this step
#pragma unroll
  for (int k = 0; k < SPL; ++k)
    if (lane + 32 * k < S) out[k] = out[k] - m;
  return m;
}

__device__ __forceinline__ double warp_max_f64(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmax(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// X1 carry-only as a piece-operator scan, phase A: each piece's
// operator.  One warp per (row b, piece p, state i), w = (b * n_pieces +
// p) * S + i, runs X1's step (logdot_renorm_lanes) over the piece's
// positions [p * piece,
// (p + 1) * piece) from e_i (0 at i, kLogZero elsewhere), steps at or
// past the row's length not taken.  Writes probs[w, :] = exp(a) (max 1)
// and log_scale[w] = the sum of the piece's normalizers, in double.
// Pieces that start at or past the length write nothing: phase B skips
// them.
template <int SPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    fwd_piece_ops_kernel(const float* __restrict__ obs,
                         const int32_t* __restrict__ lens,
                         const float* __restrict__ trans_p,
                         float* __restrict__ probs,
                         double* __restrict__ log_scale, int64_t B,
                         int64_t L, int S, int piece, int64_t n_pieces) {
  extern __shared__ float smem[];
  float* s_trans = smem;                       // exp(log_trans) [S, S]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* s_row = s_trans + (int64_t)S * S + (int64_t)warp * S;
  stage(s_trans, trans_p, (int64_t)S * S);
  __syncthreads();

  const int64_t w = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (w >= B * n_pieces * S) return;
  const int i = (int)(w % S);
  const int64_t b = w / S / n_pieces;
  const int64_t t0 = (w / S % n_pieces) * piece;
  const int64_t end = lens[b] < L ? (int64_t)lens[b] : L;
  if (t0 >= end) return;                       // warp-uniform
  const int64_t t1 = t0 + piece < end ? t0 + piece : end;
  float a[SPL];
#pragma unroll
  for (int k = 0; k < SPL; ++k) a[k] = lane + 32 * k == i ? 0.0f : kLogZero;
  double n = 0.0;
  for (int64_t t = t0; t < t1; ++t) {
    float nv[SPL];
    const float m = logdot_renorm_lanes<SPL>(
        s_row, s_trans, a, obs + (b * L + t) * S, S, lane, nv);
#pragma unroll
    for (int k = 0; k < SPL; ++k) a[k] = nv[k];
    n += (double)m;
  }
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int j = lane + 32 * k;
    if (j < S) probs[w * S + j] = expf(a[k]);
  }
  if (lane == 0) log_scale[w] = n;
}

// Phase B: one warp (a block) per row composes the pieces in order
// behind carry_in.  Piece p takes x_i = a_i + log_scale[p, i] (double),
// c = max x, and runs X1's step on exp(x - c) with the piece's
// probability rows, staged into shared memory, as the matrix; incs[p] =
// c + the step's normalizer (double; 0 for a piece at or past the
// length, whose step is not taken).  carry_out [B, S].
template <int SPL>
__global__ void __launch_bounds__(32)
    fwd_piece_compose_kernel(const float* __restrict__ probs,
                             const double* __restrict__ log_scale,
                             const float* __restrict__ carry_in,
                             const int32_t* __restrict__ lens,
                             float* __restrict__ carry_out,
                             double* __restrict__ incs, int S, int piece,
                             int64_t n_pieces) {
  extern __shared__ float smem[];
  float* s_m = smem;                           // the piece's rows [S, S]
  float* s_row = s_m + (int64_t)S * S;
  const int lane = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t SS = (int64_t)S * S;
  const int64_t len = lens[b];
  float a[SPL];
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int j = lane + 32 * k;
    if (j < S) a[k] = carry_in[b * S + j];
  }
  for (int64_t p = 0; p < n_pieces; ++p) {
    const int64_t bp = b * n_pieces + p;
    if (p * piece >= len) {                    // warp-uniform
      if (lane == 0) incs[bp] = 0.0;
      continue;
    }
    for (int64_t e = lane; e < SS; e += 32) s_m[e] = probs[bp * SS + e];
    double x[SPL];
    double xmax = -INFINITY;
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const int j = lane + 32 * k;
      if (j < S) {
        x[k] = (double)a[k] + log_scale[bp * S + j];
        xmax = fmax(xmax, x[k]);
      }
    }
    const double c = warp_max_f64(xmax);
    float in[SPL];
#pragma unroll
    for (int k = 0; k < SPL; ++k)
      if (lane + 32 * k < S) in[k] = (float)(x[k] - c);
    __syncwarp();                              // s_m staged
    // the step ends with a __syncwarp after every lane has read s_m and
    // s_row, so the next piece may stage over them
    const float m =
        logdot_renorm_lanes<SPL>(s_row, s_m, in, nullptr, S, lane, a);
    if (lane == 0) incs[bp] = c + (double)m;
  }
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int j = lane + 32 * k;
    if (j < S) carry_out[b * S + j] = a[k];
  }
}

unsigned grid_for(int64_t B) {
  return (unsigned)((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

template <int SPL>
int launch_decode(const void* sym, const void* lens, const void* trans_p,
                  const void* em, const void* alpha, void* path, int64_t B,
                  int64_t L, int S, int T, int V, const ObsStreams& st,
                  cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)S * S + (size_t)S * T * V +
                       coef_floats(S, st.values, st.G) +
                       (size_t)kWarpsPerBlock * S);
  cudaError_t err = allow_smem(post_decode_kernel<SPL>, smem);
  if (err != cudaSuccess) return (int)err;
  post_decode_kernel<SPL><<<grid_for(B), kWarpsPerBlock * 32, smem, stream>>>(
      (const int32_t*)sym, (const int32_t*)lens, (const float*)trans_p,
      (const float*)em, (const float*)alpha, (int32_t*)path, B, L, S, T, V,
      st);
  return (int)cudaGetLastError();
}

template <int NS>
int launch_decode_lanes(const void* sym, const void* lens,
                        const void* trans_p, const void* em,
                        const void* alpha, void* path, int64_t B, int64_t L,
                        int S, int T, int V, const ObsStreams& st,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * decode_lanes_smem_floats(S, T, V, st.G);
  cudaError_t err = allow_smem(post_decode_lanes_kernel<NS>, smem);
  if (err != cudaSuccess) return (int)err;
  post_decode_lanes_kernel<NS><<<grid_for(B), kWarpsPerBlock * 32, smem,
                                 stream>>>(
      (const int32_t*)sym, (const int32_t*)lens, (const float*)trans_p,
      (const float*)em, (const float*)alpha, (int32_t*)path, B, L, S, T, V,
      st);
  return (int)cudaGetLastError();
}

size_t sweep_smem(int S) {
  return sizeof(float) * ((size_t)S * S + (size_t)kWarpsPerBlock * S);
}

struct X1Args {
  const float* obs;
  const float* carry;
  const int32_t* lens;
  const float* trans_p;
  float* hats;
  float* dm;
  float* ckpt;
  int64_t B, L;
  int S;
  int64_t chunk, n_ck;
};

X1Args x1_args(const void* obs, const void* carry, const void* lens,
               const void* trans_p, void* hats, void* dm, void* ckpt,
               int64_t B, int64_t L, int S, int64_t chunk, int64_t n_ck) {
  return X1Args{(const float*)obs, (const float*)carry,
                (const int32_t*)lens, (const float*)trans_p, (float*)hats,
                (float*)dm, (float*)ckpt, B, L, S, chunk, n_ck};
}

template <int NS>
int launch_x1_lanes(const X1Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarpsPerBlock * 2 * kHalf * 32;
  fwd_sweep_lanes_kernel<NS><<<grid_for(a.B), kWarpsPerBlock * 32, smem,
                               stream>>>(a.obs, a.carry, a.lens, a.trans_p,
                                         a.hats, a.dm, a.ckpt, a.B, a.L,
                                         a.S, a.chunk, a.n_ck);
  return (int)cudaGetLastError();
}

template <int SPL>
int launch_x1_smem(const X1Args& a, cudaStream_t stream) {
  const size_t smem = sweep_smem(a.S);
  cudaError_t err = allow_smem(fwd_sweep_smem_kernel<SPL>, smem);
  if (err != cudaSuccess) return (int)err;
  fwd_sweep_smem_kernel<SPL><<<grid_for(a.B), kWarpsPerBlock * 32, smem,
                               stream>>>(a.obs, a.carry, a.lens, a.trans_p,
                                         a.hats, a.dm, a.ckpt, a.B, a.L,
                                         a.S, a.chunk, a.n_ck);
  return (int)cudaGetLastError();
}

template <int SPL>
int launch_piece_ops(const void* obs, const void* lens, const void* trans_p,
                     void* probs, void* log_scale, int64_t B, int64_t L,
                     int S, int piece, cudaStream_t stream) {
  const int64_t n_pieces = (L + piece - 1) / piece;
  const size_t smem = sweep_smem(S);
  cudaError_t err = allow_smem(fwd_piece_ops_kernel<SPL>, smem);
  if (err != cudaSuccess) return (int)err;
  fwd_piece_ops_kernel<SPL>
      <<<grid_for(B * n_pieces * S), kWarpsPerBlock * 32, smem, stream>>>(
          (const float*)obs, (const int32_t*)lens, (const float*)trans_p,
          (float*)probs, (double*)log_scale, B, L, S, piece, n_pieces);
  return (int)cudaGetLastError();
}

template <int SPL>
int launch_piece_compose(const void* probs, const void* log_scale,
                         const void* carry_in, const void* lens,
                         void* carry_out, void* incs, int64_t B, int64_t L,
                         int S, int piece, cudaStream_t stream) {
  const int64_t n_pieces = (L + piece - 1) / piece;
  const size_t smem = sizeof(float) * ((size_t)S * S + (size_t)S);
  cudaError_t err = allow_smem(fwd_piece_compose_kernel<SPL>, smem);
  if (err != cudaSuccess) return (int)err;
  fwd_piece_compose_kernel<SPL><<<(unsigned)B, 32, smem, stream>>>(
      (const float*)probs, (const double*)log_scale, (const float*)carry_in,
      (const int32_t*)lens, (float*)carry_out, (double*)incs, S, piece,
      n_pieces);
  return (int)cudaGetLastError();
}

struct X2Args {
  const float* obs;
  const float* x_carry;
  const int32_t* continuing;
  const int32_t* lens;
  const float* trans_p;
  float* beta;
  float* ckpt;
  int64_t B, L;
  int S;
  int64_t chunk, n_ck;
};

X2Args x2_args(const void* obs, const void* x_carry, const void* continuing,
               const void* lens, const void* trans_p, void* beta, void* ckpt,
               int64_t B, int64_t L, int S, int64_t chunk, int64_t n_ck) {
  return X2Args{(const float*)obs,     (const float*)x_carry,
                (const int32_t*)continuing, (const int32_t*)lens,
                (const float*)trans_p, (float*)beta, (float*)ckpt, B, L, S,
                chunk, n_ck};
}

template <int NS>
int launch_x2_lanes(const X2Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarpsPerBlock * 2 * kHalf * 32;
  bwd_sweep_lanes_kernel<NS><<<grid_for(a.B), kWarpsPerBlock * 32, smem,
                               stream>>>(a.obs, a.x_carry, a.continuing,
                                         a.lens, a.trans_p, a.beta, a.ckpt,
                                         a.B, a.L, a.S, a.chunk, a.n_ck);
  return (int)cudaGetLastError();
}

template <int SPL>
int launch_x2_smem(const X2Args& a, cudaStream_t stream) {
  const size_t smem = sweep_smem(a.S);
  cudaError_t err = allow_smem(bwd_sweep_smem_kernel<SPL>, smem);
  if (err != cudaSuccess) return (int)err;
  bwd_sweep_smem_kernel<SPL><<<grid_for(a.B), kWarpsPerBlock * 32, smem,
                               stream>>>(a.obs, a.x_carry, a.continuing,
                                         a.lens, a.trans_p, a.beta, a.ckpt,
                                         a.B, a.L, a.S, a.chunk, a.n_ck);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// w, values and coef may be null (no segment weights / gaussian tracks).
int tehmm_post_decode(const void* sym, const void* lens, const void* trans_p,
                      const void* em, const void* alpha, void* path, int64_t B,
                      int64_t L, int S, int T, int V, const void* w,
                      const void* values, const void* coef, int G,
                      void* stream) {
  cudaStream_t cs = (cudaStream_t)stream;
  const ObsStreams st = make_streams(w, values, coef, G);
  switch (states_per_lane(S)) {
    case 1:
      return launch_decode<1>(sym, lens, trans_p, em, alpha, path, B, L, S,
                              T, V, st, cs);
    case 2:
      return launch_decode<2>(sym, lens, trans_p, em, alpha, path, B, L, S,
                              T, V, st, cs);
    case 4:
      return launch_decode<4>(sym, lens, trans_p, em, alpha, path, B, L, S,
                              T, V, st, cs);
    case 8:
      return launch_decode<8>(sym, lens, trans_p, em, alpha, path, B, L, S,
                              T, V, st, cs);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K4's decode, lanes variant (ops/cuda_kernels.k4_step picks it to 32
// states): tehmm_post_decode's arguments.
int tehmm_post_decode_lanes(const void* sym, const void* lens,
                            const void* trans_p, const void* em,
                            const void* alpha, void* path, int64_t B,
                            int64_t L, int S, int T, int V, const void* w,
                            const void* values, const void* coef, int G,
                            void* stream) {
  cudaStream_t cs = (cudaStream_t)stream;
  const ObsStreams st = make_streams(w, values, coef, G);
  // the registers of a row: S rounded up to a multiple of 4
  switch ((S + 3) / 4) {
#define K4_LANES_CASE(q)                                                  \
  case q:                                                                 \
    return launch_decode_lanes<4 * q>(sym, lens, trans_p, em, alpha, path, \
                                      B, L, S, T, V, st, cs);
    K4_LANES_CASE(1)
    K4_LANES_CASE(2)
    K4_LANES_CASE(3)
    K4_LANES_CASE(4)
    K4_LANES_CASE(5)
    K4_LANES_CASE(6)
    K4_LANES_CASE(7)
    K4_LANES_CASE(8)
#undef K4_LANES_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The shared-memory floats a block of the lanes decode takes at S states,
// T tracks of V symbols and G gaussian tracks: ops/cuda_kernels.k4_step's
// fit test is held to it.
int64_t tehmm_k4_lanes_smem_floats(int S, int T, int V, int G) {
  return decode_lanes_smem_floats(S, T, V, G);
}

// X1's sweep, either step variant (ops/cuda_kernels.x1_step picks by S):
// hats [B, L, S] and dm [B, L] may be null; ckpt [B, n_ck, S] takes the
// carry leaving every chunk of ``chunk`` positions.
int tehmm_x1_sweep_lanes(const void* obs, const void* carry, const void* lens,
                         const void* trans_p, void* hats, void* dm,
                         void* ckpt, int64_t B, int64_t L, int S,
                         int64_t chunk, int64_t n_ck, void* stream) {
  const X1Args a = x1_args(obs, carry, lens, trans_p, hats, dm, ckpt, B, L,
                           S, chunk, n_ck);
  cudaStream_t st = (cudaStream_t)stream;
  // the registers of a column and a row: S rounded up to a multiple of 4
  switch ((S + 3) / 4) {
    case 1:
      return launch_x1_lanes<4>(a, st);
    case 2:
      return launch_x1_lanes<8>(a, st);
    case 3:
      return launch_x1_lanes<12>(a, st);
    case 4:
      return launch_x1_lanes<16>(a, st);
    case 5:
      return launch_x1_lanes<20>(a, st);
    case 6:
      return launch_x1_lanes<24>(a, st);
    case 7:
      return launch_x1_lanes<28>(a, st);
    case 8:
      return launch_x1_lanes<32>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The shared step at every S to 256 (1 state a lane too: the tests force
// it at S <= 32 to hold the lanes step to it).
int tehmm_x1_sweep_smem(const void* obs, const void* carry, const void* lens,
                        const void* trans_p, void* hats, void* dm,
                        void* ckpt, int64_t B, int64_t L, int S,
                        int64_t chunk, int64_t n_ck, void* stream) {
  const X1Args a = x1_args(obs, carry, lens, trans_p, hats, dm, ckpt, B, L,
                           S, chunk, n_ck);
  cudaStream_t st = (cudaStream_t)stream;
  switch (states_per_lane(S)) {
    case 1:
      return launch_x1_smem<1>(a, st);
    case 2:
      return launch_x1_smem<2>(a, st);
    case 4:
      return launch_x1_smem<4>(a, st);
    case 8:
      return launch_x1_smem<8>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The piece-operator scan's two phases; ``piece`` is the positions a
// piece (tehmm_tpu_torch/ops/dp.py PIECE), probs f32[B, n_pieces, S, S],
// log_scale and incs f64[B, n_pieces], n_pieces = ceil(L / piece).
int tehmm_fwd_piece_ops(const void* obs, const void* lens,
                        const void* trans_p, void* probs, void* log_scale,
                        int64_t B, int64_t L, int S, int piece,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (states_per_lane(S)) {
    case 1:
      return launch_piece_ops<1>(obs, lens, trans_p, probs, log_scale, B, L,
                                 S, piece, st);
    case 2:
      return launch_piece_ops<2>(obs, lens, trans_p, probs, log_scale, B, L,
                                 S, piece, st);
    case 4:
      return launch_piece_ops<4>(obs, lens, trans_p, probs, log_scale, B, L,
                                 S, piece, st);
    case 8:
      return launch_piece_ops<8>(obs, lens, trans_p, probs, log_scale, B, L,
                                 S, piece, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int tehmm_fwd_piece_compose(const void* probs, const void* log_scale,
                            const void* carry_in, const void* lens,
                            void* carry_out, void* incs, int64_t B,
                            int64_t L, int S, int piece, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (states_per_lane(S)) {
    case 1:
      return launch_piece_compose<1>(probs, log_scale, carry_in, lens,
                                     carry_out, incs, B, L, S, piece, st);
    case 2:
      return launch_piece_compose<2>(probs, log_scale, carry_in, lens,
                                     carry_out, incs, B, L, S, piece, st);
    case 4:
      return launch_piece_compose<4>(probs, log_scale, carry_in, lens,
                                     carry_out, incs, B, L, S, piece, st);
    case 8:
      return launch_piece_compose<8>(probs, log_scale, carry_in, lens,
                                     carry_out, incs, B, L, S, piece, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// X2's sweep, either step variant (ops/cuda_kernels.x2_step picks by S):
// beta [B, L, S] may be null; ckpt [B, n_ck, S] takes x at the first
// position of every chunk of ``chunk`` positions (the values mode's
// x_out: chunk = L, n_ck = 1).
int tehmm_x2_sweep_lanes(const void* obs, const void* x_carry,
                         const void* continuing, const void* lens,
                         const void* trans_p, void* beta, void* ckpt,
                         int64_t B, int64_t L, int S, int64_t chunk,
                         int64_t n_ck, void* stream) {
  const X2Args a = x2_args(obs, x_carry, continuing, lens, trans_p, beta,
                           ckpt, B, L, S, chunk, n_ck);
  cudaStream_t st = (cudaStream_t)stream;
  // the registers of a row: S rounded up to a multiple of 4
  switch ((S + 3) / 4) {
    case 1:
      return launch_x2_lanes<4>(a, st);
    case 2:
      return launch_x2_lanes<8>(a, st);
    case 3:
      return launch_x2_lanes<12>(a, st);
    case 4:
      return launch_x2_lanes<16>(a, st);
    case 5:
      return launch_x2_lanes<20>(a, st);
    case 6:
      return launch_x2_lanes<24>(a, st);
    case 7:
      return launch_x2_lanes<28>(a, st);
    case 8:
      return launch_x2_lanes<32>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The shared step at every S to 256 (1 state a lane too: the tests force
// it at S <= 32 to hold the lanes step to it).
int tehmm_x2_sweep_smem(const void* obs, const void* x_carry,
                        const void* continuing, const void* lens,
                        const void* trans_p, void* beta, void* ckpt,
                        int64_t B, int64_t L, int S, int64_t chunk,
                        int64_t n_ck, void* stream) {
  const X2Args a = x2_args(obs, x_carry, continuing, lens, trans_p, beta,
                           ckpt, B, L, S, chunk, n_ck);
  cudaStream_t st = (cudaStream_t)stream;
  switch (states_per_lane(S)) {
    case 1:
      return launch_x2_smem<1>(a, st);
    case 2:
      return launch_x2_smem<2>(a, st);
    case 4:
      return launch_x2_smem<4>(a, st);
    case 8:
      return launch_x2_smem<8>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
