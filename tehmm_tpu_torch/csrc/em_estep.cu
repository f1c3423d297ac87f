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
// :2127), each in two variants chosen by the model
// (ops/cuda_kernels.k1_step):
//
//   em_fwd_lanes_kernel, em_fwd_kernel
//                        K1 forward, _make_forward_kernel_v4 (:1777)
//   em_bwd_stats_lanes_kernel, em_bwd_stats_kernel
//                        K1 reverse, _make_bwd_stats_kernel_v4 (:1931)
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
// The lanes variants (S <= 32, one state a lane) cut that step to its
// latency, as K3's, X1's and X2's lanes steps do: the transition matrix
// in registers, the row round by shuffles, no shared memory, barrier or
// global load on the chain (the symbols, the streams and, in reverse,
// alpha_p and m_raw staged a half of 32 positions ahead with cp.async,
// and a half's obs formed before its steps, a lane a position), the
// chain's divides without the float divide's slow-path branch (div_rn),
// and the reverse's emission counts left to the half's end.  They run
// the shared kernels' operations on the same values in the same order,
// so each gives the other's bits, outputs and statistics alike (the
// reverse at the same warps a block).
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

// ---------------------------------------------------------------------
// The lanes variants (S <= 32, one state a lane): the same function and
// the same bits as the kernels above at one state a lane.
//
// Each warp stages its row's streams through the lanes kernels' ring
// (common.cuh stage_slot; in the reverse kernel alpha_p rows and m_raw
// too), forms a half's obs_p from it (slot_obs) and divides by div_rn.
// ---------------------------------------------------------------------

// Floats of one warp's region of the forward: the ring and obs_p
// [kHalf][S].
__host__ __device__ __forceinline__ int64_t fwd_lanes_warp_floats(int S,
                                                                  int T,
                                                                  int G) {
  return 2 * slot_floats(S, T, G, 0) + (int64_t)kHalf * S;
}

// K1 forward, lanes variant.  Lane j holds column j of exp(log_trans) in
// registers (tc, 0 past S) and p_j; the row goes round by NS shuffles
// into lane j's fmaf chain over i = 0..NS-1 from 0 (em_fwd_kernel's
// chain: the terms past S are exact zeros), then x obs_p, the exact row
// max clamped at 1e-37 and the divide (div_rn).  A half's obs_p is formed
// before its steps, from the ring, and its dm and m_raw written after
// them, lane k position k; the row stops at its length: past it alpha_p
// holds the last row (ones for a zero-length row), dm 0 and m_raw 1,
// written after the chain.  Lanes past S hold p = 0.
template <int NS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    em_fwd_lanes_kernel(const int32_t* __restrict__ sym,
                        const int32_t* __restrict__ lens,
                        const float* __restrict__ start_p,
                        const float* __restrict__ trans_p,
                        const float* __restrict__ em,
                        float* __restrict__ alpha, float* __restrict__ dm_out,
                        float* __restrict__ mraw_out, int64_t B, int64_t L,
                        int S, int T, int V, ObsStreams st) {
  extern __shared__ float smem[];
  const int64_t TV = (int64_t)T * V;
  const int G = st.values != nullptr ? st.G : 0;
  float* s_em = smem;                          // log_em [S, T, V]
  st.s_coef = s_em + S * TV;                   // gaussian coefficients
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t slot_f = slot_floats(S, T, G, 0);
  float* ring = st.s_coef + coef_floats(S, st.values, st.G) +
                warp * fwd_lanes_warp_floats(S, T, G);
  float* col = ring + 2 * slot_f;              // obs_p [kHalf][S]
  stage(s_em, em, S * TV);
  stage_coef(st, S);
  __syncthreads();

  const int64_t b = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;
  const bool mine = lane < S;
  const int me = mine ? lane : S - 1;
  float tc[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i)
    tc[i] = (mine && i < S) ? trans_p[(int64_t)i * S + lane] : 0.0f;
  const float sp = mine ? start_p[lane] : 0.0f;
  float p = mine ? 1.0f : 0.0f;  // zero-length rows carry a row of ones

  const int64_t n = max((int64_t)0, min((int64_t)lens[b], L));
  const int64_t row = b * L;
  float* ap = alpha + row * S + lane;          // the next store, by pointer
  float m_k = 1.0f;                            // m of step ``lane``
  // one step from base (the row's product, or exp(start) at t = 0)
  auto step = [&](float base, int k) {
    const float u = base * (mine ? col[k * S + me] : 0.0f);
    const float m = fmaxf(lanes_row_max<NS>(u), 1e-37f);
    p = div_rn(u, m);
    if (mine) *ap = p;
    ap += S;
    m_k = k == lane ? m : m_k;
  };
  stage_slot(ring, row, min(n, (int64_t)kHalf), sym, S, T, st, nullptr,
             nullptr, lane);
  stage_slot(ring + slot_f, row + kHalf, min(n - kHalf, (int64_t)kHalf),
             sym, S, T, st, nullptr, nullptr, lane);
  for (int64_t t0 = 0; t0 < n; t0 += kHalf) {
    cp_async_wait<1>();  // this half is in; the next may be in flight
    __syncwarp();        // and every lane's words of it
    float* slot = ring + ((t0 / kHalf) & 1) * slot_f;
    const int cnt = (int)min((int64_t)kHalf, n - t0);
    const float o_m = slot_obs<NS>(slot, cnt, s_em, S, T, V, st, lane, col);
    __syncwarp();        // col is whole, and every lane has read the slot
    stage_slot(slot, row + t0 + 2 * kHalf,
               min(n - t0 - 2 * kHalf, (int64_t)kHalf), sym, S, T, st,
               nullptr, nullptr, lane);
    int k = 0;
    if (t0 == 0) step(sp, k++);
#pragma unroll 2
    for (; k < cnt; ++k) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < NS; ++i)
        s = fmaf(__shfl_sync(0xffffffffu, p, i), tc[i], s);
      step(s, k);
    }
    if (lane < cnt) {
      dm_out[row + t0 + lane] = logf(m_k) + o_m;
      mraw_out[row + t0 + lane] = m_k;
    }
    __syncwarp();        // every lane has read col
  }
  cp_async_wait<0>();
  // past the length: the carried row, dm 0, m_raw 1
  for (int64_t t = n + lane; t < L; t += 32) {
    dm_out[row + t] = 0.0f;
    mraw_out[row + t] = 1.0f;
  }
  for (int64_t e = (row + n) * S; e < (row + L) * S; e += 32) {
    const float h = __shfl_sync(0xffffffffu, p, (int)((e + lane) % S));
    if (e + lane < (row + L) * S) alpha[e + lane] = h;
  }
}

// Floats of one warp's region of the reverse: its statistics em [S, T, V]
// | start [S] | gaussian moments [S, 3G], then scratch: the ring and
// obs_p [kHalf][S] (each entry, once read, taking gamma w) during the
// sweep, pair [S, S] after it.
__host__ __device__ __forceinline__ int64_t bwd_lanes_stats_floats(int S,
                                                                   int T,
                                                                   int V,
                                                                   int G) {
  return (int64_t)S * T * V + S + (int64_t)S * 3 * G;
}

__host__ __device__ __forceinline__ int64_t bwd_lanes_warp_floats(int S,
                                                                  int T,
                                                                  int V,
                                                                  int G) {
  const int64_t ring = 2 * slot_floats(S, T, G, S + 1) + (int64_t)kHalf * S;
  const int64_t SS = (int64_t)S * S;
  return bwd_lanes_stats_floats(S, T, V, G) + (ring > SS ? ring : SS);
}

// K1 reverse, lanes variant.  Lane i holds row i of exp(log_trans) (tr, 0
// past S) and b_i; lane j keeps column j of pair in registers (pr).  A
// step: x = obs_p b, xm = max(max x, 1e-37) (exact), xn = x / xm; xn goes
// round by NS shuffles into lane i's fmaf chain over j = 0..NS-1 from 0
// and b <- that / max(max, 1e-37): em_bwd_stats_kernel's b step.  Beside
// it: gden by the same warp_sum, gamma, and the pair update of position
// p, which needs alpha_{p-1}: it is applied at the step of p-1 with the
// c_j = w xn_j kept from p, so each pair entry takes the same fmaf on the
// same values in the same order.  Each step stores its gamma w (lane j
// state j); at the half's end lane j adds them into row j of the
// emission counts and moments in the warp's shared memory, every entry's
// adds in the order of its positions from the last, as the shared kernel
// adds them, and the start counts take gamma at position 0.  alpha_p rows
// and m_raw come through the ring in reverse; the row starts at its last
// valid position.  At the end each warp writes pair into its scratch and
// the block sums its warps in warp order, as em_bwd_stats_kernel does.
// Its registers (a row of trans and a column of pair) would hold it to 2
// or 3 blocks an SM: the bounds ask for 4 to 20 states and 3 beyond, so
// bench.py's 2048 rows at S=20 run in one wave.
template <int NS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, NS <= 20 ? 4 : 3)
    em_bwd_stats_lanes_kernel(const int32_t* __restrict__ sym,
                              const int32_t* __restrict__ lens,
                              const float* __restrict__ trans_p,
                              const float* __restrict__ em,
                              const float* __restrict__ alpha,
                              const float* __restrict__ mraw,
                              float* __restrict__ pair_out,
                              float* __restrict__ em_out,
                              float* __restrict__ start_out,
                              float* __restrict__ gmom_out, int64_t B,
                              int64_t L, int S, int T, int V,
                              ObsStreams st) {
  extern __shared__ float smem[];
  const int64_t TV = (int64_t)T * V;
  const int64_t SS = (int64_t)S * S;
  const int G = st.values != nullptr ? st.G : 0;
  const int64_t SG3 = (int64_t)S * 3 * G;
  const int64_t stats_f = bwd_lanes_stats_floats(S, T, V, G);
  const int64_t region = bwd_lanes_warp_floats(S, T, V, G);
  const int64_t slot_f = slot_floats(S, T, G, S + 1);
  float* s_em = smem;                          // log_em [S, T, V]
  st.s_coef = s_em + S * TV;                   // gaussian coefficients
  float* s_warps = st.s_coef + SG3;            // one region per warp
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* acc_em = s_warps + warp * region;
  float* acc_start = acc_em + S * TV;
  float* acc_g = acc_start + S;
  float* ring = acc_em + stats_f;              // scratch
  float* col = ring + 2 * slot_f;              // obs_p, then gamma w

  stage(s_em, em, S * TV);
  stage_coef(st, S);
  for (int64_t e = threadIdx.x; e < warps * region; e += blockDim.x)
    s_warps[e] = 0.0f;
  __syncthreads();

  const bool mine = lane < S;
  const int me = mine ? lane : S - 1;
  float pr[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) pr[i] = 0.0f;
  const int64_t b = (int64_t)blockIdx.x * warps + warp;
  if (b < B) {
    float tr[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j)
      tr[j] = (mine && j < S) ? trans_p[(int64_t)lane * S + j] : 0.0f;
    float bv = mine ? 1.0f : 0.0f;
    float c = 0.0f;        // w xn_j of the position after, for its pair
    float g0 = 0.0f;       // gamma at position 0
    const int64_t n = max((int64_t)0, min((int64_t)lens[b], L));
    const int64_t row = b * L;
    // one step, at position lo + k of the slot; ``pair``: whether the
    // position after's pair is still due (all but the row's first step)
    auto step = [&](const float* slot, int64_t lo, int k, bool pair) {
      const float* as = slot + kHalf * (T + 1 + G);
      const float a = mine ? as[k * S + me] : 0.0f;
      const float x = (mine ? col[k * S + me] : 0.0f) * bv;
      const float ab = a * bv;
      if (pair) {                              // the pair of lo + k + 1
#pragma unroll
        for (int i = 0; i < NS; ++i)
          pr[i] = fmaf(__shfl_sync(0xffffffffu, a, i), c, pr[i]);
      }
      const float gden = fmaxf(warp_sum(ab), 1e-30f);
      const float xm = fmaxf(lanes_row_max<NS>(x), 1e-37f);
      const float xn = div_rn(x, xm);
      // b <- T xn / max(max T xn, 1e-37)
      float sb = 0.0f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        sb = fmaf(tr[j], __shfl_sync(0xffffffffu, xn, j), sb);
      const float nm = fmaxf(lanes_row_max<NS>(sb), 1e-37f);
      bv = div_rn(sb, nm);
      const float z = div_rn(as[kHalf * S + k] * gden, xm);
      const float w = 1.0f / fmaxf(z, 1e-30f);
      c = w * xn;
      // gamma, weighted by the segment weight for the emission counts
      // and moments (left to the half's end), and unweighted at position
      // 0 for the start counts
      const float gamma = div_rn(ab, gden);
      const float wp = st.w != nullptr ? slot[kHalf * T + k] : 1.0f;
      if (mine) col[k * S + lane] = st.w != nullptr ? gamma * wp : gamma;
      g0 = lo + k == 0 ? gamma : g0;
    };
    // the half's emission counts and moments, each entry's adds in the
    // order of its positions from the last, as em_bwd_stats_kernel's
    auto count = [&](const float* slot, int cnt) {
      float* er = acc_em + lane * TV;
      const int32_t* xs = reinterpret_cast<const int32_t*>(slot);
      for (int tt = 0; tt < T; ++tt)
        for (int k = cnt - 1; k >= 0; --k)
          er[tt * V + xs[k * T + tt]] += col[k * S + lane];
      for (int k = cnt - 1; k >= 0 && G > 0; --k) {
        const float gw = col[k * S + lane];
        const float* v = slot + kHalf * (T + 1) + k * G;
        float* mom = acc_g + (int64_t)lane * 3 * G;
        for (int g = 0; g < G; ++g) {
          float m, xm, x2m;
          gauss_feats(v[g], m, xm, x2m);
          mom[g] += gw * m;
          mom[G + g] += gw * xm;
          mom[2 * G + g] += gw * x2m;
        }
      }
    };
    // half h: positions [max(n - (h+1) kHalf, 0), n - h kHalf)
    auto lo_of = [&](int64_t r0) { return max((int64_t)0, n - r0 - kHalf); };
    stage_slot(ring, row + lo_of(0), n - lo_of(0), sym, S, T, st, alpha,
               mraw, lane);
    stage_slot(ring + slot_f, row + lo_of(kHalf), n - kHalf - lo_of(kHalf),
               sym, S, T, st, alpha, mraw, lane);
    for (int64_t r0 = 0; r0 < n; r0 += kHalf) {
      cp_async_wait<1>();  // this half is in; the next may be in flight
      __syncwarp();        // and every lane's words of it
      float* slot = ring + ((r0 / kHalf) & 1) * slot_f;
      const int64_t lo = lo_of(r0);
      const int cnt = (int)(n - r0 - lo);
      slot_obs<NS>(slot, cnt, s_em, S, T, V, st, lane, col);
      __syncwarp();        // col is whole
      int k = cnt - 1;     // positions lo + k, down
      if (r0 == 0) step(slot, lo, k--, false);
#pragma unroll 2
      for (; k >= 0; --k) step(slot, lo, k, true);
      if (mine) count(slot, cnt);
      __syncwarp();        // every lane has read the slot: refill it
      const int64_t r2 = r0 + 2 * kHalf;
      stage_slot(slot, row + lo_of(r2), n - r2 - lo_of(r2), sym, S, T, st,
                 alpha, mraw, lane);
    }
    cp_async_wait<0>();
    __syncwarp();          // every lane is done with the ring
    if (mine && n > 0) acc_start[lane] += g0;
  }
  if (mine)
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if (i < S) ring[(int64_t)i * S + lane] = pr[i];
  __syncthreads();

  // the block's partial: each entry summed over its warps in order
  const int64_t n_stats = SS + S * TV + S + SG3;
  const int64_t blk = blockIdx.x;
  for (int64_t e = threadIdx.x; e < n_stats; e += blockDim.x) {
    const float* src = e < SS ? s_warps + stats_f + e : s_warps + (e - SS);
    float s = 0.0f;
    for (int w = 0; w < warps; ++w) s += src[w * region];
    if (e < SS)
      pair_out[blk * SS + e] = s;
    else if (e < SS + S * TV)
      em_out[blk * S * TV + e - SS] = s;
    else if (e < SS + S * TV + S)
      start_out[blk * S + e - SS - S * TV] = s;
    else
      gmom_out[blk * SG3 + e - SS - S * TV - S] = s;
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

// The arguments of both K1 kernels, as the C entry points receive them.
struct K1Args {
  const int32_t* sym;
  const int32_t* lens;
  const float* start_p;  // forward only
  const float* trans_p;
  const float* em;
  float* alpha;          // the forward's output, the reverse's input
  float* mraw;
  float* dm;             // forward only
  float* pair_out;       // reverse only, as the three below
  float* em_out;
  float* start_out;
  float* gmom_out;
  int64_t B, L;
  int S, T, V;
  ObsStreams st;
};

// Shared-memory floats a block of the lanes kernels takes: log_em and
// the gaussian coefficients, then a region a warp (the forward's
// kWarpsPerBlock, or the reverse's ``warps``).
int64_t lanes_smem_floats(int S, int T, int V, int G, bool rev, int warps) {
  const int64_t tables = (int64_t)S * T * V + (int64_t)S * 3 * G;
  return rev ? tables + warps * bwd_lanes_warp_floats(S, T, V, G)
             : tables + kWarpsPerBlock * fwd_lanes_warp_floats(S, T, G);
}

int64_t lanes_smem_floats(const K1Args& a, bool rev, int warps) {
  return lanes_smem_floats(a.S, a.T, a.V,
                           a.st.values != nullptr ? a.st.G : 0, rev, warps);
}

template <int NS>
int launch_fwd_lanes(const K1Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * lanes_smem_floats(a, false, 0);
  cudaError_t err = allow_smem(em_fwd_lanes_kernel<NS>, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t grid = (a.B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  em_fwd_lanes_kernel<NS><<<(unsigned)grid, kWarpsPerBlock * 32, smem,
                            stream>>>(
      a.sym, a.lens, a.start_p, a.trans_p, a.em, a.alpha, a.dm, a.mraw, a.B,
      a.L, a.S, a.T, a.V, a.st);
  return (int)cudaGetLastError();
}

template <int NS>
int launch_bwd_lanes(const K1Args& a, int warps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * lanes_smem_floats(a, true, warps);
  cudaError_t err = allow_smem(em_bwd_stats_lanes_kernel<NS>, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t grid = (a.B + warps - 1) / warps;
  em_bwd_stats_lanes_kernel<NS><<<(unsigned)grid, warps * 32, smem,
                                  stream>>>(
      a.sym, a.lens, a.trans_p, a.em, a.alpha, a.mraw, a.pair_out, a.em_out,
      a.start_out, a.gmom_out, a.B, a.L, a.S, a.T, a.V, a.st);
  return (int)cudaGetLastError();
}

// Launch the lanes kernel of S states (``rev``: the reverse, with
// ``warps`` warps a block): NS, the registers of a column and a row, is S
// rounded up to a multiple of 4.
int launch_lanes(const K1Args& a, bool rev, int warps, cudaStream_t stream) {
  switch ((a.S + 3) / 4) {
#define K1_LANES_CASE(q)                                     \
  case q:                                                    \
    return rev ? launch_bwd_lanes<4 * q>(a, warps, stream)   \
               : launch_fwd_lanes<4 * q>(a, stream);
    K1_LANES_CASE(1)
    K1_LANES_CASE(2)
    K1_LANES_CASE(3)
    K1_LANES_CASE(4)
    K1_LANES_CASE(5)
    K1_LANES_CASE(6)
    K1_LANES_CASE(7)
    K1_LANES_CASE(8)
#undef K1_LANES_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
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

// The lanes variants (ops/cuda_kernels.k1_step picks them to 32 states):
// the arguments of tehmm_em_fwd and tehmm_em_bwd_stats.
int tehmm_em_fwd_lanes(const void* sym, const void* lens,
                       const void* start_p, const void* trans_p,
                       const void* em, void* alpha, void* dm, void* mraw,
                       int64_t B, int64_t L, int S, int T, int V,
                       const void* w, const void* values, const void* coef,
                       int G, void* stream) {
  K1Args a{};
  a.sym = (const int32_t*)sym;
  a.lens = (const int32_t*)lens;
  a.start_p = (const float*)start_p;
  a.trans_p = (const float*)trans_p;
  a.em = (const float*)em;
  a.alpha = (float*)alpha;
  a.dm = (float*)dm;
  a.mraw = (float*)mraw;
  a.B = B, a.L = L, a.S = S, a.T = T, a.V = V;
  a.st = make_streams(w, values, coef, G);
  return launch_lanes(a, false, kWarpsPerBlock, (cudaStream_t)stream);
}

int tehmm_em_bwd_stats_lanes(const void* sym, const void* lens,
                             const void* trans_p, const void* em,
                             const void* alpha, const void* mraw,
                             void* pair_out, void* em_out, void* start_out,
                             void* gmom_out, int64_t B, int64_t L, int S,
                             int T, int V, int warps, const void* w,
                             const void* values, const void* coef, int G,
                             void* stream) {
  if (warps != 1 && warps != 2 && warps != kWarpsPerBlock)
    return (int)cudaErrorInvalidValue;
  K1Args a{};
  a.sym = (const int32_t*)sym;
  a.lens = (const int32_t*)lens;
  a.trans_p = (const float*)trans_p;
  a.em = (const float*)em;
  a.alpha = (float*)alpha;  // read only
  a.mraw = (float*)mraw;
  a.pair_out = (float*)pair_out;
  a.em_out = (float*)em_out;
  a.start_out = (float*)start_out;
  a.gmom_out = (float*)gmom_out;
  a.B = B, a.L = L, a.S = S, a.T = T, a.V = V;
  a.st = make_streams(w, values, coef, G);
  return launch_lanes(a, true, warps, (cudaStream_t)stream);
}

// The shared-memory floats a block of the lanes forward (rev 0, at its
// own warps) or reverse (rev 1, at ``warps`` a block) takes at S states,
// T tracks of V symbols and G gaussian tracks: ops/cuda_kernels.k1_step's
// fit test is held to it.
int64_t tehmm_k1_lanes_smem_floats(int S, int T, int V, int G, int rev,
                                   int warps) {
  return lanes_smem_floats(S, T, V, G, rev != 0, warps);
}

}  // extern "C"
