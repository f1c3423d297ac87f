// The cluster tile: the scans over a precomputed observation tensor past
// 256 states, with a row group's states split over the blocks of a thread
// block cluster: scans.cu's K7a/K8a and K7b/K8b, the carry modes that
// run X1 and X2 past their shared-memory envelope, and K8c;
// streaming.cu's K5, K3's carry mode, K6a and K6b.  The products are
// generic over the semiring (``Ops``: sum-product on exp(a) for the
// log-space scans and on the scaled probabilities themselves for K6,
// max-plus for the Viterbi's), and K8c's keeps the first-hit argmax beside
// every partial maximum (``product_argmax``).
//
// What held the staged tile back: one block owns 2 or 4 rows and stages
// the whole S x S matrix (4 MB at S = 1024) from L2 through its shared
// memory every step, each matrix element serving only that block's rows,
// at the 30-56 GB/s one SM stages at; the card idles wherever B / R is
// under its 132 SMs.
//
// Design.  A cluster of C = ceil(S / 64) blocks (up to 16: non-portable
// past 8) owns R rows (1, 2, 4, 8 or 12) for the whole scan.  Block c of the
// cluster owns the output states [c Sc, (c + 1) Sc), Sc = ceil(S / C)
// rounded up to 4 (<= 64), and keeps its column slice of the matrix for
// the whole scan: rows below n_res in shared memory (part-interleaved, so
// a warp's 32 reads are one wavefront), the rest up to S & ~3 in
// registers (at most cluster_reg_rows(R) a thread: 256 rows a block, what does
// not fit beside the state vector at S = 1024), the last S % 4 rows in
// shared memory.  The matrix is read from device memory once a launch.
//   Threads: warp w, lane l: column 8 w + l % 8 of the slice, part l / 8;
// a thread runs chain ``part`` (the matrix rows i = part mod 4) of its
// column for all R rows, so every matrix element it reads serves R rows;
// a quarter-warp shares its part, so its state-vector reads are
// broadcasts; the four lanes of a column combine their chains by two
// shuffles.  A thread owns the cells (its column, rows part + 4 m).
//   Every block holds the whole state vector [S][R] of its rows: exp(a)
// for the log-space scans, p for K6, the renormalized log values for
// max-plus.  A step:
// the product over the block's slice; the row max reduced across the
// cluster (warp shuffles, each block's partial stored with st.async into
// every block's shared memory, completing on that block's mbarrier, the
// max of the C partials); then each block writes its new cells (their
// exp for the sum-product) into its own part of the state vector and
// copies that part into every
// other block's with one bulk copy each (cp.async.bulk, completing on the
// receiver's mbarrier).  No cluster barrier runs inside the scan: a block
// sends the next step's partial max only after its product has read the
// state vector, and the next state vector only after every partial max
// of the step has arrived, so neither ever lands in a buffer that is still
// read.  Measured on an H100 (PERF.md, PR 17), a cluster barrier costs
// 0.6-0.7 us at 16 blocks against 0.3 us for the st.async exchange, and
// the state vector at S = 1024, R = 8 (32 KB a block) 5.6 us as stores
// against 2.0 us as bulk copies.
//
// Bits.  Each output's sum is the wide tile's (scan_tile.cuh
// Tile::product): four fmaf chains, chain p over the rows i = p mod 4 below
// S & ~3 in increasing i, chain 0 then the last S % 4 rows, combined as
// (a0 + a1) + (a2 + a3); maxima are exact in any order; expf and logf as
// they are.  K8c's argmax is the staged tile's first hit (its one chain
// in row order, strict >): each chain here visits its rows in increasing
// i with a strict >, so it keeps its lowest index, and the four chains of
// a column combine by value and then by the lower index.  So every output
// equals the staged tile's bit for bit, at any R and C.
//
// Everything is in an anonymous namespace: each source gets its own copy.

#pragma once

#include <cooperative_groups.h>

#include "scan_tile.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kClusterThreads = 256;  // threads per block
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kClusterCols = 64;      // states a block owns at most
// R, the rows a cluster: 12 takes 84 rows in the one wave of 7 clusters
// of 16 blocks an H100 holds (the S1024 bench shape's 64)
constexpr int kClusterRs = 5;
constexpr int kClusterRows[kClusterRs] = {1, 2, 4, 8, 12};
// slice rows a thread may hold in registers (one chain's): 256 a block,
// 320 at R = 12, what does not fit beside the state vector at S = 1024
__host__ __device__ constexpr int cluster_reg_rows(int R) {
  return R > 8 ? 80 : 64;
}
constexpr int kClusterBars = 3;       // mbarriers: two of maxima, one of P

// shared::cta and shared::cluster addresses, mbarriers and the two
// asynchronous stores into another block of the cluster
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// the address of the same shared location in block ``rank``
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(a), "r"(rank));
  return out;
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
// this block's one arrival of a phase, expecting ``bytes`` from stores
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}
// a 4-byte store into another block's shared memory, completing on its
// mbarrier (both shared::cluster addresses)
__device__ __forceinline__ void store_async(uint32_t dst, float v,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" :: "r"(dst), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}
// ``bytes`` (a multiple of 16) of this block's shared memory at ``src``
// into another block's at ``dst``, completing on its mbarrier
__device__ __forceinline__ void copy_async(uint32_t dst, uint32_t src,
                                           uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [%0], [%1], %2, [%3];"
      :: "r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// R state-vector values of one state: past 4 in 16-byte loads.
template <int R>
__device__ __forceinline__ void load_state(const float* p, float (&v)[R]) {
  if constexpr (R > 4) {
#pragma unroll
    for (int k = 0; k < R; k += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + k);
      v[k] = a.x;
      v[k + 1] = a.y;
      v[k + 2] = a.z;
      v[k + 3] = a.w;
    }
  } else {
    load_rows<R>(p, v);
  }
}

// The cluster's shape at S states: C blocks of Sc states each, Sc a
// multiple of 4 (a block's part of the state vector is then a whole
// number of 16-byte pieces at any R, as the bulk copies want).
__host__ __device__ __forceinline__ int cluster_blocks(int S) {
  return (S + kClusterCols - 1) / kClusterCols;
}
__host__ __device__ __forceinline__ int cluster_cols(int S) {
  const int C = cluster_blocks(S);
  return ((S + C - 1) / C + 3) & ~3;
}

// Floats of a block's shared memory besides the slice rows below n_res:
//   s_bar [kClusterBars]  mbarriers (two floats each, 8 reserved)
//   s_P   [C Sc][R]       the state vectors, block c's part from c Sc
//   s_T4  [n_res / 4][Sc][4]  slice rows i < n_res, part-interleaved
//   s_tl  [S % 4][Sc]     the last S % 4 slice rows
//   s_wm  [warps][R]      each warp's row maxima
//   s_cm  [n_max][C][R]   the cluster's partial row maxima (n_max buffers)
//   s_len [R + 1]         row lengths, then the longest
__host__ __device__ __forceinline__ int64_t cluster_fixed_floats(
    int S, int R, int n_max) {
  const int C = cluster_blocks(S), Sc = cluster_cols(S);
  return 8 + (int64_t)C * Sc * R + (int64_t)(S & 3) * Sc +
         kClusterWarps * R + (int64_t)n_max * C * R + R + 1;
}

struct ClusterPlan {
  int C;            // blocks a cluster
  int Sc;           // states a block
  int R;            // rows a cluster
  int n_res;        // slice rows in shared memory (a multiple of 4)
  int n_reg;        // slice rows in registers: n_res to S & ~3
  size_t smem;      // dynamic shared memory a block, bytes
  int64_t clusters; // clusters of the grid
  int active[kClusterRs];  // the card's active clusters at each R (0:
                          // no plan)
};

// The slice's split at S states and R rows (false: it does not fit).
inline bool cluster_split(int S, int R, int n_max, int* n_res, int* n_reg,
                          size_t* smem) {
  const int Sc = cluster_cols(S), S4 = S & ~3;
  const int64_t fixed = cluster_fixed_floats(S, R, n_max);
  const int64_t room = kSmemLimit / 4 - fixed;
  if (room < 0) return false;
  const int64_t fit = (room / Sc) & ~(int64_t)3;
  *n_res = (int)(fit < S4 ? fit : S4);
  *n_reg = S4 - *n_res;
  *smem = sizeof(float) * (size_t)(fixed + (int64_t)*n_res * Sc);
  return *n_reg <= 4 * cluster_reg_rows(R);
}

// A block's place in its cluster and in the slice, and the shared memory.
// A thread's cells are (col, own_k[m]) for m < kOwn: state gj of the
// cluster's row own_k[m] (where own_has[m]).
template <int R>
struct ClusterTile {
  static constexpr int kOwn = (R + 3) / 4;  // cells a thread owns
  static constexpr int kRegRows = cluster_reg_rows(R);
  uint64_t* s_bar;
  float* s_P;
  float* s_T4;
  float* s_tl;
  float* s_wm;
  float* s_cm;
  int* s_len;
  int S, C, Sc, rank, n_res, n_reg4;
  int warp, lane, col, part;
  int gj;          // this thread's state (its column's)
  bool has_col;    // the state exists (gj < S)
  int64_t b0;      // the cluster's first batch row
  int max_len;     // longest row of the cluster
  int own_k[kOwn];
  bool own_has[kOwn];   // the cell exists
  bool own_live[kOwn];  // its row exists in the batch
  int own_len[kOwn];    // its row's length
  float treg[kRegRows];  // slice rows n_res + 4 r + part
  uint32_t phase[kClusterBars];  // each mbarrier's phases completed

  __device__ ClusterTile(float* smem, const float* __restrict__ mat,
                         const int32_t* __restrict__ lens, int64_t B,
                         int64_t L, int S_, int n_res_, int n_max) {
    cg::cluster_group cluster = cg::this_cluster();
    S = S_;
    C = cluster_blocks(S);
    Sc = cluster_cols(S);
    rank = (int)cluster.block_rank();
    n_res = n_res_;
    const int S4 = S & ~3;
    n_reg4 = (S4 - n_res) / 4;
    s_bar = reinterpret_cast<uint64_t*>(smem);
    s_P = smem + 8;
    s_T4 = s_P + (int64_t)C * Sc * R;
    s_tl = s_T4 + (int64_t)n_res * Sc;
    s_wm = s_tl + (S & 3) * Sc;
    s_cm = s_wm + kClusterWarps * R;
    s_len = reinterpret_cast<int*>(s_cm + n_max * C * R);
    const int tid = threadIdx.x;
    warp = tid >> 5;
    lane = tid & 31;
    col = warp * 8 + (lane & 7);
    part = lane >> 3;
    gj = rank * Sc + col;
    has_col = col < Sc && gj < S;
    b0 = (int64_t)(blockIdx.x / C) * R;

    // the slice: rows below n_res and the last S % 4 from shared memory,
    // the rows between from registers
    const int j0 = rank * Sc;
    for (int64_t n = tid; n < (int64_t)n_res * Sc; n += kClusterThreads) {
      const int i = (int)(n / Sc), c = (int)(n % Sc);
      s_T4[((int64_t)(i >> 2) * Sc + c) * 4 + (i & 3)] =
          j0 + c < S ? mat[(int64_t)i * S + j0 + c] : 0.0f;
    }
    for (int n = tid; n < (S & 3) * Sc; n += kClusterThreads) {
      const int i = S4 + n / Sc, c = n % Sc;
      s_tl[n] = j0 + c < S ? mat[(int64_t)i * S + j0 + c] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kRegRows; ++r)
      treg[r] = r < n_reg4 && has_col
                    ? __ldg(mat + (int64_t)(n_res + 4 * r + part) * S + gj)
                    : 0.0f;
    if (tid == 0) {
      s_len[R] = 0;
      for (int b = 0; b < kClusterBars; ++b) mbar_init(&s_bar[b], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
#pragma unroll
    for (int b = 0; b < kClusterBars; ++b) phase[b] = 0;
    __syncthreads();
    if (tid < R) {
      const int64_t b = b0 + tid;
      int64_t n = b < B ? lens[b] : 0;  // clamped to [0, L]
      n = n < 0 ? 0 : (n > L ? L : n);
      s_len[tid] = (int)n;
      atomicMax(&s_len[R], (int)n);
    }
    __syncthreads();
    max_len = s_len[R];
#pragma unroll
    for (int m = 0; m < kOwn; ++m) {
      own_k[m] = part + 4 * m;
      const bool row = own_k[m] < R;
      own_has[m] = row && has_col;
      own_live[m] = row && b0 + own_k[m] < B;
      own_len[m] = row ? s_len[own_k[m]] : 0;
    }
    // every block of the cluster runs, its mbarriers set, before any
    // touches another's memory
    cluster.sync();
  }

  // After the scan: no block leaves while another may still address it,
  // and this block's bulk copies have read their source.
  __device__ __forceinline__ void finish() const {
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    cg::this_cluster().sync();
  }

  // Wait for mbarrier ``b``'s next phase (every thread).
  __device__ __forceinline__ void wait(int b) {
    mbar_wait(&s_bar[b], phase[b] & 1);
    ++phase[b];
  }

  // step(i, pv, tv) for every slice row i of this thread's chain in
  // increasing i: pv the R state-vector values of state i, tv M[i][gj].
  // The rows below n_res from shared memory, U a group with their loads in
  // flight together; the register rows; on part 0 the last S % 4 rows.
  template <typename Step>
  __device__ __forceinline__ void fold(Step step) const {
    const int c = has_col ? col : 0;
    const float* t = s_T4 + c * 4 + part;
    const float* p = s_P + part * R;
    const int tq = Sc * 4;  // a step of q in s_T4 (shared offsets fit int)
    const int nq = n_res / 4;
    int q = 0;
    constexpr int U = R > 8 ? 2 : 4;
    for (; q + U <= nq; q += U) {
      float tv[U], pv[U][R];
#pragma unroll
      for (int g = 0; g < U; ++g) {
        tv[g] = t[(q + g) * tq];
        load_state<R>(p + (q + g) * 4 * R, pv[g]);
      }
#pragma unroll
      for (int g = 0; g < U; ++g) step(4 * (q + g) + part, pv[g], tv[g]);
    }
    for (; q < nq; ++q) {
      float pv[R];
      const float tv = t[q * tq];
      load_state<R>(p + q * 4 * R, pv);
      step(4 * q + part, pv, tv);
    }
#pragma unroll
    for (int r = 0; r < kRegRows; ++r) {
      if (r < n_reg4) {
        float pv[R];
        load_state<R>(s_P + (n_res + 4 * r + part) * R, pv);
        step(n_res + 4 * r + part, pv, treg[r]);
      }
    }
    if (part == 0) {
      for (int i = S & ~3; i < S; ++i) {
        float pv[R];
        load_state<R>(s_P + (int64_t)i * R, pv);
        step(i, pv, s_tl[(i & 3) * Sc + c]);
      }
    }
  }

  // s[k] = sum_i s_P[i][k] M[i][gj] for every row k (Ops' semiring), in
  // the wide tile's order (four chains, combined (a0 + a1) + (a2 + a3));
  // every lane of the column gets every row's sum.  Call with the whole
  // block.
  template <typename Ops>
  __device__ __forceinline__ void product(float (&s)[R]) const {
    float a[R];
#pragma unroll
    for (int k = 0; k < R; ++k) a[k] = Ops::init();
    fold([&](int, const float (&pv)[R], float tv) {
#pragma unroll
      for (int k = 0; k < R; ++k) a[k] = Ops::step(a[k], pv[k], tv);
    });
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float x =
          Ops::combine(a[k], __shfl_xor_sync(0xffffffffu, a[k], 8));
      s[k] = Ops::combine(x, __shfl_xor_sync(0xffffffffu, x, 16));
    }
  }

  // best[k] = max_i (s_P[i][k] + M[i][gj]) for every row k and arg[k] its
  // first hit, the lowest such i (S where every term is -inf): each chain
  // keeps the lowest index of its maximum (rows in increasing i, strict
  // >), and the four chains of the column combine by value, then by the
  // lower index, which is the order's first hit whatever the pairing.
  // Every lane of the column gets both.  Call with the whole block.
  __device__ __forceinline__ void product_argmax(float (&best)[R],
                                                 int (&arg)[R]) const {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      best[k] = -INFINITY;
      arg[k] = S;
    }
    fold([&](int i, const float (&pv)[R], float tv) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float c = pv[k] + tv;
        if (c > best[k]) {
          best[k] = c;
          arg[k] = i;
        }
      }
    });
#pragma unroll
    for (int k = 0; k < R; ++k) {
#pragma unroll
      for (int off = 8; off <= 16; off *= 2) {
        const float b = __shfl_xor_sync(0xffffffffu, best[k], off);
        const int i = __shfl_xor_sync(0xffffffffu, arg[k], off);
        if (b > best[k] || (b == best[k] && i < arg[k])) {
          best[k] = b;
          arg[k] = i;
        }
      }
    }
  }

  // v[m] = s[own_k[m]]: a thread's own rows of a column's values.
  template <typename T>
  __device__ __forceinline__ void own(const T (&s)[R], T (&v)[kOwn]) const {
#pragma unroll
    for (int k = 0; k < R; ++k)
      if ((k & 3) == part) v[k >> 2] = s[k];
  }

  // m[m] = max(max over the cluster's cells of row own_k[m] of v, floor):
  // each warp's maxima, each block's stored into every block's
  // s_cm[buf] (st.async on mbarrier buf), the max of the C partials.
  // Call with every thread of the cluster.
  template <int buf>
  __device__ __forceinline__ void rows_max(const float (&v)[kOwn],
                                           float (&m)[kOwn], float floor) {
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      float x = own_has[i] ? v[i] : -INFINITY;
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
      if ((lane & 7) == 0 && own_k[i] < R) s_wm[warp * R + own_k[i]] = x;
    }
    __syncthreads();
    float* cm = s_cm + buf * C * R;
    if (threadIdx.x == 0) mbar_expect(&s_bar[buf], C * R * sizeof(float));
    if ((int)threadIdx.x < C * R) {
      const int k = threadIdx.x % R, dst = threadIdx.x / R;
      float x = -INFINITY;
#pragma unroll
      for (int w = 0; w < kClusterWarps; ++w) x = fmaxf(x, s_wm[w * R + k]);
      store_async(cluster_addr(smem_addr(cm + rank * R + k), dst), x,
                  cluster_addr(smem_addr(&s_bar[buf]), dst));
    }
    __syncthreads();  // s_wm is read before any thread may refill it
    wait(buf);
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      float x = -INFINITY;
      if (own_k[i] < R)
        for (int c = 0; c < C; ++c) x = fmaxf(x, cm[c * R + own_k[i]]);
      m[i] = fmaxf(x, floor);
    }
  }

  // Every block's s_P[gj][own_k[m]] = e[m]: this block's part of the
  // state vector written here, then copied into every other block's
  // (a bulk copy each, on mbarrier 2), and the other blocks' parts
  // awaited.  Call with the whole block.
  __device__ __forceinline__ void broadcast(const float (&e)[kOwn]) {
    constexpr int kP = kClusterBars - 1;
#pragma unroll
    for (int i = 0; i < kOwn; ++i)
      if (own_k[i] < R && col < Sc)
        s_P[(int64_t)(rank * Sc + col) * R + own_k[i]] = e[i];
    // the block's writes before the bulk copies read them
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    const uint32_t bytes = (uint32_t)(Sc * R * sizeof(float));
    if (threadIdx.x == 0) mbar_expect(&s_bar[kP], (C - 1) * bytes);
    const int dst = threadIdx.x;
    if (dst < C && dst != rank) {
      const uint32_t src = smem_addr(s_P + (int64_t)rank * Sc * R);
      copy_async(cluster_addr(src, dst), src, bytes,
                 cluster_addr(smem_addr(&s_bar[kP]), dst));
    }
    wait(kP);
  }

  // Every state of s_P from a [B, S] row of log values per cluster row,
  // as Ops' product reads them (Ops::from_log: exp for the sum-product,
  // the values themselves for max-plus; a row past the batch reads 0);
  // no exchange.  Call with the whole block; it synchronizes.
  template <typename Ops>
  __device__ __forceinline__ void fill_state(const float* __restrict__ x,
                                             int64_t B) const {
    for (int64_t n = threadIdx.x; n < (int64_t)S * R;
         n += kClusterThreads) {
      const int i = (int)(n / R), k = (int)(n % R);
      s_P[n] = Ops::from_log(b0 + k < B ? x[(b0 + k) * S + i] : 0.0f);
    }
    __syncthreads();
  }
};

// ---------------------------------------------------------------------
// host side: the plan and the launch
// ---------------------------------------------------------------------

// ks[i]: the kernel at R = kClusterRows[i].
#define CLUSTER_KERNELS(ks, name)                                     \
  const decltype(&name<1>) ks[kClusterRs] = {name<1>, name<2>, name<4>, \
                                             name<8>, name<12>}

// A launch of ``grid`` blocks in clusters of C, ``smem`` bytes a block.
inline cudaLaunchConfig_t cluster_config(int C, int64_t grid, size_t smem,
                                         void* stream,
                                         cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The card's active clusters of ``kernel`` at the plan's C and smem
// (cudaOccupancyMaxActiveClusters), after its opt-ins, which its launch
// then keeps.
template <typename Fn>
cudaError_t active_clusters(Fn kernel, int C, size_t smem, int* n) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(C, C, smem, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
}

// The plan of ``ks`` at S states and B rows: C and Sc from S; R the
// fewest rows whose clusters the card holds in one wave, else the most
// that fit (an R fits where the slice splits and one cluster is active).
// cudaErrorNotSupported where none fits.
template <typename Fn>
cudaError_t make_cluster_plan(const Fn (&ks)[kClusterRs], int S, int64_t B,
                              int n_max, ClusterPlan* pl) {
  if (S <= kThreads || S > kMaxSpt * kThreads)
    return cudaErrorInvalidValue;
  pl->C = cluster_blocks(S);
  pl->Sc = cluster_cols(S);
  pl->R = 0;
  int chosen_active = 0;
  for (int i = 0; i < kClusterRs; ++i) {
    const int R = kClusterRows[i];
    int n_res = 0, n_reg = 0;
    size_t smem = 0;
    pl->active[i] = 0;
    if (!cluster_split(S, R, n_max, &n_res, &n_reg, &smem)) continue;
    int n = 0;
    cudaError_t err = active_clusters(ks[i], pl->C, smem, &n);
    if (err != cudaSuccess) return err;
    pl->active[i] = n;
    if (n < 1) continue;
    // the first R that fits, replaced while the chosen one spills past
    // one wave
    if (pl->R == 0 || pl->clusters > chosen_active) {
      pl->R = R;
      pl->n_res = n_res;
      pl->n_reg = n_reg;
      pl->smem = smem;
      pl->clusters = (B + R - 1) / R;
      chosen_active = n;
    }
  }
  return pl->R == 0 ? cudaErrorNotSupported : cudaSuccess;
}

// The plan of ``ks`` written out as the plan entries return it: C, Sc,
// R, n_res, n_reg, smem bytes, clusters, then the active clusters at each
// R of kClusterRows (out[7 + kClusterRs]).
template <typename Fn>
int write_cluster_plan(const Fn (&ks)[kClusterRs], int S, int64_t B,
                       int n_max, int64_t* out) {
  ClusterPlan pl;
  const cudaError_t err = make_cluster_plan(ks, S, B, n_max, &pl);
  if (err != cudaSuccess) return (int)err;
  const int64_t v[7] = {pl.C, pl.Sc, pl.R, pl.n_res, pl.n_reg,
                        (int64_t)pl.smem, pl.clusters};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  for (int i = 0; i < kClusterRs; ++i) out[7 + i] = pl.active[i];
  return 0;
}

// Launches ks at the plan's R as a grid of clusters of C blocks; a
// launch the card refuses returns its error (no fallback).
template <typename Fn, typename... Args>
int launch_cluster_scan(const Fn (&ks)[kClusterRs], int64_t B, int S,
                        int n_max, void* stream, Args... args) {
  ClusterPlan pl;
  cudaError_t err = make_cluster_plan(ks, S, B, n_max, &pl);
  if (err != cudaSuccess) return (int)err;
  int i = 0;
  while (kClusterRows[i] != pl.R) ++i;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(pl.C, pl.clusters * pl.C, pl.smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, ks[i], args..., pl.n_res);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
