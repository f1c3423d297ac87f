// The block-tile machinery the scans over a precomputed observation
// tensor share (streaming.cu: K5, K6a, K6b; scans.cu: K7a/K8a, K7b/K8b,
// K8c; and the carry modes that run K3, X1 and X2 past their shared-memory
// envelope).  A block of kThreads threads owns R batch rows for the whole
// scan; the rows' state vectors live in shared memory, state-major.
//
//   S <= 256 (SPT = 1, "narrow"): NG = kThreads / S row groups of S
//     threads, thread (g, j) state j of the RT rows of group g (R = NG *
//     RT); as many rows of the S x S matrix as fit stay in shared memory
//     for the whole scan, the rest are read through the read-only path;
//     each output's S-term product is four interleaved partial results.
//   S > 256 (SPT = 2 or 4, "wide"): one row group, thread j states j,
//     j + 256, ... (SPT of them) of all R = RT rows of the block (2 or
//     4), so every matrix element it reads serves R rows; the matrix
//     (1 MB at S = 512, 4 MB at 1024) is staged every step through shared
//     memory in blocks of 32 rows, 16 where two slots of 32 do not fit
//     (S = 1024), with cp.async in a two-slot ring (the next block in
//     flight while one is folded; for_each_staged_block, the ring of
//     maxplus.cu's K9 B, the layout tools/exp_maxplus_s256 measured
//     fastest past 256 states, PERF.md); each output's product is four
//     interleaved partial results, as in the narrow tile, so a thread has
//     4 * SPT * R chains.
//
// Either way the order of each output's sum depends on S alone, so two
// runs, at either RT, give the same bits.  launch_scan picks SPT from S
// and RT from the occupancy API (narrow: one row a thread where the card
// holds the grid in one wave, else two; wide: two rows a block, else
// four).  streaming.cu's header gives the design and what bounds it.
// Everything is in an
// anonymous namespace: each source gets its own copy.

#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;          // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSpt = 4;             // states per thread: S <= 1024
constexpr int kWideBlk = 32;           // matrix rows a staged block
constexpr float kProbFloor = 1e-37f;

// The kernel a scan's entry launches, its last int (``tile``): the block
// tile (its staged wide form past 256 states) or the cluster tile, for all
// nine scans over obs; the lanes step or the rows kernels (scan_rows.cuh)
// for the log-space scans and their carry modes to 256 states.
// ops/cuda_kernels.py ``_TILE_FLAGS`` holds the same numbers by route.
enum ScanTile : int {
  kTileBlock = 0,
  kTileCluster = 1,
  kTileLanes = 2,
  kTileRows = 3,
};

// Sum-product in float32: K6's scaled probabilities, and the products of
// the log-space scans (scans.cu) on exp(state vector).
struct ProbOps {
  static constexpr float kCarry0 = 1.0f;  // the carry before position 0
  static constexpr float kFloor = kProbFloor;
  __device__ static float init() { return 0.0f; }
  __device__ static float step(float acc, float p, float t) {
    return fmaf(p, t, acc);
  }
  __device__ static float combine(float a, float b) {
    return __fadd_rn(a, b);
  }
  __device__ static float emit(float base, float o) {
    return __fmul_rn(base, o);
  }
  __device__ static float renorm(float u, float m) {
    return __fmul_rn(u, __fdiv_rn(1.0f, m));
  }
  __device__ static float increment(float m) { return logf(m); }
  // the state-vector entry of a log value (the log-space scans' products
  // run on exp(a); scan_cluster.cuh fill_state)
  __device__ static float from_log(float v) { return expf(v); }
};

// The RT state-vector values of one state for this thread's rows.
template <int RT>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[RT]) {
  static_assert(RT == 1 || RT == 2 || RT == 4, "1, 2 or 4 rows a thread");
  if constexpr (RT == 1) {
    v[0] = p[0];
  } else if constexpr (RT == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  } else {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
}

// Floats of a tile's shared memory before the matrix rows: the state
// vectors, the unnormalized rows, the row maxima and the lengths
// (16-byte aligned past 256 states, where cp.async fills what follows).
__host__ __device__ __forceinline__ int64_t tile_floats(int S, int R,
                                                       bool wide) {
  const int64_t n = 2 * (int64_t)S * R + 2 * R + 1;
  return wide ? (n + 3) & ~(int64_t)3 : n;
}

// A block's shared memory and this thread's place in it.
//   s_p  [S][R]   state vectors, state-major
//   s_u  [R][S]   unnormalized rows, for the max reductions
//   s_m  [R]      row maxima
//   s_len[R + 1]  row lengths, then the block's longest
//   s_T  narrow: [n_s][S] the first n_s rows of the matrix;
//        wide: [n_slots][n_s][S] the staging slots (Plan)
// A thread's cells are (q, k): state jq(q) of row row + k.
template <int SPT, int RT>
struct Tile {
  static constexpr bool kWide = SPT > 1;
  float* s_p;
  float* s_u;
  float* s_m;
  int* s_len;
  float* s_T;
  int R;         // rows of the block
  int j;         // this thread's first state
  int row;       // its first row within the block
  bool active;   // false for the threads past the last row group
  int64_t b0;    // its first batch row
  int len[RT];   // its rows' lengths (0 past the batch)
  bool live[RT]; // its rows exist in the batch
  int max_len;   // longest row of the block

  __device__ Tile(float* smem, const float* __restrict__ mat,
                  const int32_t* __restrict__ lens, int64_t B, int64_t L,
                  int S, int n_s) {
    const int NG = kWide ? 1 : kThreads / S;
    R = NG * RT;
    s_p = smem;
    s_u = s_p + S * R;
    s_m = s_u + R * S;
    s_len = reinterpret_cast<int*>(s_m + R);
    s_T = smem + tile_floats(S, R, kWide);
    const int tid = threadIdx.x;
    j = kWide ? tid : tid % S;
    const int g = kWide ? 0 : tid / S;
    active = g < NG;
    row = g * RT;
    if constexpr (!kWide) stage(s_T, mat, (int64_t)n_s * S);
    const int64_t block_row0 = (int64_t)blockIdx.x * R;
    if (tid == 0) s_len[R] = 0;
    __syncthreads();
    for (int r = tid; r < R; r += kThreads) {
      const int64_t b = block_row0 + r;
      int64_t n = b < B ? lens[b] : 0;  // clamped to [0, L]
      n = n < 0 ? 0 : (n > L ? L : n);
      s_len[r] = (int)n;
      atomicMax(&s_len[R], (int)n);
    }
    __syncthreads();
    max_len = s_len[R];
    b0 = block_row0 + row;
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      len[k] = active ? s_len[row + k] : 0;
      live[k] = active && b0 + k < B;
    }
  }

  // state of cell q, and whether this thread has it
  __device__ __forceinline__ int jq(int q) const { return j + q * kThreads; }
  __device__ __forceinline__ bool has(int q, int S) const {
    return active && (q == 0 || jq(q) < S);
  }

  // s_m[r] = max(max_j s_u[r][j], floor) for every row of the block
  // (warp w takes rows w, w + 8, ...).  Call with the whole block.
  __device__ __forceinline__ void rows_max(int S, float floor) const {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    for (int r = warp; r < R; r += kWarps) {
      float m = -INFINITY;
      for (int jj = lane; jj < S; jj += 32) m = fmaxf(m, s_u[r * S + jj]);
      m = warp_max(m);
      if (lane == 0) s_m[r] = fmaxf(m, floor);
    }
  }

  // Wide: fn(i, part, pv, tv) for every matrix row i in order, pv the RT
  // state-vector values of row i, tv[q] = M[i][jq(q)] (0 for a state past
  // S) and part = i mod 4 for i < S & ~3, else 0 (the chains of
  // ``product``); M is staged n_s rows at a time through the slots
  // (for_each_staged_block; n_s is a multiple of 4).  Call with the whole
  // block; it synchronizes.
  template <typename Fn>
  __device__ __forceinline__ void sweep_rows(const float* __restrict__ mat,
                                             int S, int n_s, int n_slots,
                                             Fn fn) const {
    const float* p = s_p + row;
    for_each_staged_block(s_T, mat, S, n_s, n_slots,
                          [&](const float* cur, int i0, int i1) {
      auto row_at = [&](int i, int part) {
        float pv[RT], tv[SPT];
        load_rows<RT>(p + i * R, pv);
#pragma unroll
        for (int q = 0; q < SPT; ++q)
          tv[q] = jq(q) < S ? cur[(i - i0) * S + jq(q)] : 0.0f;
        fn(i, part, pv, tv);
      };
      int i = i0;
      for (; i + 4 <= i1; i += 4) {
#pragma unroll
        for (int part = 0; part < 4; ++part) row_at(i + part, part);
      }
      for (; i < i1; ++i) row_at(i, 0);
    });
  }

  // acc[q][k] = (+ or max)_i op(s_p[i][row + k], M[i][jq(q)]): four
  // partial results per cell, over i = 0, 1, 2, 3 (mod 4), combined as
  // (a0 + a1) + (a2 + a3), in an order that depends on S alone (the last
  // S % 4 terms all go to a0).  Narrow: rows below n_s from shared
  // memory (n_s is a multiple of 4 unless it is S), the rest through the
  // read-only path; four independent chains a thread can overlap.  Wide:
  // the rows staged block by block (sweep_rows), 4 * SPT * RT chains.
  // Call with the active threads (narrow) or the whole block (wide).
  template <typename Ops>
  __device__ __forceinline__ void product(const float* __restrict__ mat,
                                          int S, int n_s, int n_slots,
                                          float (&acc)[SPT][RT]) const {
    if constexpr (kWide) {
      float a[SPT][RT][4];
#pragma unroll
      for (int q = 0; q < SPT; ++q)
#pragma unroll
        for (int k = 0; k < RT; ++k)
#pragma unroll
          for (int part = 0; part < 4; ++part) a[q][k][part] = Ops::init();
      sweep_rows(mat, S, n_s, n_slots, [&](int, int part,
                                           const float (&pv)[RT],
                          const float (&tv)[SPT]) {
#pragma unroll
        for (int q = 0; q < SPT; ++q)
#pragma unroll
          for (int k = 0; k < RT; ++k)
            a[q][k][part] = Ops::step(a[q][k][part], pv[k], tv[q]);
      });
#pragma unroll
      for (int q = 0; q < SPT; ++q)
#pragma unroll
        for (int k = 0; k < RT; ++k)
          acc[q][k] = Ops::combine(Ops::combine(a[q][k][0], a[q][k][1]),
                                   Ops::combine(a[q][k][2], a[q][k][3]));
    } else {
      float a[RT][4];
#pragma unroll
      for (int k = 0; k < RT; ++k)
#pragma unroll
        for (int q = 0; q < 4; ++q) a[k][q] = Ops::init();
      const float* p = s_p + row;
      const int S4 = S & ~3;
      const int n4 = n_s < S ? n_s : S4;
      // each group of four rows loads all its operands before its
      // steps, so the loads of a group are in flight together
      float tv[4], pv4[4][RT];
      for (int i = 0; i < n4; i += 4) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          tv[q] = s_T[(i + q) * S + j];
          load_rows<RT>(p + (i + q) * R, pv4[q]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int k = 0; k < RT; ++k)
            a[k][q] = Ops::step(a[k][q], pv4[q][k], tv[q]);
      }
      for (int i = n4; i < S4; i += 4) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          tv[q] = __ldg(mat + (int64_t)(i + q) * S + j);
          load_rows<RT>(p + (i + q) * R, pv4[q]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int k = 0; k < RT; ++k)
            a[k][q] = Ops::step(a[k][q], pv4[q][k], tv[q]);
      }
      float pv[RT];
      for (int i = S4; i < S; ++i) {
        const float t1 =
            i < n_s ? s_T[i * S + j] : __ldg(mat + (int64_t)i * S + j);
        load_rows<RT>(p + i * R, pv);
#pragma unroll
        for (int k = 0; k < RT; ++k) a[k][0] = Ops::step(a[k][0], pv[k], t1);
      }
#pragma unroll
      for (int k = 0; k < RT; ++k)
        acc[0][k] = Ops::combine(Ops::combine(a[k][0], a[k][1]),
                                 Ops::combine(a[k][2], a[k][3]));
    }
  }
};

// ---------------------------------------------------------------------
// host side: states and rows per thread, shared-memory split, launch
// ---------------------------------------------------------------------

struct Plan {
  int n_s;       // narrow: matrix rows kept in shared memory;
                 // wide: matrix rows per staged block
  int n_slots;   // wide: staging slots (1 or 2)
  size_t smem;   // dynamic shared memory, bytes
  int64_t grid;  // blocks
};

inline int states_per_thread(int S) {
  if (S <= kThreads) return 1;
  if (S <= 2 * kThreads) return 2;
  if (S <= kMaxSpt * kThreads) return 4;
  return 0;
}

inline Plan make_plan(int S, int64_t B, int spt, int rt) {
  const bool wide = spt > 1;
  const int R = (wide ? 1 : kThreads / S) * rt;
  const int64_t tile = tile_floats(S, R, wide);
  const int64_t room = kSmemLimit / 4 - tile;
  Plan pl;
  if (wide) {
    // blocks of kWideBlk rows, or half that where two slots of kWideBlk
    // do not fit (S = 1024): two slots keep a copy in flight
    pl.n_s = room >= 2 * (int64_t)kWideBlk * S ? kWideBlk : kWideBlk / 2;
    pl.n_slots = room >= 2 * (int64_t)pl.n_s * S ? 2 : 1;
    pl.smem = sizeof(float) *
              (size_t)(tile + (int64_t)pl.n_slots * pl.n_s * S);
  } else {
    // every matrix row, or a multiple of 4 of them (Tile::product)
    pl.n_s = room / S < S ? (int)(room / S) & ~3 : S;
    pl.n_slots = 0;
    pl.smem = sizeof(float) * (size_t)(tile + (int64_t)pl.n_s * S);
  }
  pl.grid = (B + R - 1) / R;
  return pl;
}

// Opts ``kernel`` in to its shared memory and says whether the card holds
// its whole grid at once.
template <typename Fn>
cudaError_t plan_for(Fn kernel, int S, int64_t B, int spt, int rt,
                     Plan* pl, bool* one_wave) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *pl = make_plan(S, B, spt, rt);
  err = allow_smem(kernel, pl->smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, pl->smem);
  *one_wave = pl->grid <= (int64_t)per_sm * sms;
  return err;
}

// Rows a thread takes, the two choices of launch_scan: narrow 1 or 2,
// wide (the thread's rows are the block's) 2 or 4.
inline int rows_per_thread(int spt, int choice) {
  return (spt == 1 ? 1 : 2) << choice;
}

// ks: kernel ``name``'s six instantiations, [SPT = 1, 2, 4][the rows of
// rows_per_thread].
#define TILE_KERNELS(ks, name)                                  \
  const decltype(&name<1, 1>) ks[3][2] = {{name<1, 1>, name<1, 2>}, \
                                          {name<2, 2>, name<2, 4>}, \
                                          {name<4, 2>, name<4, 4>}}

// Launches ks[SPT][choice]: SPT from S; the fewer rows where the card
// holds the grid in one wave, else the more.
template <typename Fn, typename... Args>
int launch_scan(const Fn (&ks)[3][2], int64_t B, int S, void* stream,
                Args... args) {
  const int spt = states_per_thread(S);
  if (S < 1 || spt == 0) return (int)cudaErrorInvalidValue;
  const int si = spt == 1 ? 0 : (spt == 2 ? 1 : 2);
  Plan pl;
  bool one_wave = false;
  cudaError_t err = plan_for(ks[si][0], S, B, spt, rows_per_thread(spt, 0),
                             &pl, &one_wave);
  if (err != cudaSuccess) return (int)err;
  Fn kernel = ks[si][0];
  if (!one_wave) {
    kernel = ks[si][1];
    err = plan_for(kernel, S, B, spt, rows_per_thread(spt, 1), &pl,
                   &one_wave);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)pl.grid, kThreads, pl.smem, (cudaStream_t)stream>>>(
      args..., pl.n_s, pl.n_slots);
  return (int)cudaGetLastError();
}

}  // namespace
