// The scans' own steps to 256 states, in place of scan_tile.cuh's block
// tile there: the log-space scans (scans.cu: K7a/K8a, K7b/K8b and the
// carry modes that run X1 and X2 from 240 to 256 states), the
// probability-space scans of the E-step (streaming.cu: K6a, K6b) and the
// max-plus scans (streaming.cu: K5 and its carry mode, K3 from 240 to
// 256 states; scans.cu: K8c).
//
// What held the block tile back at these shapes (PERF.md): one
// state a thread, so every FMA loaded one matrix element and one
// state-vector element from shared memory (each matrix element serving
// one row); three block-wide barriers a step in the forward and five in
// the backward, coupling the block's unrelated rows; the row max through
// s_u with a warp walking rows in series; and at S = 256 the last 32
// matrix rows read from L2 every step.
//
//   lanes (S <= 32)  a warp a row, lane j state j: column j of the matrix
//     the kernel is handed in registers, the state vector (K7's e =
//     expf(a), K6's p itself) round the warp by S shuffles, the row max
//     exact across lanes (common.cuh lanes_row_max); obs read ahead
//     through common.cuh's ring.  No shared memory in the chain and no
//     barrier.
//   rows (33 to 256 states)  a block owns R rows (1, 2 or 4) for the
//     whole scan, 32 ceil(S / 4 / 8) threads: each thread runs one chain
//     (the matrix rows i = q mod 4) of four adjacent columns for all R
//     rows, so every float4 of the matrix it reads serves 4 R FMAs and
//     every state-vector read (a broadcast: a quarter of the warp shares
//     a chain) serves 4 R; the four lanes of a column group add their
//     chains by two shuffles, each lane keeping one column (its own
//     state) of every row.  The first 4 KR rows of the matrix (32, 64
//     or 128, by S) live in registers, the rest in shared memory, read
//     four float4 at a time with their state-vector values loaded before
//     the FMAs, so all 256 rows stay on chip.  The block is one row group,
//     so its barriers couple only its own R rows: two a step in the
//     forward (the row max's partials, then the state vector), three in
//     the backward (two maxima); a warp's partial max is one redux.sync.
//     The max-plus scans run the same chains with an add and a max a term
//     (product_max), K8c with the row that set each partial max beside it
//     (product_argmax), on state vectors of the log values themselves.
//     obs goes through a ring in shared memory, each thread copying its
//     own column kRowsHalf positions at a time with cp.async (as
//     common.cuh stage_column), two halves in flight.  R is the fewest
//     rows whose grid the card holds in one wave, else 4 (make_rows_plan):
//     while the card has room, fewer rows a block spread the rows over
//     more SMs; once it is full, more rows share each read of the matrix.
//
// Bits.  Each output's sum is the block tile's (scan_tile.cuh
// Tile::product, narrow): four fmaf chains, chain p over the rows i = p
// mod 4 below S & ~3 in increasing i, chain 0 then the last S % 4 rows in
// increasing i, combined as (a0 + a1) + (a2 + a3); terms past S are exact
// zeros added to a non-negative sum; maxima are exact in any order and
// floored as the caller's block tile floors them (LOG_ZERO in log space,
// 1e-37 for K6's probabilities); expf, logf, the LOG_ZERO clamps and
// K6's u * (1 / m) as they are.  So every output equals the block tile's
// bit for bit, at any R.  The max-plus products are exact in any order
// (each add rounds once, the max not at all); the matrix's pad columns
// (past S) are -inf and feed only the states past S, which no output or
// max reads, and no pad row is read; a pointer is the lowest row among
// equal candidates (a strict > in increasing row within a chain, the
// lower row across chains), as the block tile's.  K3's max-plus lanes step
// (common.cuh lanes_step) keeps -inf past S in the row and the matrix.
//
// Everything is in an anonymous namespace: each source gets its own copy.

#pragma once

#include "scan_tile.cuh"

namespace {

constexpr int kLanesMaxStates = 32;   // the lanes step to here
constexpr int kRowsMaxStates = 256;   // the rows kernels to here
constexpr int kRowsMaxThreads = 256;  // 32 ceil(256 / 32)
constexpr int kRowsRs = 3;            // R = 1, 2, 4 (Tile's load_rows)

// ---------------------------------------------------------------------
// the lanes step
// ---------------------------------------------------------------------

// s_j = sum_i e_i M[i][j] on lane j: mc[i] = M[i][j] (0 past S), e_i on
// lane i (0 past S), NS = S rounded up to 4.  Chain i & 3 below NS - 4;
// the last four terms in their chains where S % 4 = 0, else all in chain
// 0 (``tail``): the terms from S & ~3 are then chain 0's in increasing i,
// those past S exact zeros.
template <int NS>
__device__ __forceinline__ float lanes_product(float e, const float (&mc)[NS],
                                               bool tail) {
  static_assert(NS % 4 == 0 && NS >= 4 && NS <= 32, "S rounded up to 4");
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < NS - 4; ++i)
    c[i & 3] = fmaf(__shfl_sync(0xffffffffu, e, i), mc[i], c[i & 3]);
  float ev[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) ev[k] = __shfl_sync(0xffffffffu, e, NS - 4 + k);
  if (tail) {
#pragma unroll
    for (int k = 0; k < 4; ++k) c[0] = fmaf(ev[k], mc[NS - 4 + k], c[0]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = fmaf(ev[k], mc[NS - 4 + k], c[k]);
  }
  return __fadd_rn(__fadd_rn(c[0], c[1]), __fadd_rn(c[2], c[3]));
}

// the row's exact max over the lanes below S, floored at ``floor``
template <int NS>
__device__ __forceinline__ float lanes_max(float v, bool mine, float floor) {
  return fmaxf(lanes_row_max<NS>(mine ? v : -INFINITY), floor);
}

// ---------------------------------------------------------------------
// the rows tile
// ---------------------------------------------------------------------

constexpr int kRowsHalf = 8;     // positions of obs a thread stages at a time
constexpr int kRowsMaxWarps = 8;

// Matrix rows a thread's chain keeps in registers, KR: the rows 4 k + q
// for k < KR, 4 KR <= S & ~3 (8 from 33 states, 16 from 64, 32 from 128).
__host__ __device__ __forceinline__ int rows_reg_chain(int S) {
  const int S4 = S & ~3;
  return S4 < 64 ? 8 : (S4 < 128 ? 16 : 32);
}

__host__ __device__ __forceinline__ int rows_threads(int S) {
  return 32 * (((S + 3) / 4 + 7) / 8);
}

// Floats of a block's shared memory before the matrix rows: the state
// vectors, two buffers of the rows' partial maxima, the lengths and the
// obs ring, each rounded up to 4 (the ring and the matrix rows are read
// as float4 or staged with cp.async).
__host__ __device__ __forceinline__ int64_t rows_head_floats(int S, int R) {
  const int Sp = (S + 3) & ~3;
  const int64_t head = ((int64_t)Sp * R + 2 * R * kRowsMaxWarps + R + 3) &
                       ~(int64_t)3;
  return head + (int64_t)2 * kRowsHalf * R * rows_threads(S);
}

__host__ __device__ __forceinline__ int64_t rows_smem_floats(int S, int R,
                                                            int KR) {
  const int Sp = (S + 3) & ~3;
  return rows_head_floats(S, R) + (int64_t)(S - 4 * KR) * Sp;
}

// The exact max over a warp's lanes: the float's bits made order-
// preserving, one redux.sync (sm_80 on), back to the float.  -0 maps to
// the key below +0, NaN above +inf (the scans hold neither as a max).
__device__ __forceinline__ float warp_max_redux(float v) {
  unsigned k = __float_as_uint(v);
  k = (k & 0x80000000u) ? ~k : (k | 0x80000000u);
  k = __reduce_max_sync(0xffffffffu, k);
  k = (k & 0x80000000u) ? (k & 0x7fffffffu) : ~k;
  return __uint_as_float(k);
}

// A block's shared memory and this thread's place in it.
//   e_s   [Sp][R]               the state vectors, state-major
//   mx    [2][R][8]             the warps' partial maxima (-inf past W)
//   len   [R]                   the rows' lengths
//   ring  [2][kRowsHalf][R][nt] obs, each thread its own column
//   T_s   [S - n_reg][Sp]       matrix rows n_reg .. S-1, zeros past S
// Lane l of warp w: chain q = l / 8 of the column group g = 8 w + l % 8,
// the columns 4 gc ... 4 gc + 3 (gc = g, clamped to the last group for
// the threads past it), so the eight lanes of a quarter-warp read one
// matrix row's 128 contiguous bytes (one wavefront) and share their
// state-vector reads; own state j = 4 g + q (``has``: j < S) of the R
// rows, a warp's 32 states contiguous; tr[k][c] = M[4 k + q][4 gc + c]
// for the n_reg = 4 KR rows in registers.
template <int R, int KR>
struct RowsTile {
  float* e_s;
  float* mx;
  float* ring;
  const float* T_s;
  int S, Sp, S4, n_reg, nt;
  int j, q, gc, lane, warp;
  bool has;
  int64_t b0;   // the block's first batch row
  int len[R];
  bool live[R];
  int max_len;
  float tr[KR][4];

  __device__ RowsTile(float* smem, const float* __restrict__ mat,
                      const int32_t* __restrict__ lens, int64_t B,
                      int64_t L, int S_, float pad = 0.0f) {
    S = S_;
    Sp = (S + 3) & ~3;
    S4 = S & ~3;
    n_reg = 4 * KR;
    nt = blockDim.x;
    e_s = smem;
    mx = e_s + Sp * R;
    int* s_len = reinterpret_cast<int*>(mx + 2 * R * kRowsMaxWarps);
    ring = smem + rows_head_floats(S, R) -
           (int64_t)2 * kRowsHalf * R * nt;
    float* t_s = smem + rows_head_floats(S, R);
    T_s = t_s;
    const int tid = threadIdx.x;
    lane = tid & 31;
    warp = tid >> 5;
    q = lane >> 3;
    const int g = 8 * warp + (lane & 7);
    j = 4 * g + q;
    gc = min(g, Sp / 4 - 1);
    has = j < S;
    const int n_t = (S - n_reg) * Sp;
    for (int n = tid; n < n_t; n += nt) {
      const int i = n / Sp, c = n - i * Sp;
      t_s[n] = c < S ? mat[(int64_t)(n_reg + i) * S + c] : pad;
    }
#pragma unroll
    for (int k = 0; k < KR; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 4 * gc + c;
        tr[k][c] = col < S ? mat[(int64_t)(4 * k + q) * S + col] : pad;
      }
    for (int n = tid; n < 2 * R * kRowsMaxWarps; n += nt) mx[n] = -INFINITY;
    b0 = (int64_t)blockIdx.x * R;
    if (tid < R) {
      const int64_t b = b0 + tid;
      int64_t n = b < B ? lens[b] : 0;  // clamped to [0, L]
      s_len[tid] = (int)(n < 0 ? 0 : (n > L ? L : n));
    }
    __syncthreads();
    max_len = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      len[r] = s_len[r];
      live[r] = b0 + r < B;
      max_len = max(max_len, len[r]);
    }
  }

  // acc[c][r] += e * t[c] for the four columns and each row
  __device__ __forceinline__ static void fold(float (&acc)[4][R],
                                              const float (&t)[4],
                                              const float (&ev)[R]) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[c][r] = fmaf(ev[r], t[c], acc[c][r]);
  }

  // fn(i - q, t, ev) for every matrix row i of this thread's chain (q:
  // the rows i = q mod 4 below S & ~3, then for chain 0 the last S % 4) in
  // increasing i: t[c] = M[i][4 gc + c], ev[r] = e_s[i][r].  The rows
  // from n_reg come from shared memory, four groups a pass with their
  // operands loaded before the calls.
  template <typename Fn>
  __device__ __forceinline__ void sweep(Fn fn) const {
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      float ev[R];
      load_rows<R>(e_s + (4 * k + q) * R, ev);
      fn(4 * k, tr[k], ev);
    }
    const float* tc = T_s + q * Sp + 4 * gc;
    const float* ec = e_s + (n_reg + q) * R;
    int i0 = 0;
    for (; i0 + 16 <= S4 - n_reg; i0 += 16) {
      float t[4][4], ev[4][R];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float4 v =
            *reinterpret_cast<const float4*>(tc + (i0 + 4 * p) * Sp);
        t[p][0] = v.x;
        t[p][1] = v.y;
        t[p][2] = v.z;
        t[p][3] = v.w;
        load_rows<R>(ec + (i0 + 4 * p) * R, ev[p]);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) fn(n_reg + i0 + 4 * p, t[p], ev[p]);
    }
    for (; i0 < S4 - n_reg; i0 += 4) {
      const float4 v = *reinterpret_cast<const float4*>(tc + i0 * Sp);
      const float t[4] = {v.x, v.y, v.z, v.w};
      float ev[R];
      load_rows<R>(ec + i0 * R, ev);
      fn(n_reg + i0, t, ev);
    }
    if (q == 0) {
      for (int i = S4; i < S; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            T_s + (i - n_reg) * Sp + 4 * gc);
        const float t[4] = {v.x, v.y, v.z, v.w};
        float ev[R];
        load_rows<R>(e_s + i * R, ev);
        fn(i, t, ev);
      }
    }
  }

  // s[r] = op over the four chains of acc[.][r] at this thread's own
  // column: chains q and q ^ 1 (lanes 8 apart) combine, each lane keeping
  // the columns c & 1 = q & 1; then q and q ^ 2 (16 apart), each keeping
  // its own column c = q.  Call with the whole warp.
  template <typename Op>
  __device__ __forceinline__ void combine_chains(const float (&acc)[4][R],
                                                 float (&s)[R], Op op) const {
    const bool odd = q & 1, high = q & 2;
    float h[2][R];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float keep = odd ? acc[2 * p + 1][r] : acc[2 * p][r];
        const float send = odd ? acc[2 * p][r] : acc[2 * p + 1][r];
        h[p][r] = op(keep, __shfl_xor_sync(0xffffffffu, send, 8));
      }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float keep = high ? h[1][r] : h[0][r];
      const float send = high ? h[0][r] : h[1][r];
      s[r] = op(keep, __shfl_xor_sync(0xffffffffu, send, 16));
    }
  }

  // s[r] = sum_i e_s[i][r] M[i][j] for each row, in the block tile's order
  // (header).  Call with the whole block.
  __device__ __forceinline__ void product(float (&s)[R]) const {
    float acc[4][R];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[c][r] = 0.0f;
    sweep([&](int, const float (&t)[4], const float (&ev)[R]) {
      fold(acc, t, ev);
    });
    combine_chains(acc, s, [](float a, float b) { return __fadd_rn(a, b); });
  }

  // The max-plus product of K5 and K3's carry mode: s[r] = max_i (e_s[i][r]
  // + M[i][j]) for each row, the state vectors holding the log values v
  // themselves; each chain's partial max, then the chains' max.  Every
  // add rounds once and the max is exact, so the bits are the block
  // tile's in any order.  Call with the whole block.
  __device__ __forceinline__ void product_max(float (&s)[R]) const {
    float acc[4][R];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[c][r] = -INFINITY;
    sweep([&](int, const float (&t)[4], const float (&ev)[R]) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[c][r] = fmaxf(acc[c][r], ev[r] + t[c]);
    });
    combine_chains(acc, s, [](float a, float b) { return fmaxf(a, b); });
  }

  // (v, i) takes (w, k) where w is larger, or equal with the lower row
  __device__ __forceinline__ static void take_first(float& v, int& i, float w,
                                                    int k) {
    if (w > v || (w == v && k < i)) {
      v = w;
      i = k;
    }
  }

  // K8c's product: s[r] as product_max's and a[r] its first-hit i (the
  // lowest row on ties).  Beside each partial max a chain keeps the row
  // that set it (a strict > in increasing i, so the chain's first hit;
  // the row less q, a constant of the unrolled loop, q added after), and
  // the chains combine by value, then by the lower row, as the block
  // tile's four chains do.  The value a chain keeps is that of its first
  // hit, so s[r] is the candidate at a[r], the block tile's bits.  The
  // maxima's chain does not wait on the index's select.  Call with the
  // whole block.
  __device__ __forceinline__ void product_argmax(float (&s)[R],
                                                 int (&a)[R]) const {
    float acc[4][R];
    int arg[4][R];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[c][r] = -INFINITY;
        arg[c][r] = S - q;  // S where no candidate beats -inf
      }
    sweep([&](int i, const float (&t)[4], const float (&ev)[R]) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float x = ev[r] + t[c];
          const bool hit = x > acc[c][r];
          arg[c][r] = hit ? i : arg[c][r];
          acc[c][r] = hit ? x : acc[c][r];
        }
    });
    const bool odd = q & 1, high = q & 2;
    float h[2][R];
    int hi[2][R];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float v = odd ? acc[2 * p + 1][r] : acc[2 * p][r];
        int i = (odd ? arg[2 * p + 1][r] : arg[2 * p][r]) + q;
        const float w = __shfl_xor_sync(
            0xffffffffu, odd ? acc[2 * p][r] : acc[2 * p + 1][r], 8);
        const int k = __shfl_xor_sync(
            0xffffffffu, (odd ? arg[2 * p][r] : arg[2 * p + 1][r]) + q, 8);
        take_first(v, i, w, k);
        h[p][r] = v;
        hi[p][r] = i;
      }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float v = high ? h[1][r] : h[0][r];
      int i = high ? hi[1][r] : hi[0][r];
      const float w =
          __shfl_xor_sync(0xffffffffu, high ? h[0][r] : h[1][r], 16);
      const int k =
          __shfl_xor_sync(0xffffffffu, high ? hi[0][r] : hi[1][r], 16);
      take_first(v, i, w, k);
      s[r] = v;
      a[r] = i;
    }
  }

  // m[r] = max(max over the row's states of v[r], floor), through
  // partial buffer ``buf``.  Call with the whole block; it synchronizes.
  __device__ __forceinline__ void row_max(const float (&v)[R], float (&m)[R],
                                          int buf, float floor) const {
    float* p = mx + buf * R * kRowsMaxWarps;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float x = warp_max_redux(has ? v[r] : -INFINITY);
      if (lane == 0) p[r * kRowsMaxWarps + warp] = x;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(p + r * kRowsMaxWarps);
      const float4 b =
          *reinterpret_cast<const float4*>(p + r * kRowsMaxWarps + 4);
      const float x = fmaxf(fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w)),
                            fmaxf(fmaxf(b.x, b.y), fmaxf(b.z, b.w)));
      m[r] = fmaxf(x, floor);
    }
  }

  // this thread's state of every row into the state vectors (the caller
  // synchronizes before the next product)
  __device__ __forceinline__ void put(const float (&e)[R]) const {
    if (!has) return;
    float* p = e_s + j * R;
    if constexpr (R == 1) {
      p[0] = e[0];
    } else if constexpr (R == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(e[0], e[1]);
    } else {
      *reinterpret_cast<float4*>(p) = make_float4(e[0], e[1], e[2], e[3]);
    }
  }

  // obs of this thread's state at position p of row r (0 where not
  // ``ok``)
  __device__ __forceinline__ float obs_at(const float* __restrict__ obs,
                                          int64_t L, int r, int64_t p,
                                          bool ok) const {
    return ok ? obs[((b0 + r) * L + p) * S + j] : 0.0f;
  }

  // The obs a step reads: step s at position s (the forward) or L - s
  // (the backward, step s at t = L - 1 - s reading position t + 1), where
  // the position is below the row's length (and from 1, the backward).
  template <bool kRev>
  __device__ __forceinline__ bool obs_ok(int64_t L, int r, int64_t s,
                                         int64_t* pos) const {
    *pos = kRev ? L - s : s;
    return has && (!kRev || *pos >= 1) && *pos < len[r];
  }

  // Copy the obs of steps [s0, s0 + kRowsHalf) (below n_steps) into ring
  // half (s0 / kRowsHalf) & 1 with cp.async and commit the copy; each
  // thread copies and later reads only its own column, so no barrier.
  template <bool kRev>
  __device__ __forceinline__ void stage(const float* __restrict__ obs,
                                        int64_t L, int64_t s0,
                                        int64_t n_steps) const {
    float* dst = ring + ((s0 / kRowsHalf) & 1) * kRowsHalf * R * nt +
                 threadIdx.x;
#pragma unroll
    for (int k = 0; k < kRowsHalf; ++k)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        int64_t p;
        if (s0 + k < n_steps && obs_ok<kRev>(L, r, s0 + k, &p))
          cp_async4(dst + (k * R + r) * nt, obs + ((b0 + r) * L + p) * S + j);
      }
    cp_async_commit();
  }

  // step s's obs of each row from the ring (0 where obs_ok is not)
  template <bool kRev>
  __device__ __forceinline__ void ring_obs(int64_t L, int64_t s,
                                           float (&o)[R]) const {
    const float* src = ring + ((s / kRowsHalf) & 1) * kRowsHalf * R * nt +
                       (s % kRowsHalf) * R * nt + threadIdx.x;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      int64_t p;
      o[r] = obs_ok<kRev>(L, r, s, &p) ? src[r * nt] : 0.0f;
    }
  }
};

// ---------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------

// ks[S rounded up to 4, / 4 - 1]: the lanes kernels at NS = 4 ... 32
#define LANES_KERNELS(ks, name)                                        \
  const decltype(&name<4>) ks[kLanesMaxStates / 4] = {                 \
      name<4>, name<8>, name<12>, name<16>,                            \
      name<20>, name<24>, name<28>, name<32>}

// Launches the lanes kernel of ks at S: a warp a row, kWarpsPerBlock rows
// a block, each warp's ring of 2 kHalf x 32 floats in shared memory.
template <typename Fn, typename... Args>
int launch_lanes(const Fn (&ks)[kLanesMaxStates / 4], int64_t B, int S,
                 void* stream, Args... args) {
  if (S < 1 || S > kLanesMaxStates) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kWarpsPerBlock * 2 * kHalf * 32;
  const int64_t grid = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ks[(S + 3) / 4 - 1]<<<(unsigned)grid, kWarpsPerBlock * 32, smem,
                        (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// ks[KR index: 8, 16, 32][R index: 1, 2, 4]
#define ROWS_KERNELS(ks, name)                                         \
  const decltype(&name<1, 8>) ks[3][kRowsRs] = {                       \
      {name<1, 8>, name<2, 8>, name<4, 8>},                            \
      {name<1, 16>, name<2, 16>, name<4, 16>},                         \
      {name<1, 32>, name<2, 32>, name<4, 32>}}

// The rows kernels' plan at S states and B rows: KR by S (rows_reg_chain),
// R the fewest rows a block (1, 2 or 4) whose grid the card holds in one
// wave, else 4; per_sm[k] the blocks an SM holds at R = 1 << k, on sms
// SMs; smem the shared bytes at R.  Opts each kernel in to its shared
// memory.
struct RowsPlan {
  int R, KR, threads, sms;
  int per_sm[kRowsRs];
  size_t smem;
};

template <typename Fn>
cudaError_t make_rows_plan(const Fn (&ks)[3][kRowsRs], int64_t B, int S,
                           RowsPlan* plan) {
  if (S < kLanesMaxStates + 1 || S > kRowsMaxStates)
    return cudaErrorInvalidValue;
  plan->KR = rows_reg_chain(S);
  const Fn* row = ks[plan->KR == 8 ? 0 : (plan->KR == 16 ? 1 : 2)];
  plan->threads = rows_threads(S);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&plan->sms, cudaDevAttrMultiProcessorCount,
                               dev);
  if (err != cudaSuccess) return err;
  plan->R = 0;
  for (int k = 0; k < kRowsRs; ++k) {
    const int R = 1 << k;
    const size_t smem = sizeof(float) * (size_t)rows_smem_floats(S, R,
                                                                 plan->KR);
    err = allow_smem(row[k], smem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &plan->per_sm[k], row[k], plan->threads, smem);
    if (err != cudaSuccess) return err;
    const bool one_wave =
        (B + R - 1) / R <= (int64_t)plan->per_sm[k] * plan->sms;
    if (plan->R == 0 && (one_wave || k == kRowsRs - 1)) {
      plan->R = R;
      plan->smem = smem;
    }
  }
  return cudaSuccess;
}

// The plan of the rows kernels ks at S states and B rows into out[8]: R,
// KR, threads, SMs, the blocks an SM holds at R = 1, 2 and 4, the shared
// bytes at R.
template <typename Fn>
int write_rows_plan(const Fn (&ks)[3][kRowsRs], int64_t B, int S,
                    int64_t* out) {
  RowsPlan plan;
  const cudaError_t err = make_rows_plan(ks, B, S, &plan);
  if (err != cudaSuccess) return (int)err;
  const int64_t v[8] = {plan.R, plan.KR, plan.threads, plan.sms,
                        plan.per_sm[0], plan.per_sm[1], plan.per_sm[2],
                        (int64_t)plan.smem};
  for (int k = 0; k < 8; ++k) out[k] = v[k];
  return 0;
}

// Launches the rows kernel of ks at S on its plan (make_rows_plan).
template <typename Fn, typename... Args>
int launch_rows(const Fn (&ks)[3][kRowsRs], int64_t B, int S, void* stream,
                Args... args) {
  RowsPlan plan;
  const cudaError_t err = make_rows_plan(ks, B, S, &plan);
  if (err != cudaSuccess) return (int)err;
  const int ri = plan.R == 1 ? 0 : (plan.R == 2 ? 1 : 2);
  const int ki = plan.KR == 8 ? 0 : (plan.KR == 16 ? 1 : 2);
  ks[ki][ri]<<<(unsigned)((B + plan.R - 1) / plan.R), plan.threads,
               plan.smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace
