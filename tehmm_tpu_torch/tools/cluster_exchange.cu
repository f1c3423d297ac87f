// Measures the pieces of a step of the cluster tile (csrc/scan_cluster.cuh)
// on their own, on one card: a cluster barrier, the product loop in two
// lane layouts, and the exchange of the state vector and of the row
// maxima between the blocks of a cluster, as stores with a cluster barrier
// and as bulk copies / st.async completing on mbarriers.  These readings
// chose the tile's layout and its exchanges (PERF.md, PR 17).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/cluster_exchange tehmm_tpu_torch/tools/cluster_exchange.cu
//   ./build/cluster_exchange
//
// One JSON object a reading: what was timed, its shape, us a step (the
// kernel's time over its steps, CUDA events, the second of two launches).
// The arithmetic is the tile's shape only: the values are not checked.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>

namespace cg = cooperative_groups;

#define CHECK(x)                                                      \
  do {                                                                \
    cudaError_t e = (x);                                              \
    if (e != cudaSuccess) {                                           \
      std::fprintf(stderr, "%s at line %d\n", cudaGetErrorString(e), \
                   __LINE__);                                         \
      std::exit(1);                                                   \
    }                                                                 \
  } while (0)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, uint32_t r) {
  uint32_t o;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(o) : "r"(a),
               "r"(r));
  return o;
}
__device__ __forceinline__ void mbar_init(uint64_t* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(b))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_addr(b)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  uint32_t ok = 0;
  while (!ok)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(ok) : "r"(smem_addr(b)), "r"(parity) : "memory");
}

// a cluster barrier a step
__global__ void k_barrier(int steps, float* out) {
  cg::cluster_group cl = cg::this_cluster();
  float x = threadIdx.x;
  for (int i = 0; i < steps; ++i) {
    cl.sync();
    x += 1.0f;
  }
  if (x < 0) out[0] = x;
}

// The tile's product loop: S / 4 rows of a chain a step, a slice element
// and R state values a row.  QUADS: lane (column l / 4, part l % 4) as
// the first layout; else lane (part l / 8, column l % 8), a quarter-warp
// sharing its state-vector reads.  LOADS false: the FMAs alone.
template <int R, bool QUADS, bool LOADS>
__global__ void __launch_bounds__(256, 1)
    k_product(int S, int Sc, int steps, float* out) {
  extern __shared__ __align__(16) float sm[];
  float* P = sm;
  float* T4 = sm + S * R;
  for (int i = threadIdx.x; i < S * R + S * Sc; i += blockDim.x)
    sm[i] = 1e-3f * (i % 97);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = warp * 8 + (QUADS ? lane >> 2 : lane & 7);
  const int part = QUADS ? lane & 3 : lane >> 3;
  const float* t = T4 + col * 4 + part;
  const float* p = P + part * R;
  float acc = 0.f;
  for (int st = 0; st < steps; ++st) {
    float a[R];
#pragma unroll
    for (int k = 0; k < R; ++k) a[k] = 0.f;
    for (int q = 0; q < S / 4; q += 4) {
      float tv[4], pv[4][R];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        tv[g] = LOADS ? t[(q + g) * Sc * 4] : 1.0f + g;
#pragma unroll
        for (int k = 0; k < R; k += 4) {
          const float4 v =
              LOADS ? *reinterpret_cast<const float4*>(p + (q + g) * 4 * R + k)
                    : make_float4(0.5f, 0.25f, 0.125f, 1.0f);
          pv[g][k] = v.x;
          pv[g][k + 1] = v.y;
          pv[g][k + 2] = v.z;
          pv[g][k + 3] = v.w;
        }
      }
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int k = 0; k < R; ++k) a[k] = fmaf(pv[g][k], tv[g], a[k]);
    }
#pragma unroll
    for (int k = 0; k < R; ++k) acc += a[k];
    __syncthreads();
  }
  if (acc == 12345.f) out[0] = acc;
}

// The state vector's exchange as stores: each block writes its Sc states'
// R values into every block's state vector, then a cluster barrier.
template <int R>
__global__ void __launch_bounds__(256, 1)
    k_stores(int S, int C, int steps, float* out) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = cl.block_rank(), Sc = (S + C - 1) / C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = warp * 8 + (lane >> 2), part = lane & 3;
  const int gj = rank * Sc + col;
  cl.sync();
  for (int st = 0; st < steps; ++st) {
    if (col < Sc && gj < S)
      for (int dst = part; dst < C; dst += 4) {
        float* r = cl.map_shared_rank(sm, dst) + gj * R;
        if constexpr (R == 1) {
          r[0] = st;
        } else {
#pragma unroll
          for (int k = 0; k < R; k += 4)
            *reinterpret_cast<float4*>(r + k) = make_float4(st, k, 1, 2);
        }
      }
    cl.sync();
  }
  if (sm[0] == 12345.f) out[0] = sm[1];
}

// The same exchange as bulk copies: each block writes its part locally and
// copies it into every other block (cp.async.bulk), completing on the
// receiver's mbarrier; two buffers, since here nothing else orders steps.
__global__ void __launch_bounds__(256, 1)
    k_copies(int S, int C, int R, int steps, float* out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ __align__(8) uint64_t bar[2];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = cl.block_rank(), Sc = S / C;
  const uint32_t bytes = Sc * R * 4;
  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cl.sync();
  for (int st = 0; st < steps; ++st) {
    const int b = st & 1;
    float* mine = sm + b * S * R + rank * Sc * R;
    for (int i = threadIdx.x; i < Sc * R; i += blockDim.x) mine[i] = st + i;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) mbar_expect(&bar[b], (C - 1) * bytes);
    if ((int)threadIdx.x < C && (int)threadIdx.x != rank) {
      const uint32_t d = threadIdx.x, src = smem_addr(mine);
      asm volatile(
          "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
          "bytes [%0], [%1], %2, [%3];" ::"r"(cluster_addr(src, d)),
          "r"(src), "r"(bytes), "r"(cluster_addr(smem_addr(&bar[b]), d))
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    mbar_wait(&bar[b], (st >> 1) & 1);
  }
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  cl.sync();
  if (sm[5] == 12345.f) out[0] = sm[1];
}

// The row maxima's exchange: each block's R partials stored into every
// block with st.async, completing on the receiver's mbarrier.
__global__ void __launch_bounds__(256, 1)
    k_maxima(int C, int R, int steps, float* out) {
  __shared__ float cm[2][16 * 16];
  __shared__ __align__(8) uint64_t bar[2];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = cl.block_rank();
  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cl.sync();
  float acc = 0.f;
  for (int st = 0; st < steps; ++st) {
    const int b = st & 1;
    if (threadIdx.x == 0) mbar_expect(&bar[b], C * R * 4);
    if ((int)threadIdx.x < C * R) {
      const int k = threadIdx.x % R, d = threadIdx.x / R;
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], "
          "%1, [%2];" ::"r"(cluster_addr(smem_addr(&cm[b][rank * R + k]), d)),
          "r"(__float_as_uint((float)(st + k))),
          "r"(cluster_addr(smem_addr(&bar[b]), d))
          : "memory");
    }
    mbar_wait(&bar[b], (st >> 1) & 1);
    acc += cm[b][threadIdx.x % (C * R)];
  }
  cl.sync();
  if (acc == 12345.f) out[0] = acc;
}

template <typename K, typename... A>
double us_a_step(K kernel, int blocks, int C, size_t smem, int steps,
                 A... args) {
  CHECK(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  CHECK(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaEvent_t e0, e1;
  CHECK(cudaEventCreate(&e0));
  CHECK(cudaEventCreate(&e1));
  CHECK(cudaLaunchKernelEx(&cfg, kernel, args...));
  CHECK(cudaDeviceSynchronize());
  CHECK(cudaEventRecord(e0));
  CHECK(cudaLaunchKernelEx(&cfg, kernel, args...));
  CHECK(cudaEventRecord(e1));
  CHECK(cudaEventSynchronize(e1));
  float ms = 0.f;
  CHECK(cudaEventElapsedTime(&ms, e0, e1));
  return ms * 1e3 / steps;
}

int main() {
  float* out;
  CHECK(cudaMalloc(&out, 16));
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::printf("# device: %s\n", prop.name);
  const int n = 20000;
  for (int C : {1, 8, 16})
    for (int clusters : {1, 8})
      std::printf("{\"what\": \"cluster barrier\", \"C\": %d, \"clusters\": "
                  "%d, \"us\": %.3f}\n",
                  C, clusters,
                  us_a_step(k_barrier, C * clusters, C, 0, n, n, out));
  const int S = 512, Sc = 64, steps = 200;
  const size_t smem = 4 * (size_t)(S * 8 + S * Sc);
  const struct { const char* layout; double us; } prod[] = {
      {"column quads", us_a_step(k_product<8, true, true>, 128, 1, smem,
                                 steps, S, Sc, steps, out)},
      {"a part a quarter-warp", us_a_step(k_product<8, false, true>, 128, 1,
                                          smem, steps, S, Sc, steps, out)},
      {"no loads", us_a_step(k_product<8, false, false>, 128, 1, smem,
                             steps, S, Sc, steps, out)}};
  for (const auto& r : prod)
    std::printf("{\"what\": \"product\", \"layout\": \"%s\", \"S\": %d, "
                "\"Sc\": %d, \"R\": 8, \"blocks\": 128, \"us\": %.3f}\n",
                r.layout, S, Sc, r.us);
  const int ex = 2000;
  for (int C : {8, 16})
    for (int clusters : {1, 8}) {
      const int S2 = 64 * C;
      const double st1 =
          us_a_step(k_stores<1>, C * clusters, C, 4 * S2, ex, S2, C, ex, out);
      const double st8 = us_a_step(k_stores<8>, C * clusters, C, 32 * S2,
                                   ex, S2, C, ex, out);
      const double cp1 = us_a_step(k_copies, C * clusters, C, 8 * S2, ex, S2,
                                   C, 1, ex, out);
      const double cp8 = us_a_step(k_copies, C * clusters, C, 64 * S2, ex,
                                   S2, C, 8, ex, out);
      std::printf("{\"what\": \"state vector\", \"S\": %d, \"C\": %d, "
                  "\"clusters\": %d, \"stores_and_barrier_us\": "
                  "{\"R1\": %.3f, \"R8\": %.3f}, \"bulk_copies_us\": "
                  "{\"R1\": %.3f, \"R8\": %.3f}}\n",
                  S2, C, clusters, st1, st8, cp1, cp8);
      std::printf("{\"what\": \"row maxima by st.async\", \"C\": %d, "
                  "\"clusters\": %d, \"us\": {\"R1\": %.3f, \"R8\": %.3f}}\n",
                  C, clusters,
                  us_a_step(k_maxima, C * clusters, C, 0, ex, C, 1, ex, out),
                  us_a_step(k_maxima, C * clusters, C, 0, ex, C, 8, ex,
                            out));
    }
  return 0;
}
