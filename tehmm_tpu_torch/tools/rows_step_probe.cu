// Splits a step of the forward rows kernel (csrc/scans.cu
// fwd_scaled_rows_kernel, csrc/scan_rows.cuh) into its phases with clock64
// marks, at the bench shapes S64 (1024 rows), S128 (512) and S256 (256),
// L = 1024, with the launcher's rows a block (make_rows_plan): reading obs
// from the ring, the product, the log, the row max (its barrier
// included), exp and the stores, and putting the state vector (with the
// step's second barrier).  A second reading skips the product, to show
// what the rest of the step costs alone.  The step is the kernel's, with
// the marks between its phases; the marks themselves cost a few cycles.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/rows_step_probe tehmm_tpu_torch/tools/rows_step_probe.cu
//   ./build/rows_step_probe
//
// One JSON object a reading: the shape, R, whether the product ran, us a
// step (the kernel's time over L, CUDA events, the second of two
// launches) and each phase's cycles a step on thread 0 of block 0 (the
// ring's refills fall between steps: ``step`` is the whole loop's
// cycles over its steps).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>

#include "../csrc/scan_rows.cuh"

#define CHECK(x)                                                      \
  do {                                                                \
    cudaError_t e = (x);                                              \
    if (e != cudaSuccess) {                                           \
      std::fprintf(stderr, "%s at line %d\n", cudaGetErrorString(e), \
                   __LINE__);                                         \
      std::exit(1);                                                   \
    }                                                                 \
  } while (0)

constexpr int kPhases = 7;  // obs, product, log, max, exp, put, step
const char* const kPhaseNames[kPhases] = {
    "obs", "product", "log", "max", "exp_store", "put_barrier", "step"};

template <int R, int KR>
__global__ void __launch_bounds__(kRowsMaxThreads)
    probe_fwd_rows(const float* __restrict__ obs,
                   const int32_t* __restrict__ lens,
                   const float* __restrict__ log_start,
                   const float* __restrict__ trans_p,
                   float* __restrict__ alpha_out, float* __restrict__ dm_out,
                   int64_t B, int64_t L, int S, int skip_product,
                   long long* __restrict__ phases) {
  extern __shared__ __align__(16) float smem[];
  RowsTile<R, KR> tl(smem, trans_p, lens, B, L, S);
  const bool has = tl.has;
  const int j = tl.j;
  const float start_j = has ? log_start[j] : 0.0f;
  float a[R], e[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    a[r] = 0.0f;
    e[r] = 1.0f;
  }
  long long ph[kPhases - 1] = {0, 0, 0, 0, 0, 0};
  const int64_t steps = max(tl.max_len, 1);
  tl.template stage<false>(obs, L, 0, steps);
  tl.template stage<false>(obs, L, kRowsHalf, steps);
  __syncthreads();
  const long long begin = clock64();
  for (int64_t t0 = 0; t0 < steps; t0 += kRowsHalf) {
    cp_async_wait<1>();
    const int n = (int)min((int64_t)kRowsHalf, steps - t0);
    for (int k = 0; k < n; ++k) {
      const int64_t t = t0 + k;
      const long long c0 = clock64();
      float o[R], u[R], m[R], s[R];
      tl.template ring_obs<false>(L, t, o);
      const long long c1 = clock64();
      if (t == 0 || skip_product) {
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] = e[r] + 0.5f;
      } else {
        tl.product(s);
      }
      const long long c2 = clock64();
#pragma unroll
      for (int r = 0; r < R; ++r)
        u[r] = t == 0 ? (tl.len[r] > 0 ? start_j + o[r] : kLogZero)
                      : (s[r] > 0.0f ? logf(s[r]) : kLogZero) + o[r];
      const long long c3 = clock64();
      tl.row_max(u, m, 0);
      const long long c4 = clock64();
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool valid = t == 0 || t < tl.len[r];
        if (valid) a[r] = u[r] - m[r];
        e[r] = expf(a[r]);
        if (!tl.live[r]) continue;
        const int64_t pos = (tl.b0 + r) * L + t;
        if (has) alpha_out[pos * S + j] = a[r];
        if (j == 0) dm_out[pos] = valid ? m[r] : 0.0f;
      }
      const long long c5 = clock64();
      tl.put(e);
      __syncthreads();
      const long long c6 = clock64();
      ph[0] += c1 - c0;
      ph[1] += c2 - c1;
      ph[2] += c3 - c2;
      ph[3] += c4 - c3;
      ph[4] += c5 - c4;
      ph[5] += c6 - c5;
    }
    tl.template stage<false>(obs, L, t0 + 2 * kRowsHalf, steps);
  }
  cp_async_wait<0>();
  const long long total = clock64() - begin;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int p = 0; p < kPhases - 1; ++p) phases[p] = ph[p] / steps;
    phases[kPhases - 1] = total / steps;
  }
}

int main() {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::printf("# device: %s\n", prop.name);
  const int64_t L = 1024;
  const struct {
    int S;
    int64_t B;
  } shapes[] = {{64, 1024}, {128, 512}, {256, 256}};
  ROWS_KERNELS(ks, probe_fwd_rows);
  std::mt19937 gen(0);
  std::uniform_real_distribution<float> U(0.0f, 1.0f);
  for (const auto& sh : shapes) {
    const int S = sh.S;
    const int64_t B = sh.B;
    std::vector<float> obs((size_t)(B * L * S)), tp((size_t)S * S), ls(S);
    for (auto& x : obs) x = -3.0f * U(gen);
    for (int i = 0; i < S; ++i) {
      float sum = 0.0f;
      for (int c = 0; c < S; ++c) sum += (tp[(size_t)i * S + c] = U(gen) + 0.01f);
      for (int c = 0; c < S; ++c) tp[(size_t)i * S + c] /= sum;
      ls[i] = -std::log((float)S);
    }
    std::vector<int32_t> lens((size_t)B, (int32_t)L);
    float *d_obs, *d_tp, *d_ls, *d_a, *d_dm;
    int32_t* d_lens;
    long long* d_ph;
    CHECK(cudaMalloc(&d_obs, obs.size() * 4));
    CHECK(cudaMalloc(&d_a, obs.size() * 4));
    CHECK(cudaMalloc(&d_tp, tp.size() * 4));
    CHECK(cudaMalloc(&d_ls, ls.size() * 4));
    CHECK(cudaMalloc(&d_dm, (size_t)(B * L) * 4));
    CHECK(cudaMalloc(&d_lens, lens.size() * 4));
    CHECK(cudaMalloc(&d_ph, kPhases * sizeof(long long)));
    CHECK(cudaMemcpy(d_obs, obs.data(), obs.size() * 4,
                     cudaMemcpyHostToDevice));
    CHECK(cudaMemcpy(d_tp, tp.data(), tp.size() * 4, cudaMemcpyHostToDevice));
    CHECK(cudaMemcpy(d_ls, ls.data(), ls.size() * 4, cudaMemcpyHostToDevice));
    CHECK(cudaMemcpy(d_lens, lens.data(), lens.size() * 4,
                     cudaMemcpyHostToDevice));
    RowsPlan plan;
    CHECK(make_rows_plan(ks, B, S, &plan));
    const int ri = plan.R == 1 ? 0 : (plan.R == 2 ? 1 : 2);
    const int ki = plan.KR == 8 ? 0 : (plan.KR == 16 ? 1 : 2);
    const auto kernel = ks[ki][ri];
    const unsigned grid = (unsigned)((B + plan.R - 1) / plan.R);
    cudaEvent_t e0, e1;
    CHECK(cudaEventCreate(&e0));
    CHECK(cudaEventCreate(&e1));
    for (int skip = 0; skip < 2; ++skip) {
      float ms = 0.0f;
      for (int rep = 0; rep < 2; ++rep) {
        CHECK(cudaEventRecord(e0));
        kernel<<<grid, plan.threads, plan.smem>>>(d_obs, d_lens, d_ls, d_tp,
                                                  d_a, d_dm, B, L, S, skip,
                                                  d_ph);
        CHECK(cudaGetLastError());
        CHECK(cudaEventRecord(e1));
        CHECK(cudaEventSynchronize(e1));
        CHECK(cudaEventElapsedTime(&ms, e0, e1));
      }
      long long ph[kPhases];
      CHECK(cudaMemcpy(ph, d_ph, sizeof(ph), cudaMemcpyDeviceToHost));
      std::printf("{\"S\": %d, \"B\": %lld, \"L\": %lld, \"R\": %d, "
                  "\"product\": %s, \"us_a_step\": %.3f, \"cycles\": {",
                  S, (long long)B, (long long)L, plan.R,
                  skip ? "false" : "true", ms * 1e3 / L);
      for (int p = 0; p < kPhases; ++p)
        std::printf("%s\"%s\": %lld", p ? ", " : "", kPhaseNames[p], ph[p]);
      std::printf("}}\n");
    }
    CHECK(cudaEventDestroy(e0));
    CHECK(cudaEventDestroy(e1));
    for (void* p : {(void*)d_obs, (void*)d_a, (void*)d_tp, (void*)d_ls,
                    (void*)d_dm, (void*)d_lens, (void*)d_ph})
      CHECK(cudaFree(p));
  }
  return 0;
}
