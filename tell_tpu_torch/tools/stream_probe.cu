// How fast kernel A's K/V access patterns can read device memory, with no
// attention math: fp32 K and V [B*H = 128, hd = 64, S = 2173] (the long
// article's decode source at B=8, H=16), one block per (b, h, 256-column
// chunk) of 256 threads, as kernel A launches them; four copies of the
// tensors are cycled so that the 50 MB L2 cannot hold them.
//
//   columns   kernel A's pattern: thread t reads column t of its chunk, 16
//             K rows and 16 V rows a step, the next step's loads issued
//             before this step's values are used; no barrier.
//   tiles     the earlier kernel's pattern: the chunk in four 64-column
//             tiles, thread (j, g) reading column j of K rows 4(g+4i)+e and
//             V rows g+4i (32 loads a tile); no barrier.
//   tiles+bar the same, each tile stored to shared memory between two
//             __syncthreads(), as a tile-at-a-time kernel must.
//   copy      cudaMemcpyAsync of K and V (read and write), for scale.
//
// Each pattern runs with 84,000 bytes of dynamic shared memory, so that,
// like kernel A, two blocks share an SM. Build and run on the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -o tell_tpu_torch/build/stream_probe tell_tpu_torch/tools/stream_probe.cu
//   tell_tpu_torch/build/stream_probe
//
// It prints one line per pattern: ms per pass (mean of 20 after one
// warm-up, CUDA events) and GB/s over the 142 MB of K and V.
#include <cstdio>

#include <cuda_runtime.h>

namespace {

constexpr int kHd = 64, kBH = 128, kS = 2173, kChunk = 256, kThreads = 256;
constexpr size_t kSmem = 84000;

__device__ void keep(float acc, float* sink) {
  if (acc == 12345.f) sink[threadIdx.x] = acc;  // defeats dead-code removal
}

__global__ void __launch_bounds__(kThreads, 2)
columns(const float* k, const float* v, float* sink) {
  const int s = blockIdx.y * kChunk + threadIdx.x;
  if (s >= kS) return;
  const float* kp = k + (size_t)blockIdx.x * kHd * kS + s;
  const float* vp = v + (size_t)blockIdx.x * kHd * kS + s;
  float kn[16], vn[16], acc = 0.f;
#pragma unroll
  for (int e = 0; e < 16; ++e) kn[e] = kp[(size_t)e * kS], vn[e] = vp[(size_t)e * kS];
#pragma unroll 1
  for (int d0 = 16; d0 <= kHd; d0 += 16) {
    float kc[16], vc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) kc[e] = kn[e], vc[e] = vn[e];
    if (d0 < kHd) {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        kn[e] = kp[(size_t)(d0 + e) * kS], vn[e] = vp[(size_t)(d0 + e) * kS];
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) acc += kc[e] * vc[e];
  }
  keep(acc, sink);
}

template <bool kBarrier>
__global__ void __launch_bounds__(kThreads, 2)
tiles(const float* k, const float* v, float* sink) {
  extern __shared__ float tile[];  // [2][kHd][64]
  const int j = threadIdx.x % 64, g = threadIdx.x / 64;
  const int s_end = min(kS, (int)blockIdx.y * kChunk + kChunk);
  const float* kb = k + (size_t)blockIdx.x * kHd * kS;
  const float* vb = v + (size_t)blockIdx.x * kHd * kS;
  float acc = 0.f;
  for (int s0 = blockIdx.y * kChunk; s0 < s_end; s0 += 64) {
    const int s = s0 + j;
    float r[32];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      r[i] = s < s_end ? kb[(size_t)(4 * (g + 4 * (i / 4)) + i % 4) * kS + s] : 0.f;
      r[16 + i] = s < s_end ? vb[(size_t)(g + 4 * i) * kS + s] : 0.f;
    }
    if constexpr (kBarrier) {
#pragma unroll
      for (int i = 0; i < 32; ++i) tile[(i * 4 + g) * 64 + j] = r[i];
      __syncthreads();
      acc += tile[threadIdx.x] + tile[kThreads + threadIdx.x];
      __syncthreads();
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc += r[i];
    }
  }
  keep(acc, sink);
}

template <typename Launch>
float time_ms(Launch launch) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  launch(0);
  cudaEventRecord(a);
  for (int i = 1; i <= 20; ++i) launch(i);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return ms / 20;
}

}  // namespace

int main() {
  const size_t n = (size_t)kBH * kHd * kS;
  const double bytes = 2.0 * n * sizeof(float);
  float *k, *v, *dst, *sink;
  if (cudaMalloc(&k, 4 * n * sizeof(float)) != cudaSuccess ||
      cudaMalloc(&v, 4 * n * sizeof(float)) != cudaSuccess ||
      cudaMalloc(&dst, 2 * n * sizeof(float)) != cudaSuccess ||
      cudaMalloc(&sink, kThreads * sizeof(float)) != cudaSuccess) {
    std::printf("stream_probe: out of device memory\n");
    return 1;
  }
  cudaMemset(k, 0, 4 * n * sizeof(float));
  cudaMemset(v, 0, 4 * n * sizeof(float));
  cudaFuncSetAttribute(columns, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  cudaFuncSetAttribute(tiles<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  cudaFuncSetAttribute(tiles<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  const dim3 grid(kBH, (kS + kChunk - 1) / kChunk);
  auto report = [&](const char* name, float ms, double moved) {
    std::printf("%-9s %.4f ms, %.0f GB/s\n", name, ms, moved / ms / 1e6);
  };
  report("columns", time_ms([&](int i) {
    columns<<<grid, kThreads, kSmem>>>(k + (i % 4) * n, v + (i % 4) * n, sink);
  }), bytes);
  report("tiles", time_ms([&](int i) {
    tiles<false><<<grid, kThreads, kSmem>>>(k + (i % 4) * n, v + (i % 4) * n, sink);
  }), bytes);
  report("tiles+bar", time_ms([&](int i) {
    tiles<true><<<grid, kThreads, kSmem>>>(k + (i % 4) * n, v + (i % 4) * n, sink);
  }), bytes);
  report("copy", time_ms([&](int i) {
    cudaMemcpyAsync(dst, k + (i % 4) * n, n * sizeof(float), cudaMemcpyDeviceToDevice);
    cudaMemcpyAsync(dst + n, v + (i % 4) * n, n * sizeof(float), cudaMemcpyDeviceToDevice);
  }), 2 * bytes);
  const cudaError_t err = cudaDeviceSynchronize();
  std::printf("%s\n", cudaGetErrorString(err));
  cudaFree(k);
  cudaFree(v);
  cudaFree(dst);
  cudaFree(sink);
  return err == cudaSuccess ? 0 : 1;
}
