// Kernel G: w8a8 dense layer, int8 x int8 -> int32 on the tensor cores.
//
// Replaces no Pallas kernel. tell_tpu computes this product with
// jnp.dot(xq, wq, preferred_element_type=int32) outside any kernel
// (tell_tpu/ops/quant.py::int8_linear, and the int8 softmax tables of
// tell_tpu/ops/adaptive.py::adaptive_top_k), which XLA lowers to the TPU's
// int8 MXU path. PyTorch has no public int8 GEMM (the private
// torch._int_mm refuses M <= 16 rows, the greedy decode's 8, and N not a
// multiple of 8, the last tail band's 30265 columns), and a dequantised fp
// matmul is not the int8 contraction, so the port writes one.
//
//   quant (tt_int8_quant_rows), one block a row:
//     sx[m]    = max(max_k |x[m,k]|, 1e-8) * fp32(1/127)
//     xq[m,k]  = clamp(rint(x[m,k] / sx[m]), -127, 127)             int8
//   gemm (tt_int8_gemm):
//     acc[m,n] = sum_k xq[m,k] * wq[n,k]                              int32
//     out[m,n] = fma(float(acc) * sx[m], sw[n], b[n])                 fp32
//                (float(acc) * sx[m]) * sw[n]          without a bias
//
// x [M,K] fp32 or bf16; xq [M,K] int8 and wq [N,K] int8, K % 16 == 0, both
// 16-byte aligned; sx [M], sw [N], b [N] fp32; out [M,N] fp32 or bf16.
//
// Exactness: each step is rounded as tell_tpu's int8_linear is where it
// runs, inside jit, as XLA compiles it: the division of the scale by the
// constant 127 becomes a product with its fp32 reciprocal (kInv127), the
// quotient x / sx stays a true division (__fdiv_rn: a reciprocal multiply
// would move the .5 ties), rounded half to even (__float2int_rn, as
// jnp.round and torch.round), and the last product and the bias add are
// one FMA (__fmaf_rn; XLA contracts them), the other products rounded on
// their own (__fmul_rn, which nvcc does not contract). The int32 sums are
// exact (|acc| <= 127^2 K < 2^31), so the order of the tensor cores' adds
// changes nothing, and the library is built without --use_fast_math. So
// the int8 values and the outputs equal the plain version's
// (ops/kernels/int8_linear.py) bit for bit.
//
// What bounds it on the H100: at the decode's few rows, reading the int8
// weight (N*K bytes: 31 MB for the last tail band); at the encode's 2048+
// rows, the 2*M*N*K operations at 1979 TOP/s (dense int8).
//
// What the design does about it: a simple tile GEMM on mma.sync
// m16n8k32.s8 (the .col operand wants each output channel's K values
// contiguous, so the weight is stored [N,K], made once when it is
// quantised): 64 x 64 output tiles, 4 warps of 32 x 32, the K axis in
// 64-byte slices through a three-stage cp.async ring (two slices in flight
// while one is used). Fragments load as 32-bit words from shared memory
// rows of 80 bytes, which spreads a warp's loads over the 32 banks. A
// block reads its weight tile once; the row tiles of one weight tile meet
// it in L2. Faster schedules (wgmma, TMA, a persistent grid) are later
// work.
#include <stdint.h>

#include "common.cuh"

namespace {

using tt::cp_async16;
using tt::cp_async_commit;
using tt::cp_async_wait;

constexpr int kBM = 64;        // output rows per block
constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 64;        // bytes of K per ring slot
constexpr int kPitch = kBK + 16;  // shared row pitch (bytes)
constexpr int kStages = 3;
constexpr int kThreads = 128;  // 4 warps, 2 x 2 over the tile
constexpr int kQuantThreads = 256;
constexpr float kInv127 = 1.0f / 127.0f;  // fp32(1/127), correctly rounded

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
    quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                      float* __restrict__ s, int K) {
  __shared__ float red[kQuantThreads / 32];
  const int m = blockIdx.x;
  const T* row = x + static_cast<size_t>(m) * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kQuantThreads)
    amax = fmaxf(amax, fabsf(tt::to_f32(row[k])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, red[w]);
  const float scale = __fmul_rn(fmaxf(amax, 1e-8f), kInv127);
  int8_t* qrow = q + static_cast<size_t>(m) * K;
  for (int k = threadIdx.x; k < K; k += kQuantThreads) {
    int v = __float2int_rn(__fdiv_rn(tt::to_f32(row[k]), scale));
    qrow[k] = static_cast<int8_t>(max(-127, min(127, v)));
  }
  if (threadIdx.x == 0) s[m] = scale;
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename TO>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                const float* __restrict__ sx, const float* __restrict__ sw,
                const float* __restrict__ bias, TO* __restrict__ out, int M,
                int N, int K) {
  __shared__ __align__(16) int8_t As[kStages][kBM][kPitch];
  __shared__ __align__(16) int8_t Bs[kStages][kBN][kPitch];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int nk = (K + kBK - 1) / kBK;

  // one ring slot: kBM (kBN) rows x 4 pieces of 16 bytes, 2 a thread each
  auto load = [&](int slot, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 2, kb = k0 + (c & 3) * 16;
      const bool kin = kb < K;
      const bool ain = kin && m0 + r < M;
      const bool bin = kin && n0 + r < N;
      cp_async16(&As[slot][r][(c & 3) * 16],
                 ain ? xq + static_cast<size_t>(m0 + r) * K + kb : xq, ain);
      cp_async16(&Bs[slot][r][(c & 3) * 16],
                 bin ? wq + static_cast<size_t>(n0 + r) * K + kb : wq, bin);
    }
  };

  int acc[2][4][4] = {};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // slice kt landed; slot (kt - 1) % kStages is free
    if (kt + kStages - 1 < nk)
      load((kt + kStages - 1) % kStages, (kt + kStages - 1) * kBK);
    cp_async_commit();
    const int slot = kt % kStages;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* p = &As[slot][wm * 32 + i * 16 + g][kk + 4 * t];
        a[i][0] = lds32(p);
        a[i][1] = lds32(p + 8 * kPitch);
        a[i][2] = lds32(p + 16);
        a[i][3] = lds32(p + 8 * kPitch + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = &Bs[slot][wn * 32 + j * 8 + g][kk + 4 * t];
        b[j][0] = lds32(p);
        b[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + i * 16 + g + 8 * h;
      if (m >= M) continue;
      const float xs = sx[m];
      TO* orow = out + static_cast<size_t>(m) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + j * 8 + 2 * t + e;
          if (n >= N) continue;
          const float v =
              __fmul_rn(__int2float_rn(acc[i][j][2 * h + e]), xs);
          orow[n] = tt::from_f32<TO>(bias != nullptr
                                         ? __fmaf_rn(v, sw[n], bias[n])
                                         : __fmul_rn(v, sw[n]));
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch_quant(const void* x, void* q, void* s, int M, int K,
                         cudaStream_t stream) {
  quant_rows_kernel<T><<<M, kQuantThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(s), K);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_gemm(const void* xq, const void* wq, const void* sx,
                        const void* sw, const void* bias, void* out, int M,
                        int N, int K, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<TO><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<const float*>(bias), static_cast<TO*>(out), M, N, K);
  return cudaGetLastError();
}

}  // namespace

// x [M,K] in `dtype`; q [M,K] int8; s [M] fp32.
extern "C" int tt_int8_quant_rows(const void* x, void* q, void* s, int M,
                                  int K, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1) return cudaErrorInvalidValue;
  if (dtype == tt::kFloat32) return launch_quant<float>(x, q, s, M, K, st);
  if (dtype == tt::kBFloat16)
    return launch_quant<__nv_bfloat16>(x, q, s, M, K, st);
  return cudaErrorInvalidValue;
}

// xq [M,K] and wq [N,K] int8, 16-byte aligned, K % 16 == 0; sx [M], sw [N]
// fp32; bias [N] fp32 or null; out [M,N] in `out_dtype`.
extern "C" int tt_int8_gemm(const void* xq, const void* wq, const void* sx,
                            const void* sw, const void* bias, void* out,
                            int M, int N, int K, int out_dtype,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 16 || K % 16) return cudaErrorInvalidValue;
  if (out_dtype == tt::kFloat32)
    return launch_gemm<float>(xq, wq, sx, sw, bias, out, M, N, K, st);
  if (out_dtype == tt::kBFloat16)
    return launch_gemm<__nv_bfloat16>(xq, wq, sx, sw, bias, out, M, N, K, st);
  return cudaErrorInvalidValue;
}
