// Kernel C: fused causal dynamic convolution (forward).
//
// Replaces tell_tpu/ops/kernels/dynamic_conv.py::fused_dynamic_conv
// (_pallas_forward / _kernel, pallas_call at :83).
//
//   logits[b,t,k*H+h] = sum_c x[b,t,c] * w_km[c,k*H+h]       (fp32)
//   p[b,t,k,h]        = softmax_k(logits[b,t,:,h])      (or the raw logits)
//   out[b,t,c]        = sum_k p[b,t,k,h(c)] * x[b,t-K+1+k,c], zeros before t=0
//
// x, out [B,T,C]; w_km [C,K*H], k-major as tell_tpu's dynamic_conv hands it
// to the TPU kernel (column k*H + h is tap k of head h); h(c) = c / (C/H).
// fp32 or bf16 storage, fp32 logits, softmax and accumulators.
//
// What bounds it on the H100: the tap-logit product, 2*B*T*C*K*H FLOPs
// (0.52 GFLOP at B=16, T=32, C=1024, K=31, H=16), run here on the fp32 CUDA
// cores from shared memory. The rest is one read of x (plus a halo) and one
// write of out; the plain version instead writes the logits, the
// probabilities and K partial sums of [B,T,C] to device memory.
//
// What the design does about it: a block owns a tile of kTT time rows of one
// batch row and a group of HB heads (HB*K <= 64 tap-logit columns, picked by
// the wrapper so the small-K layers still give each block a few hundred
// logits). It reduces the logits over C in kCC-channel chunks staged in
// shared memory (x chunk [kTT, kCC] and the group's w_km columns
// [kCC, K*HB]; w_km is read by every block, so it comes from L2), keeps them
// in registers, then holds the [kTT, K*HB] probabilities in shared memory
// for the tap FMA. The FMA walks the group's channels in kCW-wide chunks: a
// block loads its own causal halo, the K-1 rows before the tile, with zeros
// before t = 0 and past T, so T < K (a 16-token caption under the K=31
// layer) and the ragged last tile need no padding. The head of a channel is
// an index, c / R (the TPU needed a 0/1 [H,C] matmul for it).
// Not yet done (later work): bf16 tensor-core (mma/wgmma) tiles for the
// logits, register tiling of the reduction, a TMA/cp.async pipeline.
#include "common.cuh"

namespace {

constexpr int kTT = 32;       // time rows per block
constexpr int kCC = 32;       // channels per chunk of the logit reduction
constexpr int kCW = 64;       // channels per chunk of the tap FMA
constexpr int kMaxNF = 64;    // tap-logit columns (K * HB) per block
constexpr int kThreads = 256;
constexpr int kMaxOut = kTT * kMaxNF / kThreads;  // logits per thread

template <typename T>
__global__ void __launch_bounds__(kThreads)
dynamic_conv_kernel(const T* __restrict__ x, const T* __restrict__ w_km,
                    T* __restrict__ out, int T_len, int C, int H, int K,
                    int HB, int weight_softmax) {
  extern __shared__ float smem[];
  const int NF = K * HB;
  float* pr = smem;                   // [kTT, NF] logits, then probabilities
  float* work = pr + kTT * kMaxNF;
  float* xs = work;                   // phase 1: [kTT, kCC] x chunk
  float* ws = work + kTT * kCC;       // phase 1: [kCC, NF] w_km columns
  float* win = work;                  // phase 3: [kTT + K - 1, kCW] window

  const int t0 = blockIdx.x * kTT;
  const int h0 = blockIdx.y * HB;
  const int b = blockIdx.z;
  const int R = C / H;
  const int KH = K * H;
  const int tid = threadIdx.x;
  const T* xb = x + (size_t)b * T_len * C;
  T* ob = out + (size_t)b * T_len * C;
  const int n_out = kTT * NF;

  // 1. tap logits of the tile's rows for the group's heads, reduced over C
  float acc[kMaxOut];
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) acc[j] = 0.f;
  for (int c0 = 0; c0 < C; c0 += kCC) {
    for (int i = tid; i < kTT * kCC; i += kThreads) {
      const int t = i / kCC, c = i % kCC;
      const int ti = t0 + t, cc = c0 + c;
      xs[i] = (ti < T_len && cc < C) ? tt::to_f32(xb[(size_t)ti * C + cc])
                                     : 0.f;
    }
    for (int i = tid; i < kCC * NF; i += kThreads) {
      const int c = i / NF, f = i % NF;
      const int k = f / HB, hh = f % HB;
      const int cc = c0 + c;
      ws[i] = cc < C ? tt::to_f32(w_km[(size_t)cc * KH + k * H + h0 + hh])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) {
      const int o = tid + j * kThreads;
      if (o < n_out) {
        const int t = o / NF, f = o % NF;
        const float* xr = xs + t * kCC;
        float s = 0.f;
#pragma unroll 8
        for (int c = 0; c < kCC; ++c) s += xr[c] * ws[c * NF + f];
        acc[j] += s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) {
    const int o = tid + j * kThreads;
    if (o < n_out) pr[o] = acc[j];
  }
  __syncthreads();

  // 2. softmax over each head's K taps (column k*HB + hh of a row)
  if (weight_softmax) {
    for (int i = tid; i < kTT * HB; i += kThreads) {
      float* row = pr + (i / HB) * NF + (i % HB);
      float m = -INFINITY;
      for (int k = 0; k < K; ++k) m = fmaxf(m, row[k * HB]);
      float sum = 0.f;
      for (int k = 0; k < K; ++k) {
        const float e = expf(row[k * HB] - m);
        row[k * HB] = e;
        sum += e;
      }
      for (int k = 0; k < K; ++k) row[k * HB] /= sum;
    }
    __syncthreads();
  }

  // 3. out[t, c] = sum_k p[t, k, h(c)] * x[t - K + 1 + k, c]; window row j
  //    holds time t0 - (K - 1) + j, so tap k of tile row t is row t + k
  const int CB = HB * R;
  const int c_base = h0 * R;
  const int rows = kTT + K - 1;
  for (int cb0 = 0; cb0 < CB; cb0 += kCW) {
    const int cw = min(kCW, CB - cb0);
    for (int i = tid; i < rows * kCW; i += kThreads) {
      const int j = i / kCW, c = i % kCW;
      const int ti = t0 - (K - 1) + j;
      win[i] = (c < cw && ti >= 0 && ti < T_len)
                   ? tt::to_f32(xb[(size_t)ti * C + c_base + cb0 + c])
                   : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kTT * kCW; i += kThreads) {
      const int t = i / kCW, c = i % kCW;
      const int ti = t0 + t;
      if (c < cw && ti < T_len) {
        const float* p = pr + t * NF + (cb0 + c) / R;
        const float* wr = win + t * kCW + c;
        float s = 0.f;
        for (int k = 0; k < K; ++k) s += p[k * HB] * wr[k * kCW];
        ob[(size_t)ti * C + c_base + cb0 + c] = tt::from_f32<T>(s);
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w_km, void* out, int B,
                   int T_len, int C, int H, int K, int HB, int weight_softmax,
                   cudaStream_t stream) {
  if (K * HB > kMaxNF || H % HB != 0 || C % H != 0)
    return cudaErrorInvalidValue;
  const int phase1 = kTT * kCC + kCC * K * HB;
  const int phase3 = (kTT + K - 1) * kCW;
  const size_t smem =
      sizeof(float) * (kTT * kMaxNF + (phase1 > phase3 ? phase1 : phase3));
  cudaError_t err = tt::allow_smem(dynamic_conv_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + kTT - 1) / kTT, H / HB, B);
  dynamic_conv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_km),
      static_cast<T*>(out), T_len, C, H, K, HB, weight_softmax);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tt_dynamic_conv(const void* x, const void* w_km, void* out,
                               int B, int T, int C, int H, int K, int HB,
                               int weight_softmax, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tt::kFloat32)
    return launch<float>(x, w_km, out, B, T, C, H, K, HB, weight_softmax,
                         st);
  if (dtype == tt::kBFloat16)
    return launch<__nv_bfloat16>(x, w_km, out, B, T, C, H, K, HB,
                                 weight_softmax, st);
  return cudaErrorInvalidValue;
}
