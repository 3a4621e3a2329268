// Kernel E: streamed logits + exact top-k + logsumexp.
//
// Replaces tell_tpu/ops/kernels/topk_logits.py::topk_logits (_kernel,
// pallas_call at :126), which the adaptive softmax's decode top-k calls per
// cluster (tell_tpu/ops/adaptive.py::_adaptive_top_k_fused).
//
//   l[n, v]  = x[n, :] . table[v, :]       (l[n, zero_row] = 0 when given)
//   vals, ids = the k largest l[n, :], descending, lower id first on ties
//   lse[n]   = log sum_v exp(l[n, v])
//
// x [N,D], table [V,D], both fp32 or both bf16; k <= 8. vals [N,k] fp32,
// ids [N,k] int32, lse [N] fp32. The [N,V] logits never reach device
// memory: only per-chunk partials of N * ceil(V/64) * (2k + 2) words do.
//
// What bounds it on the H100: reading the table, V*D elements, at small N
// (the flagship's three bands are 206 MB in fp32 per decode step); the
// 2*N*V*D FLOPs at large N (4.1 GFLOP at N=40, 66 GFLOP at N=640).
//
// What the design does about it: Hopper has no sequential grid that could
// carry a running top-k from one vocabulary tile to the next (the TPU
// kernel's scheme), so it takes two passes. Pass 1 is a grid over
// (64-entry vocabulary chunk x 64-row tile of x): each block computes its
// 64 x 64 logits tile from shared-memory tiles of x and the table, in fp32
// on the CUDA cores (a 4 x 4 register tile per thread), so the table is
// read once per row tile, and every SM streams it at small N. Then one warp
// per row takes the chunk's (max, sum of exp) and its top-k by k rounds of a
// warp argmax ordered by (value desc, id asc), and writes them. Pass 2, one
// block per row, merges the partials: k rounds of a block argmax over the
// candidates strictly after the previous winner in that order, so equal
// logits come out lower id first, and lse = M + log sum_c s_c exp(m_c - M).
// The ragged edge of V is masked in the kernel (columns past V are -inf and
// read nothing); no padded copy of the table is made, and the padding row is
// zeroed by index, not by copying the table.
// Not yet done (later work): bf16 tensor-core (mma/wgmma) tiles, and a
// cp.async double buffer for the table stream.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kBM = 64;      // rows of x per block
constexpr int kBN = 64;      // vocabulary entries per chunk
constexpr int kBK = 32;      // depth per shared-memory tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
static_assert(kBN == 64, "the row pass gives each lane 2 columns");

// The order of the top-k: larger value first, then the lower id.
__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// Butterfly argmax: every lane ends with the warp's best (v, i).
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pass 1: partials pv/pi [N, C, k], pm/ps [N, C] for chunk c = blockIdx.x.
template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_partial_kernel(const T* __restrict__ x, const T* __restrict__ table,
                    float* __restrict__ pv, int* __restrict__ pi,
                    float* __restrict__ pm, float* __restrict__ ps, int N,
                    int V, int D, int k, int zero_row, int C) {
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float ts[kBK][kBN + 1];
  __shared__ float lt[kBM][kBN + 1];
  const int c = blockIdx.x;
  const int m0 = blockIdx.y * kBM, v0 = c * kBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += kBK) {
    // threads run along D, the contiguous axis of both operands
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, dd = i % kBK, d = d0 + dd;
      const int m = m0 + r, v = v0 + r;
      xs[dd][r] = (m < N && d < D) ? tt::to_f32(x[(size_t)m * D + d]) : 0.f;
      ts[dd][r] =
          (v < V && d < D) ? tt::to_f32(table[(size_t)v * D + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ts[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j, v = v0 + col;
      const float l = v == zero_row ? 0.f : acc[i][j];
      lt[ty + 16 * i][col] = v < V ? l : -INFINITY;
    }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kBM && m0 + r < N; r += kWarps) {
    float a = lt[r][lane], b = lt[r][lane + 32];
    int ia = v0 + lane, ib = v0 + lane + 32;
    const float mx = warp_max(fmaxf(a, b));  // finite: column v0 is < V
    const float s = warp_sum(expf(a - mx) + expf(b - mx));
    const size_t base = (size_t)(m0 + r) * C + c;
    if (lane == 0) {
      pm[base] = mx;
      ps[base] = s;
    }
    for (int j = 0; j < k; ++j) {
      float bv = a;
      int bi = ia;
      if (better(b, ib, a, ia)) {
        bv = b;
        bi = ib;
      }
      warp_argmax(bv, bi);
      if (lane == 0) {
        pv[base * k + j] = bv;
        pi[base * k + j] = bi;
      }
      // the winner leaves the race (ids are unique within the chunk)
      if (bi == ia) {
        a = -INFINITY;
        ia = INT_MAX;
      } else if (bi == ib) {
        b = -INFINITY;
        ib = INT_MAX;
      }
    }
  }
}

// Block-wide reductions over kThreads threads; every thread gets the result.
__device__ float block_max(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kWarps ? red[lane] : -INFINITY;
  v = warp_max(v);
  __syncthreads();
  return v;
}

__device__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kWarps ? red[lane] : 0.f;
  v = warp_sum(v);
  __syncthreads();
  return v;
}

// Pass 2: one block per row merges the row's C chunks.
__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const float* __restrict__ pv, const int* __restrict__ pi,
                  const float* __restrict__ pm, const float* __restrict__ ps,
                  float* __restrict__ vals, int* __restrict__ ids,
                  float* __restrict__ lse, int C, int k) {
  __shared__ float sv[kWarps];
  __shared__ int si[kWarps];
  __shared__ float red[kWarps];
  const int m = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int n = C * k;
  const float* cv = pv + (size_t)m * n;
  const int* ci = pi + (size_t)m * n;

  float prev_v = INFINITY;
  int prev_i = -1;
  for (int j = 0; j < k; ++j) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int t = tid; t < n; t += kThreads) {
      const float v = cv[t];
      const int i = ci[t];
      const bool after = v < prev_v || (v == prev_v && i > prev_i);
      if (after && better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      sv[warp] = bv;
      si[warp] = bi;
    }
    __syncthreads();
    bv = lane < kWarps ? sv[lane] : -INFINITY;
    bi = lane < kWarps ? si[lane] : INT_MAX;
    warp_argmax(bv, bi);
    prev_v = bv;
    prev_i = bi;
    if (tid == 0) {
      vals[(size_t)m * k + j] = bv;
      ids[(size_t)m * k + j] = bi;
    }
    __syncthreads();
  }

  const float* cm = pm + (size_t)m * C;
  const float* cs = ps + (size_t)m * C;
  float mx = -INFINITY;
  for (int t = tid; t < C; t += kThreads) mx = fmaxf(mx, cm[t]);
  mx = block_max(mx, red);
  float s = 0.f;
  for (int t = tid; t < C; t += kThreads) s += cs[t] * expf(cm[t] - mx);
  s = block_sum(s, red);
  if (tid == 0) lse[m] = mx + logf(s);
}

template <typename T>
cudaError_t launch(const void* x, const void* table, void* pv, void* pi,
                   void* pm, void* ps, void* vals, void* ids, void* lse, int N,
                   int V, int D, int k, int zero_row, cudaStream_t stream) {
  const int C = (V + kBN - 1) / kBN;
  const dim3 grid(C, (N + kBM - 1) / kBM);
  topk_partial_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(table),
      static_cast<float*>(pv), static_cast<int*>(pi), static_cast<float*>(pm),
      static_cast<float*>(ps), N, V, D, k, zero_row, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  topk_merge_kernel<<<N, kThreads, 0, stream>>>(
      static_cast<const float*>(pv), static_cast<const int*>(pi),
      static_cast<const float*>(pm), static_cast<const float*>(ps),
      static_cast<float*>(vals), static_cast<int*>(ids),
      static_cast<float*>(lse), C, k);
  return cudaGetLastError();
}

}  // namespace

// x [N,D] and table [V,D] in `dtype`; scratch pv [N,C,k] fp32, pi [N,C,k]
// int32, pm and ps [N,C] fp32 with C = ceil(V/64); vals [N,k] fp32, ids
// [N,k] int32, lse [N] fp32. zero_row < 0: no row is zeroed.
extern "C" int tt_topk_logits(const void* x, const void* table, void* pv,
                              void* pi, void* pm, void* ps, void* vals,
                              void* ids, void* lse, int N, int V, int D,
                              int k, int zero_row, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tt::kFloat32)
    return launch<float>(x, table, pv, pi, pm, ps, vals, ids, lse, N, V, D, k,
                         zero_row, st);
  if (dtype == tt::kBFloat16)
    return launch<__nv_bfloat16>(x, table, pv, pi, pm, ps, vals, ids, lse, N,
                                 V, D, k, zero_row, st);
  return cudaErrorInvalidValue;
}
