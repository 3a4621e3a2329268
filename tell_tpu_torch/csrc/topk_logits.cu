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
// x [N,D], table [V,D], both fp32 or both bf16, 16-byte aligned, D % 8 ==
// 0; k <= 8. vals [N,k] fp32, ids [N,k] int32, lse [N] fp32. The [N,V]
// logits never reach device memory: only per-chunk partials of
// N * ceil(V/128) * (2k + 2) words do.
//
// What bounds it on the H100: reading the table, V*D elements, at small N
// (the flagship's three bands are 206 MB in fp32 per decode step); the
// 2*N*V*D operations at large N (2.5 GFLOP at N=40, 39.7 GFLOP at N=640
// over the largest band).
//
// What the design does about it. Hopper has no sequential grid that could
// carry a running top-k from one vocabulary tile to the next (the TPU
// kernel's scheme), so it takes two passes.
// Pass 1 is a grid of (row tile, 128-entry vocabulary chunk) blocks, the
// row tiles of one chunk adjacent in launch order, so they meet its table
// rows in L2 and the table leaves device memory once. A row tile holds BM
// = 16, 32, 48 or 64 rows of x, the least that covers N (N=40 takes 48, N
// = 640 ten tiles of 64), so no block computes rows that are not there.
// The chunk's table rows and the tile's x rows arrive along D in 128-byte
// slices by 16-byte cp.async into a three-stage ring, two slices in flight
// while one is used. The products run on the tensor cores (mma.sync): warp
// w owns the chunk's columns 16w..16w+15 for all BM rows, its logits in
// mma accumulator fragments. bf16: m16n8k16 with fp32 accumulation, x and
// table fragments by ldmatrix (a 144-byte row pitch spreads them over the
// 32 banks). fp32: 3xTF32 m16n8k8 (as kernel B): each operand split by two
// masks into hi and lo, accumulating lo*hi + hi*lo + hi*hi, which keeps
// fp32's accuracy (one TF32 product keeps about three digits): the
// operation bound at 3 x 2*N*V*D over 495 TFLOP/s is 0.24 ms at N=640,
// against 0.59 ms for fp32 on the CUDA cores. A fragment that accumulated
// all of D (128 k-steps, 384 products in fp32) drifted up to 6.4e-5 from
// the plain fp32 product on an H100, and bf16 ten times as far as on the
// CUDA cores: the tensor cores' adds do not round as fp32 adds do, and
// their error grows with the accumulator. So each ring slot's products
// (4 k-steps) accumulate in fresh fragments, which are then added to the
// running logits by ordinary fp32 adds.
// Then the block writes its BM x 128 logits to shared memory (columns past
// V are -inf; zero_row reads 0) and one warp per row takes the chunk's
// (max, sum of exp) and its top-k by k rounds of a warp argmax ordered by
// (value desc, id asc), and writes them.
// Pass 2, one block per row, merges the partials: k rounds of a block
// argmax over the candidates strictly after the previous winner in that
// order, so equal logits come out lower id first, and lse = M + log sum_c
// s_c exp(m_c - M).
// Batch invariance: the chunk width and the order of a row's sums (D's
// slices and k-steps in order, the chunk's columns, the chunks) are set by
// V and D alone; the row tile's height follows N but changes no row's
// arithmetic (an mma output element depends on its own row of A only), so
// a row's logits, top-k and lse are the same bits among 5, 40 or 640
// rows.
#include <climits>

#include "common.cuh"

namespace {

using tt::cp_async16;
using tt::cp_async_commit;
using tt::cp_async_wait;
using tt::ldmatrix_x4;
using tt::mma_3xtf32;
using tt::mma_bf16;
using tt::split_tf32;

constexpr int kChunk = 128;    // vocabulary entries per pass-1 block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;     // the cp.async ring
constexpr int kSliceBytes = 128;  // bytes of D per ring slot and row
constexpr int kLP = kChunk + 4;   // row pitch of the logits tile (floats)
static_assert(kChunk == 4 * 32, "the row pass gives each lane 4 columns");

// Elements of D per ring slot, and the slot's row pitch (16 bytes past the
// slice, so rows start on 16-byte boundaries and reads spread over banks).
template <typename T>
__host__ __device__ constexpr int slice() { return kSliceBytes / sizeof(T); }
template <typename T>
__host__ __device__ constexpr int pitch() {
  return slice<T>() + 16 / (int)sizeof(T);
}

// Ring slot bytes: kChunk table rows and BM x rows.
template <typename T, int MF>
__host__ __device__ constexpr int slot_elems() {
  return (kChunk + 16 * MF) * pitch<T>();
}

template <typename T, int MF>
constexpr size_t smem_bytes() {
  const size_t ring = sizeof(T) * (size_t)kStages * slot_elems<T, MF>();
  const size_t logits = sizeof(float) * 16 * MF * kLP;
  return ring > logits ? ring : logits;
}

// Start the cp.async loads of D-slice `kt` of the chunk's table rows and
// the tile's x rows into one ring slot; rows past V or N and columns past
// D are zero-filled and read nothing.
template <typename T, int MF>
__device__ __forceinline__ void load_slot(T* slot, const T* x,
                                          const T* table, int m0, int v0,
                                          int kt, int N, int V, int D,
                                          int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPieces = kSliceBytes / 16;  // 16-byte pieces per row
  constexpr int P = pitch<T>();
  const int d_base = kt * slice<T>();
  for (int i = tid; i < (kChunk + 16 * MF) * kPieces; i += kThreads) {
    const int r = i / kPieces, d = d_base + (i % kPieces) * kVec;
    const bool is_table = r < kChunk;
    const int row = is_table ? v0 + r : m0 + r - kChunk;
    const bool in = d < D && row < (is_table ? V : N);
    const T* src = is_table ? table : x;
    cp_async16(slot + r * P + (i % kPieces) * kVec,
               in ? src + (size_t)row * D + d : src, in);
  }
}

// acc[mf][nf] += the products of one ring slot: warp w's columns 16w + 8nf
// .. + 7 of the chunk against rows 16mf .. 16mf + 15 of the tile. Element
// i of a fragment is row 16mf + g + 8(i >> 1), column 16w + 8nf + 2c +
// (i & 1), with g = lane / 4, c = lane % 4.
// fp32: 3xTF32 m16n8k8, four k-steps over the 32 floats of the slot.
template <int MF>
__device__ __forceinline__ void mma_slot(float (&acc)[MF][2][4],
                                         const float* ts, const float* xs,
                                         int warp, int lane) {
  constexpr int P = pitch<float>();
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int ks = 0; ks < slice<float>() / 8; ++ks) {
    uint32_t bh[2][2], bl[2][2];
#pragma unroll
    for (int nf = 0; nf < 2; ++nf) {
      const float* tr = ts + (16 * warp + 8 * nf + g) * P + 8 * ks + c;
      split_tf32(tr[0], bh[nf][0], bl[nf][0]);
      split_tf32(tr[4], bh[nf][1], bl[nf][1]);
    }
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) {
      const float* xr = xs + (16 * mf + g) * P + 8 * ks + c;
      const float a[4] = {xr[0], xr[8 * P], xr[4], xr[8 * P + 4]};
      uint32_t ah[4], al[4];
      split_tf32(a, ah, al);
#pragma unroll
      for (int nf = 0; nf < 2; ++nf)
        mma_3xtf32(acc[mf][nf], ah, al, bh[nf][0], bh[nf][1], bl[nf][0],
                   bl[nf][1]);
    }
  }
}

// bf16: m16n8k16, four k-steps over the 64 values of the slot; one
// ldmatrix.x4 gives the B fragments of both n8 groups (matrices: columns
// 16w.., k 0-7; 16w.., k 8-15; 16w + 8.., k 0-7; 16w + 8.., k 8-15), one
// the A fragment of an m16 tile (rows 0-7 and 8-15 by k 0-7, then k 8-15).
template <int MF>
__device__ __forceinline__ void mma_slot(float (&acc)[MF][2][4],
                                         const __nv_bfloat16* ts,
                                         const __nv_bfloat16* xs, int warp,
                                         int lane) {
  constexpr int P = pitch<__nv_bfloat16>();
  const int mat = lane >> 3, row = lane & 7;
#pragma unroll
  for (int ks = 0; ks < slice<__nv_bfloat16>() / 16; ++ks) {
    uint32_t b[4];
    ldmatrix_x4(b, ts + (16 * warp + 8 * (mat >> 1) + row) * P + 16 * ks +
                       8 * (mat & 1));
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) {
      uint32_t a[4];
      ldmatrix_x4(a, xs + (16 * mf + (lane & 15)) * P + 16 * ks +
                         8 * (lane >> 4));
      mma_bf16(acc[mf][0], a, b[0], b[1]);
      mma_bf16(acc[mf][1], a, b[2], b[3]);
    }
  }
}

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

// Pass 1: partials pv/pi [N, C, k], pm/ps [N, C] of chunk c = blockIdx.y
// for the rows of tile blockIdx.x (16 * MF rows).
template <typename T, int MF>
__global__ void __launch_bounds__(kThreads, 2)
topk_partial_kernel(const T* __restrict__ x, const T* __restrict__ table,
                    float* __restrict__ pv, int* __restrict__ pi,
                    float* __restrict__ pm, float* __restrict__ ps, int N,
                    int V, int D, int k, int zero_row, int C) {
  constexpr int BM = 16 * MF;
  constexpr int P = pitch<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* lt = reinterpret_cast<float*>(smem);  // [BM][kLP], after the ring
  const int c = blockIdx.y;
  const int m0 = blockIdx.x * BM, v0 = c * kChunk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kt_n = (D + slice<T>() - 1) / slice<T>();

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_n)
      load_slot<T, MF>(ring + s * slot_elems<T, MF>(), x, table, m0, v0, s,
                       N, V, D, tid);
    cp_async_commit();
  }

  // the logits: each slot's products accumulate in fresh fragments (part),
  // then go into acc by fp32 adds (see the header)
  float acc[MF][2][4];
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < 2; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mf][nf][i] = 0.f;

  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice kt visible; slice kt - 1's slot is free
    const int next = kt + kStages - 1;
    if (next < kt_n)
      load_slot<T, MF>(ring + (next % kStages) * slot_elems<T, MF>(), x,
                       table, m0, v0, next, N, V, D, tid);
    cp_async_commit();
    const T* ts = ring + (kt % kStages) * slot_elems<T, MF>();
    float part[MF][2][4];
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nf = 0; nf < 2; ++nf)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mf][nf][i] = 0.f;
    mma_slot<MF>(part, ts, ts + kChunk * P, warp, lane);
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nf = 0; nf < 2; ++nf)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mf][nf][i] += part[mf][nf][i];
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the logits tile

  const int g = lane >> 2, c4 = lane & 3;
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < 2; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 16 * warp + 8 * nf + 2 * c4 + (i & 1), v = v0 + col;
        const float l = v == zero_row ? 0.f : acc[mf][nf][i];
        lt[(16 * mf + g + 8 * (i >> 1)) * kLP + col] = v < V ? l : -INFINITY;
      }
  __syncthreads();

  for (int r = warp; r < BM && m0 + r < N; r += kWarps) {
    float a[4];
    int ia[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] = lt[r * kLP + lane + 32 * q];
      ia[q] = v0 + lane + 32 * q;
    }
    // finite: column v0 is < V
    const float mx = warp_max(fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3])));
    float e = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) e += expf(a[q] - mx);
    const float s = warp_sum(e);
    const size_t base = (size_t)(m0 + r) * C + c;
    if (lane == 0) {
      pm[base] = mx;
      ps[base] = s;
    }
    for (int j = 0; j < k; ++j) {
      float bv = a[0];
      int bi = ia[0];
#pragma unroll
      for (int q = 1; q < 4; ++q)
        if (better(a[q], ia[q], bv, bi)) {
          bv = a[q];
          bi = ia[q];
        }
      warp_argmax(bv, bi);
      if (lane == 0) {
        pv[base * k + j] = bv;
        pi[base * k + j] = bi;
      }
      // the winner leaves the race (ids are unique within the chunk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (ia[q] == bi) {
          a[q] = -INFINITY;
          ia[q] = INT_MAX;
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

template <typename T, int MF>
cudaError_t launch_rows(const void* x, const void* table, void* pv, void* pi,
                        void* pm, void* ps, int N, int V, int D, int k,
                        int zero_row, cudaStream_t stream) {
  const int C = (V + kChunk - 1) / kChunk;
  const size_t smem = smem_bytes<T, MF>();
  auto kernel = topk_partial_kernel<T, MF>;
  cudaError_t err = tt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // the row tiles of one chunk run side by side (blockIdx.x fastest)
  const dim3 grid((N + 16 * MF - 1) / (16 * MF), C);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(table),
      static_cast<float*>(pv), static_cast<int*>(pi), static_cast<float*>(pm),
      static_cast<float*>(ps), N, V, D, k, zero_row, C);
  return cudaGetLastError();
}

// Row tiles of 16, 32, 48 or 64 rows: the least that covers N, at most 64.
template <typename T>
cudaError_t launch(const void* x, const void* table, void* pv, void* pi,
                   void* pm, void* ps, void* vals, void* ids, void* lse, int N,
                   int V, int D, int k, int zero_row, cudaStream_t stream) {
  cudaError_t err;
  if (N <= 16)
    err = launch_rows<T, 1>(x, table, pv, pi, pm, ps, N, V, D, k, zero_row,
                            stream);
  else if (N <= 32)
    err = launch_rows<T, 2>(x, table, pv, pi, pm, ps, N, V, D, k, zero_row,
                            stream);
  else if (N <= 48)
    err = launch_rows<T, 3>(x, table, pv, pi, pm, ps, N, V, D, k, zero_row,
                            stream);
  else
    err = launch_rows<T, 4>(x, table, pv, pi, pm, ps, N, V, D, k, zero_row,
                            stream);
  if (err != cudaSuccess) return err;
  const int C = (V + kChunk - 1) / kChunk;
  topk_merge_kernel<<<N, kThreads, 0, stream>>>(
      static_cast<const float*>(pv), static_cast<const int*>(pi),
      static_cast<const float*>(pm), static_cast<const float*>(ps),
      static_cast<float*>(vals), static_cast<int*>(ids),
      static_cast<float*>(lse), C, k);
  return cudaGetLastError();
}

}  // namespace

// x [N,D] and table [V,D] in `dtype`, 16-byte aligned, D % 8 == 0; scratch
// pv [N,C,k] fp32, pi [N,C,k] int32, pm and ps [N,C] fp32 with C =
// ceil(V/128); vals [N,k] fp32, ids [N,k] int32, lse [N] fp32. zero_row <
// 0: no row is zeroed.
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
