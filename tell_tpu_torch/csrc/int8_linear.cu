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
//   quant (quant_rows_vec_kernel, or quant_rows_kernel where a row is not
//   16-byte aligned or too long), one block a row:
//     sx[m]    = max(max_k |x[m,k]|, 1e-8) * fp32(1/127)
//     xq[m,k]  = clamp(rint(x[m,k] / sx[m]), -127, 127)             int8
//   gemm (wgmma_gemm_kernel or mma_gemm_kernel):
//     acc[m,n] = sum_k xq[m,k] * wq[n,k]                              int32
//     out[m,n] = fma(float(acc) * sx[m], sw[n], b[n])                 fp32
//                (float(acc) * sx[m]) * sw[n]          without a bias
//
// x [M,K] fp32 or bf16; xq [M,K] int8 and wq [N,K] int8, K % 16 == 0, both
// 16-byte aligned; sx [M], sw [N], b [N] fp32; out [M,N] fp32 or bf16.
// tt_int8_linear launches the quant and the GEMM back to back on the
// caller's stream: one host call a dense layer.
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
// and of the split-K partials' int32 adds changes nothing, and the library
// is built without --use_fast_math. So the int8 values and the outputs
// equal the plain version's (ops/kernels/int8_linear.py) bit for bit.
//
// What bounds it on the H100: at the encode's 2048+ rows, the fp32 output
// (33.5 MB at fc1) and the 2*M*N*K operations at 1979 TOP/s (dense int8),
// about even; at the decode's few rows, reading the int8 weight (N*K
// bytes: 1-31 MB).
//
// What the design does about it. ops/kernels/int8_linear.py::plan_gemm
// picks the route by shape and hands its choices (route, split, K chunk,
// grid) to the entry points, which only check them:
//  * M > 64, wgmma_gemm_kernel: 128 x 128 output tiles, or 128 x 256
//    where those still give every SM a tile (fc1's shape: each byte read
//    from L2 feeds twice the products), on a persistent grid of at most
//    one block an SM. One producer thread feeds a ring of four (three)
//    stages (A's 128 x 128-byte tile and B's 128 (256) x 128 bytes) by
//    TMA, in 128-byte-swizzled shared memory, each stage's arrival
//    counted on an mbarrier; two consumer warpgroups (64 rows each, with
//    the registers the producer's warpgroup gives up) run
//    wgmma.m64n128k32 (m64n256k32).s32.s8.s8 on it (both operands
//    K-major, as xq [M,K] and the weight [N,K] already are) and free the
//    stage on a second mbarrier, one wgmma group kept in flight. Rows and columns
//    past M, N and K come in as zeros from TMA. The epilogue rescales in
//    registers, stages 128 columns of it at a time through shared memory
//    and writes whole rows in 16-byte pieces (any width: a row whose
//    start is not 16-byte aligned, the 30265-column band's, goes out
//    element by element), while the producer already loads the next
//    tile. Neither stores straight from registers nor a bulk copy a row
//    beat this staging on the card (PERF.md, kernel G).
//  * M <= 64, mma_gemm_kernel: the weight read bounds it, so every SM must
//    read: 64 x 64 tiles on mma.sync.m16n8k32 fed by a four-stage cp.async
//    ring, the K axis split over the blocks of a thread-block cluster (up
//    to 8) where the tiles alone would leave SMs idle. Each block leaves
//    its int32 partial tile in its shared memory; after a cluster barrier
//    every block sums its share of the tile's rows over the cluster's
//    shared memory (int32, exact), rescales and writes 16-byte pieces.
//    wgmma would waste at least 24 of its 64 rows here.
//
// The TMA descriptors (CUtensorMap) are encoded through
// cudaGetDriverEntryPoint (the library is not linked to libcuda) and kept
// in a cache keyed on everything they encode (address, rows, K), so a
// weight's map is made once, not once a call.
#include <cooperative_groups.h>
#include <cuda.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using tt::cp_async16;
using tt::cp_async_commit;
using tt::cp_async_wait;

constexpr float kInv127 = 1.0f / 127.0f;  // fp32(1/127), correctly rounded
constexpr int kQuantThreads = 256;

// routes, as plan_gemm numbers them
constexpr int kRouteMma = 0;
constexpr int kRouteWgmma = 1;       // 128 x 128 tiles
constexpr int kRouteWgmmaWide = 2;   // 128 x 256 tiles

// mma route: one 64-row tile, 64 columns a block, 64-byte K slices
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kPitch = kBK + 16;   // shared row pitch (bytes)
constexpr int kStages = 4;
constexpr int kThreads = 128;      // 4 warps, 2 x 2 over the tile
constexpr int kRedPitch = kBN + 8; // int32 words a partial row
constexpr int kMaxSplit = 8;       // the portable cluster size

// wgmma route: 128 x BN output tiles, BN = 128 or 256 (plan_gemm's tile)
constexpr int kWBM = 128;
constexpr int kWBK = 128;          // bytes of K a stage: one swizzle row
constexpr int kWConsumers = 2;     // warpgroups, 64 rows each
constexpr int kWThreads = 128 * (kWConsumers + 1);
constexpr int kATile = kWBM * kWBK;
constexpr int kOutCols = 128;      // output columns staged at a time
constexpr int kOutPitch = kOutCols + 8;  // floats a staged output row
template <int BN>
struct WgmmaShape {
  static constexpr int kBTile = BN * kWBK;
  static constexpr int kStages = BN == 256 ? 3 : 4;   // as fit beside
  static constexpr size_t kSmem =                      // the staging
      1024 + kStages * (kATile + kBTile) +
      kWConsumers * 64 * kOutPitch * sizeof(float) +
      2 * kStages * sizeof(uint64_t);
};

// ---- the activation quant ------------------------------------------------

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

// The same, where a row starts on a 16-byte boundary and its 16-byte
// pieces fit V to a thread: each thread loads its pieces once, keeps them
// in registers through the block's amax, and stores their int8 values
// whole. The same arithmetic, so the same bits.
template <typename T, int V>
__global__ void __launch_bounds__(kQuantThreads)
    quant_rows_vec_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                          float* __restrict__ s, int K) {
  constexpr int E = 16 / sizeof(T);   // elements a piece
  __shared__ float red[kQuantThreads / 32];
  const int m = blockIdx.x;
  const int pieces = K / E;
  const T* row = x + static_cast<size_t>(m) * K;
  float v[V][E];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int p = threadIdx.x + i * kQuantThreads;
    const uint4 raw = p < pieces
                          ? *reinterpret_cast<const uint4*>(row + p * E)
                          : make_uint4(0, 0, 0, 0);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      v[i][j] = tt::to_f32(e[j]);
      amax = fmaxf(amax, fabsf(v[i][j]));
    }
  }
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
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int p = threadIdx.x + i * kQuantThreads;
    if (p >= pieces) continue;
    int8_t b[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int r = __float2int_rn(__fdiv_rn(v[i][j], scale));
      b[j] = static_cast<int8_t>(max(-127, min(127, r)));
    }
    if constexpr (E == 4)
      *reinterpret_cast<uint32_t*>(qrow + p * E) =
          *reinterpret_cast<const uint32_t*>(b);
    else
      *reinterpret_cast<uint2*>(qrow + p * E) =
          *reinterpret_cast<const uint2*>(b);
  }
  if (threadIdx.x == 0) s[m] = scale;
}

// ---- the epilogue, shared by both routes ---------------------------------

__device__ __forceinline__ float rescale(int acc, float xs, float ws,
                                         const float* __restrict__ bias,
                                         int n) {
  const float v = __fmul_rn(__int2float_rn(acc), xs);
  return bias != nullptr ? __fmaf_rn(v, ws, bias[n]) : __fmul_rn(v, ws);
}

// out[0..min(left, 4)) = v: one 16-byte (fp32) or 8-byte (bf16) store where
// all four fit and the address allows it, else element by element.
__device__ __forceinline__ void store4(float* p, const float (&v)[4],
                                       int left) {
  if (left >= 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < left) p[e] = v[e];
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4],
                                       int left) {
  if (left >= 4 && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < left) p[e] = __float2bfloat16(v[e]);
}

// p[0], p[1] = a, b in one 8-byte store
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// ---- the mma route (M <= 64) ---------------------------------------------

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

union MmaSmem {
  struct {
    int8_t a[kStages][kBM][kPitch];
    int8_t b[kStages][kBN][kPitch];
  } ring;
  int red[kBM][kRedPitch];   // the block's int32 partial tile
};

// grid (ceil(N / 64), split), clusters of (1, split): block y of a cluster
// sums K in [y * chunk, min(K, (y + 1) * chunk)).
template <typename TO>
__global__ void __launch_bounds__(kThreads)
    mma_gemm_kernel(const int8_t* __restrict__ xq,
                    const int8_t* __restrict__ wq,
                    const float* __restrict__ sx,
                    const float* __restrict__ sw,
                    const float* __restrict__ bias, TO* __restrict__ out,
                    int M, int N, int K, int chunk) {
  __shared__ __align__(16) MmaSmem sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.y * chunk;
  const int k_end = min(K, k_begin + chunk);
  const int nk = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  // one ring slot: kBM (kBN) rows x 4 pieces of 16 bytes, 2 a thread each
  auto load = [&](int slot, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 2, kb = k0 + (c & 3) * 16;
      const bool kin = kb < k_end;
      const bool ain = kin && r < M;
      const bool bin = kin && n0 + r < N;
      cp_async16(&sm.ring.a[slot][r][(c & 3) * 16],
                 ain ? xq + static_cast<size_t>(r) * K + kb : xq, ain);
      cp_async16(&sm.ring.b[slot][r][(c & 3) * 16],
                 bin ? wq + static_cast<size_t>(n0 + r) * K + kb : wq, bin);
    }
  };

  int acc[2][4][4] = {};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, k_begin + s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // slice kt landed; slot (kt - 1) % kStages is free
    if (kt + kStages - 1 < nk)
      load((kt + kStages - 1) % kStages, k_begin + (kt + kStages - 1) * kBK);
    cp_async_commit();
    const int slot = kt % kStages;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* p = &sm.ring.a[slot][wm * 32 + i * 16 + g][kk + 4 * t];
        a[i][0] = lds32(p);
        a[i][1] = lds32(p + 8 * kPitch);
        a[i][2] = lds32(p + 16);
        a[i][3] = lds32(p + 8 * kPitch + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = &sm.ring.b[slot][wn * 32 + j * 8 + g][kk + 4 * t];
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
  __syncthreads();     // the ring is done with; its memory holds the partial

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<int2*>(
            &sm.red[wm * 32 + i * 16 + g + 8 * h][wn * 32 + j * 8 + 2 * t]) =
            make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  cluster.sync();      // every split's partial is in its block's memory

  // this block's share: 4-column pieces of the M valid rows, dealt out over
  // the cluster's blocks; each sums the piece over every block's partial
  const int nsplit = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  for (int idx = rank * kThreads + tid; idx < M * (kBN / 4);
       idx += nsplit * kThreads) {
    const int r = idx / (kBN / 4), c = (idx % (kBN / 4)) * 4;
    const int n = n0 + c;
    if (n >= N) continue;
    int4 s = make_int4(0, 0, 0, 0);
    for (int q = 0; q < nsplit; ++q) {
      const int4 v = *reinterpret_cast<const int4*>(
          cluster.map_shared_rank(&sm.red[r][c], q));
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int part[4] = {s.x, s.y, s.z, s.w};
    const float xs = sx[r];
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = n + e < N ? rescale(part[e], xs, sw[n + e], bias, n + e) : 0.f;
    store4(out + static_cast<size_t>(r) * N + n, v, N - n);
  }
  cluster.sync();      // no block leaves while another reads its memory
}

// ---- the wgmma route (M > 64) --------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of `parity` to complete. A wait that outlasts any
// call (about 10 s) is a fault: it traps, so the launch fails, rather than
// holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > 20000000000ll) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// a box of the 2-D map at (c0 along K, c1 along the rows) into dst,
// counted on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma's shared-memory operand: K-major rows of 128 bytes, swizzled by
// TMA's SWIZZLE_128B, 8-row atoms 1024 bytes apart (SBO); the leading
// offset is unused for a swizzled K-major operand.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins the accumulators' registers at this point of the program, so no
// read or write of them moves across an asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x 256] += A[64 x 32] * B[256 x 32]^T, int8 -> int32
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));   // scale-d: accumulate into d
}

// d[64 x 128] += A[64 x 32] * B[128 x 32]^T, int8 -> int32
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));   // scale-d: accumulate into d
}

// Tiles are numbered with the row tile fastest, so the blocks working at
// one time share their weight tiles in L2; block b takes tiles b,
// b + gridDim.x, ... The producer warpgroup gives its registers to the
// consumers (setmaxnreg: 40 and 232 of 168 each, 384 threads), whose
// accumulators take BN / 2 of them.
template <typename TO, int BN>
__global__ void __launch_bounds__(kWThreads, 1)
    wgmma_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w,
                      const float* __restrict__ sx,
                      const float* __restrict__ sw,
                      const float* __restrict__ bias, TO* __restrict__ out,
                      int M, int N, int K) {
  using Shape = WgmmaShape<BN>;
  constexpr int kStages = Shape::kStages;
  constexpr int kStage = kATile + Shape::kBTile;
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the ring to it
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = base;   // stage s: A at s * kStage, then B
  uint8_t* staged = base + kStages * kStage;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      staged + kWConsumers * 64 * kOutPitch * sizeof(float));
  const uint32_t full0 = smem_u32(bars);
  const uint32_t empty0 = smem_u32(bars + kStages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kWConsumers * 4);   // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int m_tiles = (M + kWBM - 1) / kWBM;
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = m_tiles * n_tiles;
  const int nk = (K + kWBK - 1) / kWBK;
  const int wg = threadIdx.x / 128;

  if (wg == kWConsumers) {            // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != kWConsumers * 128) return;
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&map_x))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&map_w))
                 : "memory");
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % m_tiles) * kWBM, n0 = (tile / m_tiles) * BN;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t full = full0 + 8 * stage;
        const uint32_t a = smem_u32(ring + stage * kStage);
        mbar_expect_tx(full, kStage);
        tma_load(a, &map_x, kt * kWBK, m0, full);
        tma_load(a + kATile, &map_w, kt * kWBK, n0, full);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows [64 wg, 64 wg + 64) of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int t = threadIdx.x % 128;
  const int wi = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
  float* out_tile = reinterpret_cast<float*>(staged) + wg * 64 * kOutPitch;
  int stage = 0, phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile % m_tiles) * kWBM, n0 = (tile / m_tiles) * BN;
    int d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0;
    int prev = -1;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t a = smem_u32(ring + stage * kStage) + wg * 64 * kWBK;
      const uint32_t b = smem_u32(ring + stage * kStage) + kATile;
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWBK / 32; ++kk)
        wgmma_s8(d, smem_desc(a + 32 * kk), smem_desc(b + 32 * kk));
      wgmma_commit();
      fence_regs(d);
      wgmma_wait<1>();    // the previous stage's group is done with it
      if (prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(d);
    if (prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);

    // rescale in registers, stage 64 x 128 at a time, write whole rows
    const int r0 = wi * 16 + g;
    const int mr0 = m0 + wg * 64 + r0;
    const float xs0 = mr0 < M ? sx[mr0] : 0.f;
    const float xs1 = mr0 + 8 < M ? sx[mr0 + 8] : 0.f;
#pragma unroll
    for (int part = 0; part < BN / kOutCols; ++part) {
      const int np = n0 + part * kOutCols;
#pragma unroll
      for (int j = 0; j < kOutCols / 8; ++j) {
        const int c = j * 8 + 2 * tq, n = np + c;
        const int i = 4 * (part * kOutCols / 8 + j);
        const float w0 = n < N ? sw[n] : 0.f;
        const float w1 = n + 1 < N ? sw[n + 1] : 0.f;
        // the bias is read only where its column exists
        const float* b0 = n < N ? bias : nullptr;
        const float* b1 = n + 1 < N ? bias : nullptr;
        store2(&out_tile[r0 * kOutPitch + c],
               rescale(d[i], xs0, w0, b0, n),
               rescale(d[i + 1], xs0, w1, b1, n + 1));
        store2(&out_tile[(r0 + 8) * kOutPitch + c],
               rescale(d[i + 2], xs1, w0, b0, n),
               rescale(d[i + 3], xs1, w1, b1, n + 1));
      }
      named_sync(1 + wg, 128);
      for (int r = wi; r < 64; r += 4) {
        const int m = m0 + wg * 64 + r, n = np + 4 * lane;
        if (m >= M || n >= N) continue;
        const float4 v4 = *reinterpret_cast<const float4*>(
            &out_tile[r * kOutPitch + 4 * lane]);
        const float v[4] = {v4.x, v4.y, v4.z, v4.w};
        store4(out + static_cast<size_t>(m) * N + n, v, N - n);
      }
      named_sync(1 + wg, 128);   // the staged columns are free again
    }
  }
}

// ---- host side -----------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

struct MapKey {
  uintptr_t ptr;
  int rows, K, box;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && rows == o.rows && K == o.K && box == o.box;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    return std::hash<uintptr_t>()(k.ptr) ^
           (static_cast<size_t>(k.rows) * 0x9E3779B97F4A7C15ull) ^
           (static_cast<size_t>(k.K) << 1) ^ (static_cast<size_t>(k.box) << 40);
  }
};

constexpr size_t kMaxMaps = 4096;
constexpr int kMaxDevices = 64;

// The map of an int8 [rows, K] matrix in boxes of `box` rows x 128 bytes,
// swizzled for wgmma, rows and K past the end read as zeros. Cached: the
// map is a function of the key alone, so a hit is the map the call would
// encode.
cudaError_t tensor_map(const void* ptr, int rows, int K, int box,
                       CUtensorMap* map) {
  static std::mutex lock;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{reinterpret_cast<uintptr_t>(ptr), rows, K, box};
  std::lock_guard<std::mutex> hold(lock);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return cudaSuccess;
  }
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t boxes[2] = {kWBK, static_cast<cuuint32_t>(box)};
  const cuuint32_t elem[2] = {1, 1};
  CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(ptr), dims, strides, boxes, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  if (cache.size() >= kMaxMaps) cache.clear();
  cache.emplace(key, *map);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_quant(const void* x, void* q, void* s, int M, int K,
                         cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int per = (K / E + kQuantThreads - 1) / kQuantThreads;
  const bool vec = K % E == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(q) & 15) == 0 &&
                   (K * sizeof(T)) % 16 == 0 && per <= 8;
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* st = static_cast<float*>(s);
  if (!vec)
    quant_rows_kernel<T><<<M, kQuantThreads, 0, stream>>>(xt, qt, st, K);
  else if (per <= 1)
    quant_rows_vec_kernel<T, 1><<<M, kQuantThreads, 0, stream>>>(xt, qt, st, K);
  else if (per <= 2)
    quant_rows_vec_kernel<T, 2><<<M, kQuantThreads, 0, stream>>>(xt, qt, st, K);
  else if (per <= 4)
    quant_rows_vec_kernel<T, 4><<<M, kQuantThreads, 0, stream>>>(xt, qt, st, K);
  else
    quant_rows_vec_kernel<T, 8><<<M, kQuantThreads, 0, stream>>>(xt, qt, st, K);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_mma(const void* xq, const void* wq, const void* sx,
                       const void* sw, const void* bias, void* out, int M,
                       int N, int K, int split, int chunk,
                       cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kBN - 1) / kBN, split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, mma_gemm_kernel<TO>, static_cast<const int8_t*>(xq),
      static_cast<const int8_t*>(wq), static_cast<const float*>(sx),
      static_cast<const float*>(sw), static_cast<const float*>(bias),
      static_cast<TO*>(out), M, N, K, chunk);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TO, int BN>
cudaError_t launch_wgmma(const void* xq, const void* wq, const void* sx,
                         const void* sw, const void* bias, void* out, int M,
                         int N, int K, int grid, cudaStream_t stream) {
  constexpr size_t smem = WgmmaShape<BN>::kSmem;
  // the opt-in to more than 48 KB of shared memory, once a device
  static bool opted[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(wgmma_gemm_kernel<TO, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  CUtensorMap map_x, map_w;
  err = tensor_map(xq, M, K, kWBM, &map_x);
  if (err == cudaSuccess) err = tensor_map(wq, N, K, BN, &map_w);
  if (err != cudaSuccess) return err;
  wgmma_gemm_kernel<TO, BN><<<grid, kWThreads, smem, stream>>>(
      map_x, map_w, static_cast<const float*>(sx),
      static_cast<const float*>(sw), static_cast<const float*>(bias),
      static_cast<TO*>(out), M, N, K);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_gemm(const void* xq, const void* wq, const void* sx,
                        const void* sw, const void* bias, void* out, int M,
                        int N, int K, int route, int split, int chunk,
                        int grid, cudaStream_t stream) {
  if (route == kRouteWgmma)
    return launch_wgmma<TO, 128>(xq, wq, sx, sw, bias, out, M, N, K, grid,
                                 stream);
  if (route == kRouteWgmmaWide)
    return launch_wgmma<TO, 256>(xq, wq, sx, sw, bias, out, M, N, K, grid,
                                 stream);
  return launch_mma<TO>(xq, wq, sx, sw, bias, out, M, N, K, split, chunk,
                        stream);
}

// The plan's choices, checked: what the kernels cannot survive is refused.
bool plan_ok(int M, int N, int K, int route, int split, int chunk,
             int grid) {
  if (M < 1 || N < 1 || K < 16 || K % 16) return false;
  if (route == kRouteWgmma || route == kRouteWgmmaWide)
    return grid >= 1 && split == 1;
  if (route != kRouteMma || M > kBM) return false;
  return split >= 1 && split <= kMaxSplit && chunk >= kBK &&
         chunk % kBK == 0 && static_cast<long long>(chunk) * split >= K &&
         grid == (N + kBN - 1) / kBN * split;
}

cudaError_t gemm(const void* xq, const void* wq, const void* sx,
                 const void* sw, const void* bias, void* out, int M, int N,
                 int K, int out_dtype, int route, int split, int chunk,
                 int grid, cudaStream_t st) {
  if (!plan_ok(M, N, K, route, split, chunk, grid))
    return cudaErrorInvalidValue;
  if (out_dtype == tt::kFloat32)
    return launch_gemm<float>(xq, wq, sx, sw, bias, out, M, N, K, route,
                              split, chunk, grid, st);
  if (out_dtype == tt::kBFloat16)
    return launch_gemm<__nv_bfloat16>(xq, wq, sx, sw, bias, out, M, N, K,
                                      route, split, chunk, grid, st);
  return cudaErrorInvalidValue;
}

// Makes `device` current for a call and restores the caller's after it.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    else prev = -1;
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

cudaError_t quant(const void* x, void* q, void* s, int M, int K, int dtype,
                  cudaStream_t st) {
  if (M < 1 || K < 1) return cudaErrorInvalidValue;
  if (dtype == tt::kFloat32) return launch_quant<float>(x, q, s, M, K, st);
  if (dtype == tt::kBFloat16)
    return launch_quant<__nv_bfloat16>(x, q, s, M, K, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x [M,K] in `dtype`; q [M,K] int8; s [M] fp32. Every entry point launches
// on `device` (made current for the call) and the caller's stream.
extern "C" int tt_int8_quant_rows(const void* x, void* q, void* s, int M,
                                  int K, int dtype, int device,
                                  void* stream) {
  DeviceGuard on(device);
  if (on.err != cudaSuccess) return on.err;
  return quant(x, q, s, M, K, dtype, static_cast<cudaStream_t>(stream));
}

// xq [M,K] and wq [N,K] int8, 16-byte aligned, K % 16 == 0; sx [M], sw [N]
// fp32; bias [N] fp32 or null; out [M,N] in `out_dtype`; route, split,
// chunk and grid from plan_gemm.
extern "C" int tt_int8_gemm(const void* xq, const void* wq, const void* sx,
                            const void* sw, const void* bias, void* out,
                            int M, int N, int K, int out_dtype, int route,
                            int split, int chunk, int grid, int device,
                            void* stream) {
  DeviceGuard on(device);
  if (on.err != cudaSuccess) return on.err;
  return gemm(xq, wq, sx, sw, bias, out, M, N, K, out_dtype, route, split,
              chunk, grid, static_cast<cudaStream_t>(stream));
}

// One dense layer: x [M,K] in `dtype` -> out [M,N] in `dtype`, through the
// caller's scratch xq [M,K] int8 and sx [M] fp32; the rest as tt_int8_gemm.
extern "C" int tt_int8_linear(const void* x, void* xq, void* sx,
                              const void* wq, const void* sw,
                              const void* bias, void* out, int M, int N,
                              int K, int dtype, int route, int split,
                              int chunk, int grid, int device, void* stream) {
  DeviceGuard on(device);
  if (on.err != cudaSuccess) return on.err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!plan_ok(M, N, K, route, split, chunk, grid))
    return cudaErrorInvalidValue;
  cudaError_t err = quant(x, xq, sx, M, K, dtype, st);
  if (err != cudaSuccess) return err;
  return gemm(xq, wq, sx, sw, bias, out, M, N, K, dtype, route, split, chunk,
              grid, st);
}
