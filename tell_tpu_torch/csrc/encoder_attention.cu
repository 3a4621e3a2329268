// Kernel B: non-causal self-attention of the RoBERTa article encoder.
//
// Replaces the library Pallas flash kernel that tell_tpu/models/backbones/
// roberta.py::roberta_encode calls (jax.experimental.pallas.ops.tpu.
// flash_attention, call at :219, gate _flash_ok at :111).
//
//   out[b,t,h,:] = softmax_s(scale * q[b,t,h,:] . k[b,s,h,:] + neg[b,s])
//                  . v[b,s,h,:]
//
// q, k, v, out [B,S,H,hd] with hd = 64 (the [B,S,D] projections reshaped,
// as roberta_encode has them; a row of 64 is contiguous at stride H*hd);
// key_pad [B,S] uint8, 1 = pad. neg is the -1e9 additive key-padding mask
// of the einsum path (roberta.py:206, 227-232), which is the CPU reference:
// every row, pad rows included, matches it (the TPU flash path used segment
// ids instead, so its pad rows differ). fp32 or bf16 storage; fp32 scores,
// softmax, m/l and accumulators.
//
// What bounds it on the H100: arithmetic. At S = 512 each (b, h) does
// 2*2*S*S*hd = 67 MFLOP on 4*S*hd elements of input, so it belongs on the
// tensor cores: bf16 at 989 TFLOP/s; fp32 as 3xTF32, three TF32 products
// per fp32 product at 495 TFLOP/s (one TF32 product keeps about three
// digits; serving is fp32 and is held to the CPU token for token).
//
// What the design does about it:
// 1. Pad tiles are skipped. A block reads its row of key_pad once and marks
//    each 64-key tile that holds a real key; where the row has a real key,
//    tiles of pads only are neither loaded nor computed. This is exact:
//    with a real key present a pad's weight exp(s - 1e9 - m) is 0 in fp32,
//    so a skipped tile would have added exactly 0 to l and o (or been
//    rescaled to 0 later), wherever the pads sit. An all-pad row walks
//    every tile and gives the mean of V, as the einsum path does.
// 2. K/V tiles arrive by 16-byte cp.async into a two-stage ring: the next
//    kept tile is in flight while this one computes. Rows past S are
//    zero-filled and their columns masked with -inf, apart from the -1e9
//    pads. Shared-memory rows are padded by 16 bytes (68 floats, 72 bf16),
//    so every fragment read below is free of bank conflicts.
// 3. FlashAttention-2 on mma.sync: each warp owns 16 query rows, its q
//    fragments loaded once into registers; scores and the output are
//    mma C-fragments in registers, the online softmax runs on them (row
//    max and sum across the 4 lanes of a quad, m from -1e30), and P goes
//    from the score fragments straight into the PV product's A fragments.
//    bf16: m16n8k16, K fragments by ldmatrix, V by ldmatrix.trans, P
//    rounded to bf16 (the plain version rounds the probabilities to q's
//    dtype too). fp32: 3xTF32 m16n8k8, each operand split into hi, x cut
//    to TF32's 10 mantissa bits, and lo, the exact rest x - hi cut the same
//    way, accumulating lo*hi + hi*lo + hi*hi, small terms first. The cut
//    is two masks and a subtraction; cvt.rna.tf32 (round to nearest) on
//    every operand, with exp2f for ex2.approx, made the fp32 kernel 1.4x
//    slower (NVIDIA H100 80GB HBM3, 700 W; PERF.md) and bought no accuracy
//    (both within 1e-6 of float64 in the CPU emulation of
//    tests/test_torch_encoder_attention.py). The score fragment holds keys
//    2c and 2c+1 (c = lane % 4) where the tf32 A fragment wants k = c and
//    c + 4; the order of keys in a contraction is free, so k = c stands for
//    key 2c and k = c + 4 for key 2c + 1, and V's fragment rows follow the
//    same order.
// A block of NW warps owns 16 * NW query rows of one (b, h): 64 where the
// grid has at least two blocks per SM, else 32 (the engine's single
// request, B=1 at S=512, gives 256 blocks, not 128). A row's arithmetic is
// the same in either, and each block reads only its own (b, h) and walks
// its kept tiles in order, so a sequence's output does not depend on B or
// on its neighbours, bit for bit.
#include <stdint.h>

#include "common.cuh"

namespace {

using tt::cp_async16;
using tt::cp_async_commit;
using tt::cp_async_wait;
using tt::ldmatrix_x4;
using tt::ldmatrix_x4_trans;
using tt::mma_3xtf32;
using tt::mma_bf16;
using tt::pack_bf16;
using tt::split_tf32;

constexpr int kHD = 64;   // head dim (RoBERTa-large and -base)
constexpr int kBK = 64;   // keys per tile
constexpr int kKT = kBK / 8;   // n8 score fragments per tile
constexpr int kDT = kHD / 8;   // n8 output fragments
constexpr float kLog2e = 1.4426950408889634f;

// 2^x (ex2.approx: 2 ulp; exp2f adds a denormal fix-up); 0 for -inf
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory row pitch of a K/V tile: 16 bytes past hd, so rows start
// on 16-byte boundaries for cp.async and fragment reads hit 32 banks.
template <typename T>
__host__ __device__ constexpr int pitch() { return kHD + 16 / (int)sizeof(T); }

template <typename T>
__host__ __device__ constexpr size_t tile_bytes() {
  return sizeof(T) * (size_t)kBK * pitch<T>();
}

// K and V, two stages each; the row's pad bytes and one kept flag a tile.
template <typename T>
size_t smem_bytes(int S) {
  return 4 * tile_bytes<T>() + (size_t)S + (size_t)(S + kBK - 1) / kBK;
}

// Issue the cp.async loads of key tile `tile` into ks/vs (rows past S are
// zero-filled, so no stale value meets a zero weight).
template <typename T, int NT>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* k,
                                          const T* v, size_t base, size_t rs,
                                          int tile, int S, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kRowChunks = kHD / kVec;
  constexpr int P = pitch<T>();
  for (int i = tid; i < kBK * kRowChunks; i += NT) {
    const int r = i / kRowChunks, c = (i % kRowChunks) * kVec;
    const int s = tile * kBK + r;
    const bool in = s < S;
    const size_t off = base + (size_t)(in ? s : 0) * rs + c;
    cp_async16(ks + r * P + c, k + off, in);
    cp_async16(vs + r * P + c, v + off, in);
  }
}

// Copies the row's pad bytes to pad[] and marks kept[j] = 1 where tile j
// holds a real key. Returns whether the row has one (if not, every tile is
// walked).
template <int NT>
__device__ __forceinline__ bool mark_tiles(const uint8_t* key_pad,
                                           uint8_t* pad, uint8_t* kept,
                                           int S, int tid) {
  const int nt = (S + kBK - 1) / kBK;
  for (int j = tid; j < nt; j += NT) kept[j] = 0;
  __syncthreads();
  int real = 0;
  for (int s = tid; s < S; s += NT) {
    const uint8_t p = key_pad[s];
    pad[s] = p;
    if (!p) {
      real = 1;
      kept[s / kBK] = 1;
    }
  }
  return __syncthreads_or(real) != 0;
}

__device__ __forceinline__ int next_tile(const uint8_t* kept, bool any_real,
                                         int j, int nt) {
  while (j < nt && any_real && !kept[j]) ++j;
  return j;
}

// ---- fp32: 3xTF32 mma.sync.m16n8k8 ----------------------------------------

// A fragments of q for the warp's 16 rows: qa[ks] holds (row g, dim
// 8ks + c), (g + 8, 8ks + c), (g, 8ks + c + 4), (g + 8, 8ks + c + 4).
struct QFragF32 {
  float a[kHD / 8][4];
};

__device__ __forceinline__ void load_q(QFragF32& f, const float* q,
                                       size_t base, size_t rs, int row0,
                                       int S, int g, int c) {
#pragma unroll
  for (int ks = 0; ks < kHD / 8; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + 8 * (i & 1);
      const int d = 8 * ks + c + 4 * (i >> 1);
      f.a[ks][i] = row < S ? q[base + (size_t)row * rs + d] : 0.f;
    }
}

// s[j] = q . k for keys 8j + 2c, 8j + 2c + 1 of the tile (rows g, g + 8).
__device__ __forceinline__ void scores(float (&s)[kKT][4],
                                       const QFragF32& f, const float* ks,
                                       int lane) {
  constexpr int P = pitch<float>();
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int ks_ = 0; ks_ < kHD / 8; ++ks_) {
    uint32_t ah[4], al[4];
    split_tf32(f.a[ks_], ah, al);
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      const float* kr = ks + (8 * j + g) * P + 8 * ks_ + c;
      mma_3xtf32(s[j], ah, al, kr[0], kr[4]);
    }
  }
}

// o[dn] += p . v: score fragment j gives the A fragment of keys 8j..8j+7
// with k = c standing for key 2c and k = c + 4 for key 2c + 1.
__device__ __forceinline__ void pv(float (&o)[kDT][4],
                                   const float (&p)[kKT][4], const float* vs,
                                   int lane) {
  constexpr int P = pitch<float>();
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int j = 0; j < kKT; ++j) {
    const float a[4] = {p[j][0], p[j][2], p[j][1], p[j][3]};
    uint32_t ah[4], al[4];
    split_tf32(a, ah, al);
    const float* vr = vs + (8 * j + 2 * c) * P + g;
#pragma unroll
    for (int dn = 0; dn < kDT; ++dn)
      mma_3xtf32(o[dn], ah, al, vr[8 * dn], vr[P + 8 * dn]);
  }
}

// ---- bf16: mma.sync.m16n8k16 ----------------------------------------------

// A fragments of q: qa[ks] holds (row g, dims 16ks + 2c, +1),
// (g + 8, same), (g, 16ks + 8 + 2c, +1), (g + 8, same).
struct QFragBF16 {
  uint32_t a[kHD / 16][4];
};

__device__ __forceinline__ void load_q(QFragBF16& f, const __nv_bfloat16* q,
                                       size_t base, size_t rs, int row0,
                                       int S, int g, int c) {
#pragma unroll
  for (int ks = 0; ks < kHD / 16; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + 8 * (i & 1);
      const int d = 16 * ks + 2 * c + 8 * (i >> 1);
      f.a[ks][i] = row < S ? *reinterpret_cast<const uint32_t*>(
                                 q + base + (size_t)row * rs + d)
                           : 0u;
    }
}

// One ldmatrix.x4 gives the B fragments of two n8 key groups for one k16
// step: matrices (keys 8j.., dims 16ks..), (8j.., 16ks + 8..),
// (8j + 8.., 16ks..), (8j + 8.., 16ks + 8..).
__device__ __forceinline__ void scores(float (&s)[kKT][4],
                                       const QFragBF16& f,
                                       const __nv_bfloat16* ks, int lane) {
  constexpr int P = pitch<__nv_bfloat16>();
  const int mat = lane >> 3, row = lane & 7;
#pragma unroll
  for (int ks_ = 0; ks_ < kHD / 16; ++ks_)
#pragma unroll
    for (int j = 0; j < kKT; j += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, ks + (8 * (j + (mat >> 1)) + row) * P + 16 * ks_ +
                         8 * (mat & 1));
      mma_bf16(s[j], f.a[ks_], b[0], b[1]);
      mma_bf16(s[j + 1], f.a[ks_], b[2], b[3]);
    }
}

// Score fragments 2kk and 2kk + 1 form the A fragment of keys 16kk..+15;
// one ldmatrix.x4.trans gives V's B fragments for two n8 dim groups:
// matrices (keys 16kk.., dims 8dn..), (16kk + 8.., 8dn..),
// (16kk.., 8dn + 8..), (16kk + 8.., 8dn + 8..).
__device__ __forceinline__ void pv(float (&o)[kDT][4],
                                   const float (&p)[kKT][4],
                                   const __nv_bfloat16* vs, int lane) {
  constexpr int P = pitch<__nv_bfloat16>();
  const int mat = lane >> 3, row = lane & 7;
#pragma unroll
  for (int kk = 0; kk < kKT / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dn = 0; dn < kDT; dn += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + (16 * kk + 8 * (mat & 1) + row) * P +
                               8 * (dn + (mat >> 1)));
      mma_bf16(o[dn], a, b[0], b[1]);
      mma_bf16(o[dn + 1], a, b[2], b[3]);
    }
  }
}

template <typename T>
struct Frag;
template <>
struct Frag<float> {
  using Q = QFragF32;
};
template <>
struct Frag<__nv_bfloat16> {
  using Q = QFragBF16;
};

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

template <typename T, int NW>
__global__ void __launch_bounds__(NW * 32)
encoder_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const uint8_t* __restrict__ key_pad,
                         T* __restrict__ out, int S, int H, float scale) {
  constexpr int NT = NW * 32;
  constexpr int P = pitch<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* kv = reinterpret_cast<T*>(smem);  // [2 stages][K, V][kBK, P]
  uint8_t* pad = smem + 4 * tile_bytes<T>();  // [S]
  uint8_t* kept = pad + S;                    // [nt]

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int row0 = blockIdx.x * 16 * NW + 16 * warp;
  const size_t rs = (size_t)H * kHD;  // stride between sequence positions
  const size_t base = (size_t)b * S * rs + (size_t)h * kHD;
  const int nt = (S + kBK - 1) / kBK;

  const bool any_real =
      mark_tiles<NT>(key_pad + (size_t)b * S, pad, kept, S, tid);
  int j = next_tile(kept, any_real, 0, nt);
  load_tile<T, NT>(kv, kv + kBK * P, k, v, base, rs, j, S, tid);
  cp_async_commit();

  typename Frag<T>::Q qf;
  load_q(qf, q, base, rs, row0, S, g, c);
  float o[kDT][4], m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int dn = 0; dn < kDT; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dn][i] = 0.f;

  for (int stage = 0; j < nt; stage ^= 1) {
    const int jn = next_tile(kept, any_real, j + 1, nt);
    if (jn < nt) {
      T* nk = kv + (stage ^ 1) * 2 * kBK * P;
      load_tile<T, NT>(nk, nk + kBK * P, k, v, base, rs, jn, S, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile j visible to every warp
    const T* ks = kv + stage * 2 * kBK * P;
    const T* vs = ks + kBK * P;

    float s[kKT][4];
#pragma unroll
    for (int jj = 0; jj < kKT; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[jj][i] = 0.f;
    scores(s, qf, ks, lane);

    // scale, mask, online softmax on the fragments: element i of s[jj]
    // is row g + 8 * (i >> 1), key j * kBK + 8 * jj + 2c + (i & 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jj = 0; jj < kKT; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * kBK + 8 * jj + 2 * c + e;
        const float neg = col < S ? (pad[col] ? -1e9f : 0.f) : -INFINITY;
        s[jj][e] = s[jj][e] * scale + neg;
        s[jj][2 + e] = s[jj][2 + e] * scale + neg;
        mx[0] = fmaxf(mx[0], s[jj][e]);
        mx[1] = fmaxf(mx[1], s[jj][2 + e]);
      }
    float al[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      al[r] = ex2((m[r] - m_new) * kLog2e);
      m[r] = m_new;
      l[r] *= al[r];
    }
#pragma unroll
    for (int jj = 0; jj < kKT; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[jj][i] = ex2((s[jj][i] - m[i >> 1]) * kLog2e);
        l[i >> 1] += s[jj][i];  // this lane's share of the row sum
      }
#pragma unroll
    for (int dn = 0; dn < kDT; ++dn)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[dn][i] *= al[i >> 1];
    pv(o, s, vs, lane);
    __syncthreads();  // tile j consumed before its stage refills
    j = jn;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + g + 8 * r;
    if (row >= S) continue;
    const float inv = 1.f / l[r];
    T* dst = out + base + (size_t)row * rs + 2 * c;
#pragma unroll
    for (int dn = 0; dn < kDT; ++dn)
      store2(dst + 8 * dn, o[dn][2 * r] * inv, o[dn][2 * r + 1] * inv);
  }
}

template <typename T, int NW>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                   const void* key_pad, void* out, int B, int S, int H,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(S);
  cudaError_t err = tt::allow_smem(encoder_attention_kernel<T, NW>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + 16 * NW - 1) / (16 * NW), H, B);
  encoder_attention_kernel<T, NW><<<grid, NW * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(key_pad),
      static_cast<T*>(out), S, H, scale);
  return cudaGetLastError();
}

// 64 query rows a block where that still gives every SM two blocks, else
// 32 (the choice changes no bit of the output).
template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* key_pad, void* out, int B, int S, int H,
                   float scale, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long blocks64 = (long)((S + 63) / 64) * H * B;
  if (blocks64 >= 2L * sms)
    return launch_rows<T, 4>(q, k, v, key_pad, out, B, S, H, scale, stream);
  return launch_rows<T, 2>(q, k, v, key_pad, out, B, S, H, scale, stream);
}

}  // namespace

extern "C" int tt_encoder_attention(const void* q, const void* k,
                                    const void* v, const void* key_pad,
                                    void* out, int B, int S, int H, int hd,
                                    float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd != kHD) return cudaErrorInvalidValue;  // RoBERTa's head dim
  if (dtype == tt::kFloat32)
    return launch<float>(q, k, v, key_pad, out, B, S, H, scale, st);
  if (dtype == tt::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, key_pad, out, B, S, H, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* tt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
