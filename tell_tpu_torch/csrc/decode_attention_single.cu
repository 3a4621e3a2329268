// Kernel F: single-shot decode cross-attention, over an fp K/V cache or a
// nibble-packed int4 one contracted in two halves.
//
// Kernel F replaces the single-shot Pallas kernels of the JAX package's
// decode-attention measurement tools:
//   tools/kernel_variants.py::fused_batched (_kernel_batched, pallas_call
//     at :51), the head-batched form at BB = 2 or 4 batch rows per step;
//   tools/kernel_variants.py::fused_q4split (_kernel_q4split, pallas_call
//     at :111), the int4 form that contracts each nibble half against its
//     half of q and writes the two output halves separately;
//   the inline fn of tools/longctx_variants.py:52, the package's
//     single-shot _kernel forced to BB = 1.
//
//   out[b,h,x,:] = sum_s p[x,s] v[b,h,:,s],
//   p[x,:] = round(softmax_s(q[b,h,x,:] . k[b,h,:,s] + bias[b,x,s]))  (fp)
//   p[x,:] = round(softmax_s((q . k4[:,s]) k_scale[s] + bias[x,s])
//                  * v_scale[s])                                  (int4)
//
// q [B,H,MG,hd]; k, v [B,H,hd,S] in q's dtype, or for the int4 form packed
// [B,H,hd/2,S] bytes (row d in the low nibble, row d+hd/2 in the high one,
// signed in [-7,7]) with fp32 per-column scales [B,H,1,S]; bias [B,MG,S]
// fp32 (0 or -inf); out [B,H,MG,hd]. Scores, softmax and sums in fp32;
// round() casts the normalised probabilities to q's dtype before the PV
// product, as the TPU kernels and the plain versions do (bf16 rounds
// after normalising here, where kernel A rounds its unnormalised online
// weights: compare F with the plain version, not with A).
//
// What bounds it on the H100: the K/V stream, the same bytes as kernel A
// (2*B*H*hd*S elements per call; half a byte each plus 8 bytes of scales
// per column for int4). MG*S*hd multiply-adds per contraction are far
// below the card's compute for those bytes.
//
// What the design does: the exact single-shot form, which the port had
// not tried (kernel A runs one online-softmax path for every S). One block
// per (group of bb batch rows, head) walks its bb rows in turn. q sits in
// shared memory; pass 1 walks K in 64-column tiles with threads along S
// (the contiguous axis, so loads coalesce) and writes the fp32 scores plus
// the bias for all MG rows into a shared [MG, S] row; one warp per row
// takes the exact max, the exponentials, the sum and the normalised,
// rounded probabilities; pass 2 walks V once and accumulates [MG, hd].
// The int4 form reads each byte once and unpacks it into the tile's rows d
// and d+hd/2, so the low half of the tile meets q[:, :hd/2] and the high
// half q[:, hd/2:], two partial sums, and the output halves follow.
//
// Shared memory is the limit: (MG*S + 2*MG*hd + hd*65) floats, 201 KB at
// MG=20, hd=64, S=2173; above 48 KB a launch needs cudaFuncSetAttribute for
// its instantiation, and past the 232,448 bytes a block may use (S > ~2560
// at MG=20) the wrapper refuses before launch, the counterpart of the TPU's
// _pick_bb finding no fit. At ~200 KB one block fits an SM.
//
// This first version is simple and right, not yet fast: mma/wgmma tiles
// for the two contractions, split-S across blocks with a merge, and TMA
// loads of the K/V tiles are later work.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTile = 64;          // source columns per K/V tile
constexpr int kTileP = kTile + 1;  // padded smem row: conflict-free reads
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemLimit = 232448;  // bytes a block may use on Hopper

// The dynamic shared memory of one block (the wrapper checks the same
// size against the same limit before launching).
size_t smem_bytes(int MG, int hd, int S) {
  return sizeof(float) * ((size_t)MG * S + 2 * (size_t)MG * hd +
                          (size_t)hd * kTileP);
}

// One [hd, kTile] tile of K or V at columns s0.. into shared memory as
// fp32, threads along S; columns past S read as 0. The int4 form reads
// each byte once: its low nibble is row d, its high nibble row d + hd/2.
template <typename KvT, bool kInt4>
__device__ __forceinline__ void load_tile(float* tile,
                                          const KvT* __restrict__ src,
                                          int hd, int S, int s0) {
  if constexpr (kInt4) {
    const int hd2 = hd / 2;
    for (int i = threadIdx.x; i < hd2 * kTile; i += kThreads) {
      const int d = i / kTile, j = i % kTile, s = s0 + j;
      const int byte = s < S ? (src[(size_t)d * S + s] & 0xff) : 0;
      tile[d * kTileP + j] = (float)tt::nibble(byte & 15);
      tile[(d + hd2) * kTileP + j] = (float)tt::nibble(byte >> 4);
    }
  } else {
    for (int i = threadIdx.x; i < hd * kTile; i += kThreads) {
      const int d = i / kTile, j = i % kTile, s = s0 + j;
      tile[d * kTileP + j] = s < S ? tt::to_f32(src[(size_t)d * S + s]) : 0.f;
    }
  }
}

template <typename T, bool kInt4>
__global__ void __launch_bounds__(kThreads)
single_shot_kernel(const T* __restrict__ q, const void* __restrict__ k,
                   const void* __restrict__ v,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const float* __restrict__ bias, T* __restrict__ out,
                   int H, int MG, int hd, int S, int bb) {
  using KvT = typename std::conditional<kInt4, int8_t, T>::type;
  extern __shared__ float smem[];
  float* sc = smem;                  // [MG, S]: scores, then probabilities
  float* qs = sc + (size_t)MG * S;   // [MG, hd]
  float* acc = qs + MG * hd;         // [MG, hd]
  float* tile = acc + MG * hd;       // [hd, kTileP]: a K tile, then a V tile

  const int h = blockIdx.x % H;
  const int b0 = (blockIdx.x / H) * bb;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nq = MG * hd;
  const int hd2 = hd / 2;
  const int hd_store = kInt4 ? hd2 : hd;

  for (int r = 0; r < bb; ++r) {
    const int b = b0 + r;
    const size_t bh = (size_t)b * H + h;
    const T* qb = q + bh * nq;
    const KvT* kb = static_cast<const KvT*>(k) + bh * hd_store * S;
    const KvT* vb = static_cast<const KvT*>(v) + bh * hd_store * S;
    const float* biasb = bias + (size_t)b * MG * S;
    const float* kscb = kInt4 ? k_scale + bh * S : nullptr;
    const float* vscb = kInt4 ? v_scale + bh * S : nullptr;

    // each thread owns the same entries i of qs and acc in every loop
    // over nq, so the previous row's output loop needs no barrier here
    for (int i = tid; i < nq; i += kThreads) {
      qs[i] = tt::to_f32(qb[i]);
      acc[i] = 0.f;
    }
    __syncthreads();

    // pass 1: scores [MG, S] = q . K (* k_scale) + bias
    for (int s0 = 0; s0 < S; s0 += kTile) {
      load_tile<KvT, kInt4>(tile, kb, hd, S, s0);
      __syncthreads();
      for (int i = tid; i < MG * kTile; i += kThreads) {
        const int x = i / kTile, j = i % kTile, s = s0 + j;
        if (s >= S) continue;
        const float* qr = qs + x * hd;
        float dot;
        if constexpr (kInt4) {
          float lo = 0.f, hi = 0.f;
          for (int d = 0; d < hd2; ++d) lo += qr[d] * tile[d * kTileP + j];
          for (int d = hd2; d < hd; ++d) hi += qr[d] * tile[d * kTileP + j];
          dot = (lo + hi) * kscb[s];
        } else {
          dot = 0.f;
          for (int d = 0; d < hd; ++d) dot += qr[d] * tile[d * kTileP + j];
        }
        sc[(size_t)x * S + s] = dot + biasb[(size_t)x * S + s];
      }
      __syncthreads();
    }

    // the exact softmax of each row, one warp per row; the max starts at
    // -1e30 as in the TPU kernels. The normalised p (times v_scale for
    // int4) is rounded to q's dtype before the PV product.
    for (int x = warp; x < MG; x += kWarps) {
      float* row = sc + (size_t)x * S;
      float mx = -1e30f;
      for (int s = lane; s < S; s += 32) mx = fmaxf(mx, row[s]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
      for (int s = lane; s < S; s += 32) {
        const float e = expf(row[s] - mx);
        row[s] = e;
        sum += e;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      for (int s = lane; s < S; s += 32) {
        float p = row[s] / sum;
        if constexpr (kInt4) p *= vscb[s];
        row[s] = tt::round_to<T>(p);
      }
    }
    __syncthreads();

    // pass 2: acc [MG, hd] += p . V^T, V walked once
    for (int s0 = 0; s0 < S; s0 += kTile) {
      load_tile<KvT, kInt4>(tile, vb, hd, S, s0);
      __syncthreads();
      const int n = min(kTile, S - s0);
      for (int i = tid; i < nq; i += kThreads) {
        const int x = i / hd, d = i % hd;
        const float* pr = sc + (size_t)x * S + s0;
        const float* vr = tile + d * kTileP;
        float sum = 0.f;
        for (int j = 0; j < n; ++j) sum += pr[j] * vr[j];
        acc[i] += sum;
      }
      __syncthreads();
    }

    T* ob = out + bh * nq;
    for (int i = tid; i < nq; i += kThreads) ob[i] = tt::from_f32<T>(acc[i]);
  }
}

template <typename T, bool kInt4>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_scale, const void* v_scale,
                   const void* bias, void* out, int B, int H, int MG, int hd,
                   int S, int bb, cudaStream_t stream) {
  if (bb < 1 || B % bb != 0 || S < 1 || (kInt4 && hd % 2 != 0))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(MG, hd, S);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = tt::allow_smem(single_shot_kernel<T, kInt4>, smem);
  if (err != cudaSuccess) return err;
  single_shot_kernel<T, kInt4><<<(B / bb) * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), k, v, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const float*>(bias),
      static_cast<T*>(out), H, MG, hd, S, bb);
  return cudaGetLastError();
}

template <bool kInt4>
int dispatch(const void* q, const void* k, const void* v,
             const void* k_scale, const void* v_scale, const void* bias,
             void* out, int B, int H, int MG, int hd, int S, int bb,
             int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tt::kFloat32)
    return launch<float, kInt4>(q, k, v, k_scale, v_scale, bias, out, B, H,
                                MG, hd, S, bb, st);
  if (dtype == tt::kBFloat16)
    return launch<__nv_bfloat16, kInt4>(q, k, v, k_scale, v_scale, bias, out,
                                        B, H, MG, hd, S, bb, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Kernel F over an fp cache: q, k, v in the dtype `dtype`.
extern "C" int tt_decode_attention_single(const void* q, const void* k,
                                          const void* v, const void* bias,
                                          void* out, int B, int H, int MG,
                                          int hd, int S, int bb, int dtype,
                                          void* stream) {
  return dispatch<false>(q, k, v, nullptr, nullptr, bias, out, B, H, MG, hd,
                         S, bb, dtype, stream);
}

// Kernel F's int4-split form: q in `dtype`; k4, v4 packed int4
// [B,H,hd/2,S]; k_scale, v_scale fp32 [B,H,1,S].
extern "C" int tt_decode_attention_q4split(const void* q, const void* k4,
                                           const void* k_scale,
                                           const void* v4,
                                           const void* v_scale,
                                           const void* bias, void* out, int B,
                                           int H, int MG, int hd, int S,
                                           int bb, int dtype, void* stream) {
  return dispatch<true>(q, k4, v4, k_scale, v_scale, bias, out, B, H, MG, hd,
                        S, bb, dtype, stream);
}
