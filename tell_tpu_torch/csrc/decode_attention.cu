// Kernel A: multi-context decode cross-attention, and kernel D: the same
// over an int8 or nibble-packed int4 K/V cache.
//
// Kernel A replaces tell_tpu/ops/kernels/decode_attention.py::
// fused_decode_attention (_kernel, pallas_call at :216) and its S-tiled
// form _tiled_decode_attention (_kernel_tiled, pallas_call at :177).
// Kernel D replaces fused_decode_attention_q8 (_kernel_q8, pallas_call at
// :399) and _tiled_decode_attention_q8 (_kernel_q8_tiled, pallas_call at
// :347), int8 and int4 (unpack_int4, :238-249).
//
//   out[b,h,x,:] = softmax_s(q[b,h,x,:] . k[b,h,:,s] + bias[b,x,s])
//                  . v[b,h,:,s]                                    (A)
//   out[b,h,x,:] = sum_s softmax_s((q . k8[:,s]) * k_scale[s] + bias[x,s])
//                  * v_scale[s] * v8[:,s]                          (D)
//
// q [B,H,MG,hd]; k, v [B,H,hd,S] (head-major, transposed, as the JAX decode
// state stores them), for D int8 [B,H,hd,S] or packed int4 [B,H,hd/2,S]
// (byte d holds row d in its low nibble and row d+hd/2 in its high nibble,
// signed in [-7,7]) with fp32 per-column scales [B,H,1,S]; bias [B,MG,S]
// fp32 (0 or -inf); out [B,H,MG,hd]. q in fp32 or bf16, fp32 scores,
// softmax and accumulators.
//
// What bounds both on the H100: the K/V stream, 2*B*H*S*hd elements per
// layer per decode step (fp32 or bf16 for A; one byte for int8, half a byte
// for int4, plus 8 bytes of scales per column for D). The query side is
// tiny (MG = 4 greedy or 20 beam-5 rows of hd = 64), so these are bandwidth
// kernels: int8 moves a quarter of A's fp32 bytes, int4 an eighth.
//
// What the design does about it: one block per (b, h) reads its K/V stripe
// exactly once and uses every element for all MG query rows (the modality
// and beam axes are folded onto the query axis, as on the TPU). q stays in
// shared memory; S is walked in tiles of 64 columns inside the block with an
// online softmax, so there is one path for every S (the TPU needed a second
// kernel when a stripe did not fit VMEM). A tile is read with threads along
// S, which is the contiguous axis of the [hd, S] layout, so loads coalesce.
// D dequantises on load, exactly (int8 and int4 values are exact in fp32):
// int8 by a cast, int4 by sign-extending each nibble in int32, one byte
// feeding rows d and d+hd/2. Its scales load with the tile: k_scale scales
// the tile's scores; the running sum l adds the raw exponentials while the
// PV product takes them times v_scale (the TPU's tiled q8 kernel).
// The running max starts at -1e30 as in the TPU kernels, so a tile whose
// columns are all masked gives weights of exactly 0 and no NaN. The ragged
// last tile reads nothing past S: K/V and both scales read as 0 there, and
// the scores as -inf.
// Not yet done (later work): split-S across blocks to fill all 132 SMs at
// small B*H, vectorised 16-byte loads and a cp.async/TMA double buffer.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTile = 64;          // source columns per tile (2 per lane)
constexpr int kTileP = kTile + 1;  // padded smem row: conflict-free reads
constexpr int kThreads = 256;
static_assert(kTile == 64, "the softmax step gives each lane 2 columns");

// How K/V are stored: the query's dtype (kernel A), int8, or packed int4.
enum KvMode { kKvFp = 0, kKvInt8 = 1, kKvInt4 = 2 };

template <typename T, int kKv>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const void* __restrict__ k,
                        const void* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const float* __restrict__ bias, T* __restrict__ out,
                        int H, int MG, int hd, int S) {
  using KvT = typename std::conditional<kKv == kKvFp, T, int8_t>::type;
  constexpr bool kQuant = kKv != kKvFp;
  extern __shared__ float smem[];
  float* qs = smem;                // [MG, hd]
  float* acc = qs + MG * hd;       // [MG, hd]
  float* ks = acc + MG * hd;       // [hd, kTileP]
  float* vs = ks + hd * kTileP;    // [hd, kTileP]
  float* ps = vs + hd * kTileP;    // [MG, kTile]
  float* m_run = ps + MG * kTile;  // [MG]
  float* l_run = m_run + MG;       // [MG]
  float* alpha = l_run + MG;       // [MG]
  float* ksc = alpha + MG;         // [kTile] (kernel D only)
  float* vsc = ksc + kTile;        // [kTile] (kernel D only)

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  constexpr int kWarps = kThreads / 32;
  const int nq = MG * hd;
  const int hd_store = kKv == kKvInt4 ? hd / 2 : hd;
  const T* qb = q + (size_t)bh * nq;
  const KvT* kb = static_cast<const KvT*>(k) + (size_t)bh * hd_store * S;
  const KvT* vb = static_cast<const KvT*>(v) + (size_t)bh * hd_store * S;
  const float* bb = bias + (size_t)b * MG * S;

  for (int i = tid; i < nq; i += kThreads) {
    qs[i] = tt::to_f32(qb[i]);
    acc[i] = 0.f;
  }
  for (int x = tid; x < MG; x += kThreads) {
    m_run[x] = -1e30f;
    l_run[x] = 0.f;
  }
  __syncthreads();

  for (int s0 = 0; s0 < S; s0 += kTile) {
    // 1. K/V tile [hd, kTile] in fp32; the ragged tail reads as zeros
    if constexpr (kKv == kKvInt4) {
      // one byte of row d feeds rows d (low nibble) and d + hd/2 (high)
      for (int i = tid; i < hd_store * kTile; i += kThreads) {
        const int d = i / kTile, j = i % kTile, s = s0 + j;
        int kx = 0, vx = 0;
        if (s < S) {
          kx = kb[(size_t)d * S + s] & 0xff;
          vx = vb[(size_t)d * S + s] & 0xff;
        }
        ks[d * kTileP + j] = (float)tt::nibble(kx & 15);
        ks[(d + hd_store) * kTileP + j] = (float)tt::nibble(kx >> 4);
        vs[d * kTileP + j] = (float)tt::nibble(vx & 15);
        vs[(d + hd_store) * kTileP + j] = (float)tt::nibble(vx >> 4);
      }
    } else {
      for (int i = tid; i < hd * kTile; i += kThreads) {
        const int d = i / kTile, j = i % kTile, s = s0 + j;
        const bool in = s < S;
        if constexpr (kQuant) {
          ks[d * kTileP + j] = in ? (float)kb[(size_t)d * S + s] : 0.f;
          vs[d * kTileP + j] = in ? (float)vb[(size_t)d * S + s] : 0.f;
        } else {
          ks[d * kTileP + j] = in ? tt::to_f32(kb[(size_t)d * S + s]) : 0.f;
          vs[d * kTileP + j] = in ? tt::to_f32(vb[(size_t)d * S + s]) : 0.f;
        }
      }
    }
    if constexpr (kQuant) {
      const float* kscb = k_scale + (size_t)bh * S;
      const float* vscb = v_scale + (size_t)bh * S;
      for (int j = tid; j < kTile; j += kThreads) {
        const int s = s0 + j;
        ksc[j] = s < S ? kscb[s] : 0.f;
        vsc[j] = s < S ? vscb[s] : 0.f;
      }
    }
    __syncthreads();
    // 2. scores [MG, kTile] = q . K (* k_scale) + bias, -inf past S
    for (int i = tid; i < MG * kTile; i += kThreads) {
      const int x = i / kTile, j = i % kTile, s = s0 + j;
      float sc = -INFINITY;
      if (s < S) {
        const float* qr = qs + x * hd;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot += qr[d] * ks[d * kTileP + j];
        if constexpr (kQuant) dot *= ksc[j];
        sc = dot + bb[(size_t)x * S + s];
      }
      ps[i] = sc;
    }
    __syncthreads();
    // 3. online softmax, one warp per query row; l adds the raw weights,
    //    the PV product takes them times v_scale
    for (int x = warp; x < MG; x += kWarps) {
      float* row = ps + x * kTile;
      const float a = row[lane], c = row[lane + 32];
      float mx = fmaxf(a, c);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_run[x];
      const float m_new = fmaxf(m_old, mx);
      const float ea = expf(a - m_new), ec = expf(c - m_new);
      if constexpr (kQuant) {
        row[lane] = ea * vsc[lane];
        row[lane + 32] = ec * vsc[lane + 32];
      } else {
        row[lane] = ea;
        row[lane + 32] = ec;
      }
      float sum = ea + ec;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float al = expf(m_old - m_new);
        alpha[x] = al;
        l_run[x] = l_run[x] * al + sum;
        m_run[x] = m_new;
      }
    }
    __syncthreads();
    // 4. acc = acc * alpha + p . V^T
    for (int i = tid; i < nq; i += kThreads) {
      const int x = i / hd, d = i % hd;
      const float* pr = ps + x * kTile;
      const float* vr = vs + d * kTileP;
      float sum = 0.f;
      for (int j = 0; j < kTile; ++j) sum += pr[j] * vr[j];
      acc[i] = acc[i] * alpha[x] + sum;
    }
    __syncthreads();
  }

  T* ob = out + (size_t)bh * nq;
  for (int i = tid; i < nq; i += kThreads)
    ob[i] = tt::from_f32<T>(acc[i] / l_run[i / hd]);
}

template <typename T, int kKv>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_scale, const void* v_scale,
                   const void* bias, void* out, int B, int H, int MG, int hd,
                   int S, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (2 * (size_t)MG * hd + 2 * (size_t)hd * kTileP + (size_t)MG * kTile +
       3 * (size_t)MG + (kKv == kKvFp ? 0 : 2 * (size_t)kTile));
  cudaError_t err = tt::allow_smem(decode_attention_kernel<T, kKv>, smem);
  if (err != cudaSuccess) return err;
  decode_attention_kernel<T, kKv><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), k, v, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const float*>(bias),
      static_cast<T*>(out), H, MG, hd, S);
  return cudaGetLastError();
}

template <int kKv>
int dispatch(const void* q, const void* k, const void* v,
             const void* k_scale, const void* v_scale, const void* bias,
             void* out, int B, int H, int MG, int hd, int S, int dtype,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tt::kFloat32)
    return launch<float, kKv>(q, k, v, k_scale, v_scale, bias, out, B, H, MG,
                              hd, S, st);
  if (dtype == tt::kBFloat16)
    return launch<__nv_bfloat16, kKv>(q, k, v, k_scale, v_scale, bias, out,
                                      B, H, MG, hd, S, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Kernel A: q, k, v in the dtype `dtype`.
extern "C" int tt_decode_attention(const void* q, const void* k,
                                   const void* v, const void* bias, void* out,
                                   int B, int H, int MG, int hd, int S,
                                   int dtype, void* stream) {
  return dispatch<kKvFp>(q, k, v, nullptr, nullptr, bias, out, B, H, MG, hd,
                         S, dtype, stream);
}

// Kernel D: q in `dtype`; k8, v8 int8 [B,H,hd,S] (packed4 = 0) or packed
// int4 [B,H,hd/2,S] (packed4 = 1); k_scale, v_scale fp32 [B,H,1,S].
extern "C" int tt_decode_attention_q8(const void* q, const void* k8,
                                      const void* k_scale, const void* v8,
                                      const void* v_scale, const void* bias,
                                      void* out, int B, int H, int MG, int hd,
                                      int S, int packed4, int dtype,
                                      void* stream) {
  if (packed4)
    return dispatch<kKvInt4>(q, k8, v8, k_scale, v_scale, bias, out, B, H,
                             MG, hd, S, dtype, stream);
  return dispatch<kKvInt8>(q, k8, v8, k_scale, v_scale, bias, out, B, H, MG,
                           hd, S, dtype, stream);
}
