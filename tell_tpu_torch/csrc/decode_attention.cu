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
// kernels. The bias [B,MG,S] is read once per head, from L2.
//
// Kernel A, in three parts:
// 1. Split-S. S is cut into chunks of kChunk = 256 columns; block
//    (b*H + h, c) owns chunk c of one (b, h) stripe, so B*H*ceil(S/256)
//    blocks share the 132 SMs (384 at the flagship's B=8, S=637, where one
//    block per (b, h) gave 128). A block's softmax max starts at -1e30, so
//    that a chunk whose columns are all masked for a row gives weights of
//    exactly 0 and no NaN, and it writes its partial (m, l, acc[MG, hd])
//    in fp32 to a scratch the wrapper allocates; a second kernel combines
//    the partials in chunk order and writes out. With one chunk the block
//    writes out itself. A chunk whose columns are all masked for a row has
//    m = -1e30, l = 0, acc = 0 and weight exactly 0 in the combine.
//    Why S alone sets the number of chunks: the chunk width is fixed, so a
//    (b, h) row sums in the same order whatever B and H are, and its output
//    is the same bits at B=1 and B=8; the engine's slots are held to a
//    one-shot search on that. Picking splits from B*H to fill the SMs (the
//    usual flash-decoding rule) would change the order with the batch.
// 2. Register tiles. Thread t owns column t of the chunk for the scores:
//    its K values go from device memory into registers and meet q, read
//    from shared memory as float4 broadcasts, so one shared-memory read
//    feeds four FMAs and K never passes through shared memory. The chunk's
//    softmax is exact (max, exp, sum by warp shuffles), not online. For
//    the PV product warp w sums its 32 columns for a pass of up to 10 rows
//    and all head dims, lane the dims lane + 32i, the accumulator in
//    registers: each V float4 feeds the pass's rows, each broadcast p
//    float4 the lane's dims (at most a quarter of a shared-memory read
//    per FMA; the old kernel read two per FMA). The 8 warps' partials are
//    added in warp order through shared memory. At MG = 20 these
//    shared-memory reads, not the bytes or the FMAs, set the time: the
//    readings fit a 16-byte read costing four of the SM's shared-memory
//    cycles even when all lanes read the same address.
// 3. Loads in flight. Each thread streams its K and V columns 16 rows a
//    step, the next step's loads issued before this step's math, and no
//    barrier stands between a block's loads. Register staging takes any
//    alignment: the flagship's odd S starts rows on 4-byte (fp32) and
//    2-byte (bf16) boundaries, which 16-byte loads and, for bf16,
//    cp.async cannot take. This access pattern alone, with no math,
//    streams at most about 2.8 TB/s on an H100
//    (tell_tpu_torch/tools/stream_probe.cu): the ceiling the kernel is
//    held to where the bytes set its time (MG = 4).
// Left for later work: mma.sync tiles (bf16, or 3xTF32 for fp32), which
// take q, p and V from registers, for MG = 20; TMA or 16-byte loads, which
// need a padded-S layout (the flagship's S of 637 and 2173 is odd, so a
// row's pitch is not a multiple of 16 bytes).
//
// Kernel D keeps one block per (b, h), q and the accumulator in shared
// memory, and walks S in 64-column tiles with an online softmax whose
// running max starts at -1e30 (a masked tile weighs 0). It dequantises on
// load,
// exactly (int8 and int4 values are exact in fp32): int8 by a cast, int4
// by sign-extending each nibble in int32, one byte feeding rows d and
// d+hd/2. Its scales load with the tile: k_scale scales the tile's scores;
// the running sum l adds the raw exponentials while the PV product takes
// them times v_scale (the TPU's tiled q8 kernel). The ragged last tile
// reads nothing past S: K/V and both scales read as 0 there, and the
// scores as -inf.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kTile = 64;          // kernel D: source columns per tile
constexpr int kTileP = kTile + 1;  // kernel D's padded smem row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;   // kernel A: source columns per block
constexpr int kSlice = 16;         // kernel A: K/V rows per load step
constexpr int kVP = kChunk + 4;    // kernel A's V row pitch
static_assert(kTile == 64, "D's softmax step gives each lane 2 columns");

// c + a . b, four FMAs
__device__ __forceinline__ float dot4(float4 a, float4 b, float c) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, c))));
}

// The next kSlice rows of one K column and one V column (row stride S),
// advancing both pointers past them; zeros past the source.
template <typename T>
__device__ __forceinline__ void load_slice(T (&kr)[kSlice], T (&vr)[kSlice],
                                           const T*& kp, const T*& vp,
                                           bool in, int S) {
  const T zero = tt::from_f32<T>(0.f);
#pragma unroll
  for (int e = 0; e < kSlice; ++e) {
    kr[e] = in ? *kp : zero;
    vr[e] = in ? *vp : zero;
    kp += S;
    vp += S;
  }
}

// Kernel A's rows per PV pass: all of them up to 8, else 10 (kRows = 20)
// or 8, a divisor of kRows.
template <int kRows>
__host__ __device__ constexpr int pass_rows() {
  return kRows <= 8 ? kRows : kRows % 10 == 0 && kRows < 40 ? 10 : 8;
}

// Kernel A's shared memory in floats: q [kRows][kHd], V [kHd][kVP], the
// scores then p [kRows][kChunk], one PV pass's warp partials
// [kWarps][pass rows][kHd], l [kRows].
template <int kHd, int kRows>
constexpr int chunk_smem_floats() {
  return kRows * kHd + kHd * kVP + kRows * kChunk +
         kWarps * pass_rows<kRows>() * kHd + kRows;
}

// Kernel A: block (b*H + h, c) takes chunk c (kChunk columns) of one (b, h)
// stripe, for MG <= kRows query rows of head dim kHd.
//   Scores: thread t owns column s = c*kChunk + t. It streams its K and V
//   columns from device memory kSlice rows a step, the next step's loads
//   in flight while this step's are used, with no barrier in between: K
//   goes from registers into the kRows scores (each broadcast q float4
//   feeds four FMAs), V into shared memory.
//   Softmax: warp w takes rows w + 8r of the chunk's [kRows, kChunk]
//   scores, max and sum by shuffles, from -1e30.
//   PV, in passes of up to 10 rows: warp w sums its 32 columns, lane the
//   head dims lane + 32i (each V float4 feeds the pass's rows, each
//   broadcast p float4 the lane's dims); the 8 warps' partials are added
//   in warp order, so the sum is the same every launch.
// n_split > 1: write the partial (acc[MG, hd], m[MG], l[MG]) to
// part[(bh * n_split + c) * MG * (hd + 2)]; n_split == 1: write out.
template <typename T, int kHd, int kRows>
__global__ void __launch_bounds__(kThreads, kHd <= 64 ? 2 : 1)
decode_attention_chunk_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const float* __restrict__ bias,
                              float* __restrict__ part, T* __restrict__ out,
                              int H, int MG, int S, int n_split) {
  constexpr int kPR = pass_rows<kRows>();
  constexpr int kC = kHd / 32;  // PV head dims per lane
  static_assert(kHd % kSlice == 0 && kHd % 32 == 0 && kRows % kPR == 0,
                "kernel A's tiling");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][kHd]
  float* vs = qs + kRows * kHd;                 // [kHd][kVP]
  float* ps = vs + kHd * kVP;                   // [kRows][kChunk]
  float* red = ps + kRows * kChunk;             // [kWarps][kPR][kHd]
  float* l_s = red + kWarps * kPR * kHd;        // [kRows]

  const int bh = blockIdx.x, chunk = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int nq = MG * kHd;
  const int s_begin = chunk * kChunk;
  const bool in = s_begin + tid < S;
  const int s = in ? s_begin + tid : s_begin;  // this thread's column
  const T* kp = k + (size_t)bh * kHd * S + s;
  const T* vp = v + (size_t)bh * kHd * S + s;
  float* rec = part + ((size_t)bh * n_split + chunk) * MG * (kHd + 2);

  T kn[kSlice], vn[kSlice];
  load_slice(kn, vn, kp, vp, in, S);
  const T* qb = q + (size_t)bh * nq;
  for (int i = tid; i < kRows * kHd; i += kThreads)
    qs[i] = i < nq ? tt::to_f32(qb[i]) : 0.f;
  __syncthreads();

  // 1. scores of this column; its V column into shared memory
  float sc[kRows];
#pragma unroll
  for (int x = 0; x < kRows; ++x) sc[x] = 0.f;
#pragma unroll 1
  for (int st = 0; st < kHd / kSlice; ++st) {
    // this step's V rows to shared memory, then the next step's loads
    // go out before this step's math
    T kc[kSlice];
#pragma unroll
    for (int e = 0; e < kSlice; ++e) {
      kc[e] = kn[e];
      vs[(st * kSlice + e) * kVP + tid] = tt::to_f32(vn[e]);
    }
    if (st + 1 < kHd / kSlice) load_slice(kn, vn, kp, vp, in, S);
    float kf[kSlice];
#pragma unroll
    for (int e = 0; e < kSlice; ++e) kf[e] = tt::to_f32(kc[e]);
#pragma unroll
    for (int x = 0; x < kRows; ++x) {
      const float* qd = qs + x * kHd + st * kSlice;
#pragma unroll
      for (int e = 0; e < kSlice; e += 4)
        sc[x] = dot4(*reinterpret_cast<const float4*>(qd + e),
                     make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]),
                     sc[x]);
    }
  }
  const float* bcol = bias + (size_t)b * MG * S + s;
#pragma unroll
  for (int x = 0; x < kRows; ++x)
    ps[x * kChunk + tid] =
        x < MG ? (in ? sc[x] + bcol[(size_t)x * S] : -INFINITY) : 0.f;
  __syncthreads();  // the scores and V are in shared memory

  // 2. the chunk's softmax: m from -1e30, p = exp(score - m), l = sum p
  for (int x = warp; x < MG; x += kWarps) {
    float* row = ps + x * kChunk;
    float val[kChunk / 32];
    float m = -1e30f;
#pragma unroll
    for (int i = 0; i < kChunk / 32; ++i) {
      val[i] = row[lane + 32 * i];
      m = fmaxf(m, val[i]);
    }
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
#pragma unroll
    for (int i = 0; i < kChunk / 32; ++i) {
      val[i] = expf(val[i] - m);
      l += val[i];
      row[lane + 32 * i] = val[i];
    }
    for (int o = 16; o > 0; o >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      l_s[x] = l;
      if (n_split > 1) {
        rec[nq + x] = m;
        rec[nq + MG + x] = l;
      }
    }
  }
  __syncthreads();  // p and l are in shared memory

  // 3. acc = p . V^T in passes of kPR rows
  const int cw = warp * 32;  // this warp's columns
#pragma unroll 1
  for (int g = 0; g < kRows / kPR; ++g) {
    float acc[kPR][kC];
#pragma unroll
    for (int r = 0; r < kPR; ++r)
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[r][c] = 0.f;
#pragma unroll
    for (int j = 0; j < 32; j += 4) {
      float4 vv[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c)
        vv[c] = *reinterpret_cast<const float4*>(
            vs + (lane + 32 * c) * kVP + cw + j);
#pragma unroll
      for (int r = 0; r < kPR; ++r) {
        const float4 pp = *reinterpret_cast<const float4*>(
            ps + (g * kPR + r) * kChunk + cw + j);
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[r][c] = dot4(pp, vv[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < kPR; ++r)
#pragma unroll
      for (int c = 0; c < kC; ++c)
        red[(warp * kPR + r) * kHd + lane + 32 * c] = acc[r][c];
    __syncthreads();  // the pass's warp partials are in shared memory
    for (int i = tid; i < kPR * kHd; i += kThreads) {
      const int r = i / kHd, x = g * kPR + r;
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) o += red[w * kPR * kHd + i];
      if (x < MG) {
        if (n_split == 1)
          out[(size_t)bh * nq + x * kHd + i % kHd] =
              tt::from_f32<T>(o / l_s[x]);
        else
          rec[x * kHd + i % kHd] = o;
      }
    }
    if (g + 1 < kRows / kPR) __syncthreads();  // red is reused
  }
}

// Kernel A's second pass: block (b*H + h, x) of hd threads combines row x's
// n_split partials in chunk order, out = sum_c acc_c w_c / sum_c l_c w_c
// with w_c = exp(m_c - max_c m_c): warp 0 finds the weights (lane c takes
// chunks c, c + 32, ...), then thread d sums its dim's partials in chunk
// order. No atomics: the order is fixed.
template <typename T>
__global__ void decode_attention_combine_kernel(const float* __restrict__ part,
                                                T* __restrict__ out, int MG,
                                                int n_split) {
  extern __shared__ float wts[];  // [n_split] weights, then l
  const int bh = blockIdx.x, x = blockIdx.y, d = threadIdx.x;
  const int hd = blockDim.x, nq = MG * hd;
  const size_t rec = (size_t)MG * (hd + 2);
  const float* recs = part + (size_t)bh * n_split * rec;
  if (d < 32) {
    float m = -1e30f;
    for (int c = d; c < n_split; c += 32)
      m = fmaxf(m, recs[c * rec + nq + x]);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int c = d; c < n_split; c += 32) {
      const float w = expf(recs[c * rec + nq + x] - m);
      wts[c] = w;
      l += recs[c * rec + nq + MG + x] * w;
    }
    for (int o = 16; o > 0; o >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, o);
    if (d == 0) wts[n_split] = l;
  }
  __syncthreads();
  float o = 0.f;
  for (int c = 0; c < n_split; ++c)
    o = fmaf(recs[c * rec + x * hd + d], wts[c], o);
  out[(size_t)bh * nq + x * hd + d] = tt::from_f32<T>(o / wts[n_split]);
}

template <typename T, int kHd, int kRows>
cudaError_t launch_a(const void* q, const void* k, const void* v,
                     const void* bias, void* part, void* out, int B, int H,
                     int MG, int S, cudaStream_t stream) {
  const int n_split = (S + kChunk - 1) / kChunk;
  const size_t smem = sizeof(float) * chunk_smem_floats<kHd, kRows>();
  auto kernel = decode_attention_chunk_kernel<T, kHd, kRows>;
  cudaError_t err = tt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * H, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<float*>(part), static_cast<T*>(out), H, MG, S, n_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  decode_attention_combine_kernel<T>
      <<<dim3(B * H, MG), kHd, sizeof(float) * (n_split + 1), stream>>>(
          static_cast<const float*>(part), static_cast<T*>(out), MG,
          n_split);
  return cudaGetLastError();
}

// Kernel A's instantiations: kRows = 4, 8, 20 or 40 query rows (MG is
// padded up to the next; 4 and 20 are the flagship's greedy and beam-5
// rows), head dims 32, 64, 128.
template <typename T, int kHd>
cudaError_t dispatch_a_rows(const void* q, const void* k, const void* v,
                            const void* bias, void* part, void* out, int B,
                            int H, int MG, int S, cudaStream_t st) {
  if (MG <= 4)
    return launch_a<T, kHd, 4>(q, k, v, bias, part, out, B, H, MG, S, st);
  if (MG <= 8)
    return launch_a<T, kHd, 8>(q, k, v, bias, part, out, B, H, MG, S, st);
  if (MG <= 20)
    return launch_a<T, kHd, 20>(q, k, v, bias, part, out, B, H, MG, S, st);
  if (MG <= 40)
    return launch_a<T, kHd, 40>(q, k, v, bias, part, out, B, H, MG, S, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_a(const void* q, const void* k, const void* v,
                       const void* bias, void* part, void* out, int B, int H,
                       int MG, int hd, int S, cudaStream_t st) {
  if (hd == 32)
    return dispatch_a_rows<T, 32>(q, k, v, bias, part, out, B, H, MG, S, st);
  if (hd == 64)
    return dispatch_a_rows<T, 64>(q, k, v, bias, part, out, B, H, MG, S, st);
  if (hd == 128)
    return dispatch_a_rows<T, 128>(q, k, v, bias, part, out, B, H, MG, S,
                                   st);
  return cudaErrorInvalidValue;
}

// How kernel D's K/V are stored: int8, or packed int4.
enum KvMode { kKvInt8 = 1, kKvInt4 = 2 };

template <typename T, int kKv>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const void* __restrict__ k,
                        const void* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const float* __restrict__ bias, T* __restrict__ out,
                        int H, int MG, int hd, int S) {
  extern __shared__ float smem[];
  float* qs = smem;                // [MG, hd]
  float* acc = qs + MG * hd;       // [MG, hd]
  float* ks = acc + MG * hd;       // [hd, kTileP]
  float* vs = ks + hd * kTileP;    // [hd, kTileP]
  float* ps = vs + hd * kTileP;    // [MG, kTile]
  float* m_run = ps + MG * kTile;  // [MG]
  float* l_run = m_run + MG;       // [MG]
  float* alpha = l_run + MG;       // [MG]
  float* ksc = alpha + MG;         // [kTile]
  float* vsc = ksc + kTile;        // [kTile]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int nq = MG * hd;
  const int hd_store = kKv == kKvInt4 ? hd / 2 : hd;
  const T* qb = q + (size_t)bh * nq;
  const int8_t* kb = static_cast<const int8_t*>(k) + (size_t)bh * hd_store * S;
  const int8_t* vb = static_cast<const int8_t*>(v) + (size_t)bh * hd_store * S;
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
        ks[d * kTileP + j] = in ? (float)kb[(size_t)d * S + s] : 0.f;
        vs[d * kTileP + j] = in ? (float)vb[(size_t)d * S + s] : 0.f;
      }
    }
    const float* kscb = k_scale + (size_t)bh * S;
    const float* vscb = v_scale + (size_t)bh * S;
    for (int j = tid; j < kTile; j += kThreads) {
      const int s = s0 + j;
      ksc[j] = s < S ? kscb[s] : 0.f;
      vsc[j] = s < S ? vscb[s] : 0.f;
    }
    __syncthreads();
    // 2. scores [MG, kTile] = q . K * k_scale + bias, -inf past S
    for (int i = tid; i < MG * kTile; i += kThreads) {
      const int x = i / kTile, j = i % kTile, s = s0 + j;
      float sc = -INFINITY;
      if (s < S) {
        const float* qr = qs + x * hd;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot += qr[d] * ks[d * kTileP + j];
        dot *= ksc[j];
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
      row[lane] = ea * vsc[lane];
      row[lane + 32] = ec * vsc[lane + 32];
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
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* k_scale, const void* v_scale,
                     const void* bias, void* out, int B, int H, int MG,
                     int hd, int S, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (2 * (size_t)MG * hd + 2 * (size_t)hd * kTileP + (size_t)MG * kTile +
       3 * (size_t)MG + 2 * (size_t)kTile);
  cudaError_t err = tt::allow_smem(decode_attention_kernel<T, kKv>, smem);
  if (err != cudaSuccess) return err;
  decode_attention_kernel<T, kKv><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), k, v, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const float*>(bias),
      static_cast<T*>(out), H, MG, hd, S);
  return cudaGetLastError();
}

template <int kKv>
int dispatch_d(const void* q, const void* k, const void* v,
               const void* k_scale, const void* v_scale, const void* bias,
               void* out, int B, int H, int MG, int hd, int S, int dtype,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tt::kFloat32)
    return launch_d<float, kKv>(q, k, v, k_scale, v_scale, bias, out, B, H,
                                MG, hd, S, st);
  if (dtype == tt::kBFloat16)
    return launch_d<__nv_bfloat16, kKv>(q, k, v, k_scale, v_scale, bias,
                                        out, B, H, MG, hd, S, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Kernel A: q, k, v, out in the dtype `dtype`; part fp32 scratch of
// B*H*ceil(S/256)*MG*(hd+2) floats (unused, may be null, when S <= 256).
extern "C" int tt_decode_attention(const void* q, const void* k,
                                   const void* v, const void* bias,
                                   void* part, void* out, int B, int H,
                                   int MG, int hd, int S, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tt::kFloat32)
    return dispatch_a<float>(q, k, v, bias, part, out, B, H, MG, hd, S, st);
  if (dtype == tt::kBFloat16)
    return dispatch_a<__nv_bfloat16>(q, k, v, bias, part, out, B, H, MG, hd,
                                     S, st);
  return cudaErrorInvalidValue;
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
    return dispatch_d<kKvInt4>(q, k8, v8, k_scale, v_scale, bias, out, B, H,
                               MG, hd, S, dtype, stream);
  return dispatch_d<kKvInt8>(q, k8, v8, k_scale, v_scale, bias, out, B, H,
                             MG, hd, S, dtype, stream);
}
