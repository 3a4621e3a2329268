// The split-S body of kernels A and D (decode_attention.cu and
// decode_attention_q8.cu; the design is in decode_attention.cu's header),
// templated on how a column's K/V are stored: fp32 / bf16 (A), int8 or
// nibble-packed int4 with per-column scales (D).
//
// Everything here lives in an unnamed namespace: each source that includes
// it instantiates its own kernels.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;   // source columns per block
constexpr int kSlice = 16;         // stored K/V rows per load step
constexpr int kVP = kChunk + 4;    // V row pitch in shared memory

// How a column's K/V are stored, and row `half` of a stored element in
// fp32 (exact for int8 and int4).
// Fp: one T per row (kernel A).
template <typename T>
struct KvFp {
  using Elem = T;
  static constexpr bool kQuant = false;
  static constexpr int kPack = 1;  // rows per stored element
  __device__ static float row(Elem e, int) { return tt::to_f32(e); }
};
// Int8: one byte per row (kernel D).
struct KvInt8 {
  using Elem = int8_t;
  static constexpr bool kQuant = true;
  static constexpr int kPack = 1;
  __device__ static float row(Elem e, int) { return (float)e; }
};
// Int4: the byte of stored row d holds row d in its low nibble and row
// d + hd/2 in its high one, sign-extended in int32 (kernel D).
struct KvInt4 {
  using Elem = int8_t;
  static constexpr bool kQuant = true;
  static constexpr int kPack = 2;
  __device__ static float row(Elem e, int half) {
    return (float)tt::nibble(((int)e >> (4 * half)) & 15);
  }
};

template <typename E>
__device__ __forceinline__ E zero() {
  return E(0);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return tt::from_f32<__nv_bfloat16>(0.f);
}

// c + a . b, four FMAs
__device__ __forceinline__ float dot4(float4 a, float4 b, float c) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, c))));
}

// The next kSlice stored rows of one K column and one V column (row stride
// S), advancing both pointers past them; zeros past the source.
template <typename E>
__device__ __forceinline__ void load_slice(E (&kr)[kSlice], E (&vr)[kSlice],
                                           const E*& kp, const E*& vp,
                                           bool in, int S) {
#pragma unroll
  for (int e = 0; e < kSlice; ++e) {
    kr[e] = in ? *kp : zero<E>();
    vr[e] = in ? *vp : zero<E>();
    kp += S;
    vp += S;
  }
}

// Rows per PV pass: all of them up to 8, else 10 (kRows = 20) or 8, a
// divisor of kRows.
template <int kRows>
__host__ __device__ constexpr int pass_rows() {
  return kRows <= 8 ? kRows : kRows % 10 == 0 && kRows < 40 ? 10 : 8;
}

// Shared memory in floats: q [kRows][kHd], V [kHd][kVP], the scores then p
// [kRows][kChunk], one PV pass's warp partials [kWarps][pass rows][kHd],
// l [kRows], and for D the chunk's v_scale [kChunk].
template <typename Kv, int kHd, int kRows>
constexpr int chunk_smem_floats() {
  return kRows * kHd + kHd * kVP + kRows * kChunk +
         kWarps * pass_rows<kRows>() * kHd + kRows +
         (Kv::kQuant ? kChunk : 0);
}

// Block (b*H + h, c) takes chunk c (kChunk columns) of one (b, h) stripe,
// for MG <= kRows query rows of head dim kHd.
//   Scores: thread t owns column s = c*kChunk + t. It streams its K and V
//   columns from device memory kSlice stored rows a step, the next step's
//   loads in flight while this step's are used, with no barrier in
//   between: K goes from registers into the kRows scores (each broadcast q
//   float4 feeds four FMAs), V into shared memory, both dequantised in
//   registers (an int4 byte feeds rows d and d + hd/2, which meet q rows d
//   and d + hd/2). D scales the column's score by k_scale[s] before the
//   bias, and keeps v_scale[s] in shared memory beside p.
//   Softmax: warp w takes rows w + 8r of the chunk's [kRows, kChunk]
//   scores, max and sum by shuffles, from -1e30. l adds the raw
//   exponentials; D's PV product takes them times v_scale (the TPU's
//   tiled q8 kernel).
//   PV, in passes of up to 10 rows: warp w sums its 32 columns, lane the
//   head dims lane + 32i (each V float4 feeds the pass's rows, each
//   broadcast p float4 the lane's dims); the 8 warps' partials are added
//   in warp order, so the sum is the same every launch.
// n_split > 1: write the partial (acc[MG, hd], m[MG], l[MG]) to
// part[(bh * n_split + c) * MG * (hd + 2)]; n_split == 1: write out.
template <typename T, typename Kv, int kHd, int kRows>
__global__ void __launch_bounds__(kThreads, kHd <= 64 ? 2 : 1)
decode_attention_chunk_kernel(const T* __restrict__ q,
                              const typename Kv::Elem* __restrict__ k,
                              const typename Kv::Elem* __restrict__ v,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const float* __restrict__ bias,
                              float* __restrict__ part, T* __restrict__ out,
                              int H, int MG, int S, int n_split) {
  using E = typename Kv::Elem;
  constexpr int kPR = pass_rows<kRows>();
  constexpr int kC = kHd / 32;                 // PV head dims per lane
  constexpr int kStored = kHd / Kv::kPack;     // stored rows of a column
  static_assert(kStored % kSlice == 0 && kHd % 32 == 0 && kRows % kPR == 0,
                "the chunk kernel's tiling");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][kHd]
  float* vs = qs + kRows * kHd;                 // [kHd][kVP]
  float* ps = vs + kHd * kVP;                   // [kRows][kChunk]
  float* red = ps + kRows * kChunk;             // [kWarps][kPR][kHd]
  float* l_s = red + kWarps * kPR * kHd;        // [kRows]
  float* vsc = l_s + kRows;                     // [kChunk], D only

  const int bh = blockIdx.x, chunk = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int nq = MG * kHd;
  const int s_begin = chunk * kChunk;
  const bool in = s_begin + tid < S;
  const int s = in ? s_begin + tid : s_begin;  // this thread's column
  const E* kp = k + (size_t)bh * kStored * S + s;
  const E* vp = v + (size_t)bh * kStored * S + s;
  float* rec = part + ((size_t)bh * n_split + chunk) * MG * (kHd + 2);

  E kn[kSlice], vn[kSlice];
  load_slice(kn, vn, kp, vp, in, S);
  const T* qb = q + (size_t)bh * nq;
  for (int i = tid; i < kRows * kHd; i += kThreads)
    qs[i] = i < nq ? tt::to_f32(qb[i]) : 0.f;
  float ksc = 1.f;
  if constexpr (Kv::kQuant) {
    ksc = in ? k_scale[(size_t)bh * S + s] : 0.f;
    vsc[tid] = in ? v_scale[(size_t)bh * S + s] : 0.f;
  }
  __syncthreads();

  // 1. scores of this column; its V column into shared memory
  float sc[kRows];
#pragma unroll
  for (int x = 0; x < kRows; ++x) sc[x] = 0.f;
#pragma unroll 1
  for (int st = 0; st < kStored / kSlice; ++st) {
    // this step's V rows to shared memory, then the next step's loads
    // go out before this step's math
    E kc[kSlice];
#pragma unroll
    for (int e = 0; e < kSlice; ++e) {
      kc[e] = kn[e];
#pragma unroll
      for (int h = 0; h < Kv::kPack; ++h)
        vs[(h * kStored + st * kSlice + e) * kVP + tid] = Kv::row(vn[e], h);
    }
    if (st + 1 < kStored / kSlice) load_slice(kn, vn, kp, vp, in, S);
#pragma unroll
    for (int h = 0; h < Kv::kPack; ++h) {
      float kf[kSlice];
#pragma unroll
      for (int e = 0; e < kSlice; ++e) kf[e] = Kv::row(kc[e], h);
#pragma unroll
      for (int x = 0; x < kRows; ++x) {
        const float* qd = qs + x * kHd + h * kStored + st * kSlice;
#pragma unroll
        for (int e = 0; e < kSlice; e += 4)
          sc[x] = dot4(*reinterpret_cast<const float4*>(qd + e),
                       make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]),
                       sc[x]);
      }
    }
  }
  const float* bcol = bias + (size_t)b * MG * S + s;
#pragma unroll
  for (int x = 0; x < kRows; ++x) {
    float score = 0.f;  // rows past MG
    if (x < MG) {
      if (!in)
        score = -INFINITY;
      else if constexpr (Kv::kQuant)
        score = sc[x] * ksc + bcol[(size_t)x * S];
      else
        score = sc[x] + bcol[(size_t)x * S];
    }
    ps[x * kChunk + tid] = score;
  }
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
      if constexpr (Kv::kQuant)
        row[lane + 32 * i] = val[i] * vsc[lane + 32 * i];
      else
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

// The second pass: block (b*H + h, x) of hd threads combines row x's
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

// Both passes: n_split = ceil(S / kChunk) chunk blocks per (b, h), then
// the combine where n_split > 1. k_scale and v_scale are D's (null for A).
template <typename T, typename Kv, int kHd, int kRows>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const void* k_scale, const void* v_scale,
                         const void* bias, void* part, void* out, int B,
                         int H, int MG, int S, cudaStream_t stream) {
  using E = typename Kv::Elem;
  const int n_split = (S + kChunk - 1) / kChunk;
  const size_t smem = sizeof(float) * chunk_smem_floats<Kv, kHd, kRows>();
  auto kernel = decode_attention_chunk_kernel<T, Kv, kHd, kRows>;
  cudaError_t err = tt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * H, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const float*>(bias),
      static_cast<float*>(part), static_cast<T*>(out), H, MG, S, n_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  decode_attention_combine_kernel<T>
      <<<dim3(B * H, MG), kHd, sizeof(float) * (n_split + 1), stream>>>(
          static_cast<const float*>(part), static_cast<T*>(out), MG,
          n_split);
  return cudaGetLastError();
}

// kRows = 4, 8, 20 or 40 query rows (MG is padded up to the next; 4 and 20
// are the flagship's greedy and beam-5 rows).
template <typename T, typename Kv, int kHd>
cudaError_t dispatch_rows(const void* q, const void* k, const void* v,
                          const void* k_scale, const void* v_scale,
                          const void* bias, void* part, void* out, int B,
                          int H, int MG, int S, cudaStream_t st) {
  if (MG <= 4)
    return launch_split<T, Kv, kHd, 4>(q, k, v, k_scale, v_scale, bias, part,
                                       out, B, H, MG, S, st);
  if (MG <= 8)
    return launch_split<T, Kv, kHd, 8>(q, k, v, k_scale, v_scale, bias, part,
                                       out, B, H, MG, S, st);
  if (MG <= 20)
    return launch_split<T, Kv, kHd, 20>(q, k, v, k_scale, v_scale, bias,
                                        part, out, B, H, MG, S, st);
  if (MG <= 40)
    return launch_split<T, Kv, kHd, 40>(q, k, v, k_scale, v_scale, bias,
                                        part, out, B, H, MG, S, st);
  return cudaErrorInvalidValue;
}

}  // namespace
