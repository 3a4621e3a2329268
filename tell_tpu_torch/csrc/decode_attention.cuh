// The split-S body of kernels A, D and F (decode_attention.cu,
// decode_attention_q8.cu and decode_attention_single.cu; the design is in
// decode_attention.cu's header), templated on how a column's K/V are
// stored: fp32 / bf16 (A, F), int8 or nibble-packed int4 with per-column
// scales (D, F's int4-split form).
//
// Everything here lives in an unnamed namespace: each source that includes
// it instantiates its own kernels.
#pragma once

#include <cstdint>
#include <type_traits>

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

// The next kSlice stored rows of one K or V column (row stride S),
// advancing the pointer past them; zeros past the source.
template <typename E>
__device__ __forceinline__ void load_rows(E (&r)[kSlice], const E*& p,
                                          bool in, int S) {
#pragma unroll
  for (int e = 0; e < kSlice; ++e) {
    r[e] = in ? *p : zero<E>();
    p += S;
  }
}

// sc[x] += q[x] . k over stored rows st*kSlice.. of a column (kc, already
// loaded): q rows from shared memory as float4 broadcasts, each feeding
// four FMAs; an int4 byte feeds rows d and d + hd/2.
template <typename Kv, int kHd, int kRows>
__device__ __forceinline__ void score_slice(
    float (&sc)[kRows], const float* qs,
    const typename Kv::Elem (&kc)[kSlice], int st) {
  constexpr int kStored = kHd / Kv::kPack;
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

// Row x's score of a column from its q . k sum: times k_scale for a
// quantised cache, then plus the bias; -inf past the source, 0 for the
// padding rows past MG.
template <typename Kv>
__device__ __forceinline__ float column_score(float dot, float ksc,
                                              const float* bcol, int x,
                                              int MG, int S, bool in) {
  if (x >= MG) return 0.f;
  if (!in) return -INFINITY;
  if constexpr (Kv::kQuant)
    return dot * ksc + bcol[(size_t)x * S];
  else
    return dot + bcol[(size_t)x * S];
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

// acc = p . V^T for the chunk, in passes of up to 10 rows (pass_rows):
// warp w sums its 32 columns, lane the head dims lane + 32i (each V float4
// feeds the pass's rows, each broadcast p float4 the lane's dims); the 8
// warps' partials are added in warp order, so the sum is the same every
// launch, and emit(x, d, o) takes row x < MG's sum for dim d. vs [kHd][kVP]
// and ps [kRows][kChunk] are ready in shared memory; red holds one pass's
// partials [kWarps][pass rows][kHd].
template <int kHd, int kRows, typename Emit>
__device__ __forceinline__ void pv_passes(const float* vs, const float* ps,
                                          float* red, int MG, Emit emit) {
  constexpr int kPR = pass_rows<kRows>();
  constexpr int kC = kHd / 32;  // PV head dims per lane
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
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
      const int x = g * kPR + i / kHd;
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) o += red[w * kPR * kHd + i];
      if (x < MG) emit(x, i % kHd, o);
    }
    if (g + 1 < kRows / kPR) __syncthreads();  // red is reused
  }
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
    score_slice<Kv, kHd, kRows>(sc, qs, kc, st);
  }
  const float* bcol = bias + (size_t)b * MG * S + s;
#pragma unroll
  for (int x = 0; x < kRows; ++x)
    ps[x * kChunk + tid] = column_score<Kv>(sc[x], ksc, bcol, x, MG, S, in);
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
  pv_passes<kHd, kRows>(vs, ps, red, MG, [&](int x, int d, float o) {
    if (n_split == 1)
      out[(size_t)bh * nq + x * kHd + d] = tt::from_f32<T>(o / l_s[x]);
    else
      rec[x * kHd + d] = o;
  });
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

// f(std::integral_constant<int, kRows>) for kRows = 4, 8, 20 or 40 query
// rows, the least that holds MG (MG is padded up to it; 4 and 20 are the
// flagship's greedy and beam-5 rows).
template <typename F>
cudaError_t with_rows(int MG, F&& f) {
  if (MG <= 4) return f(std::integral_constant<int, 4>());
  if (MG <= 8) return f(std::integral_constant<int, 8>());
  if (MG <= 20) return f(std::integral_constant<int, 20>());
  if (MG <= 40) return f(std::integral_constant<int, 40>());
  return cudaErrorInvalidValue;
}

template <typename T, typename Kv, int kHd>
cudaError_t dispatch_rows(const void* q, const void* k, const void* v,
                          const void* k_scale, const void* v_scale,
                          const void* bias, void* part, void* out, int B,
                          int H, int MG, int S, cudaStream_t st) {
  return with_rows(MG, [&](auto rows) {
    return launch_split<T, Kv, kHd, decltype(rows)::value>(
        q, k, v, k_scale, v_scale, bias, part, out, B, H, MG, S, st);
  });
}

// ---- kernel F: the single-shot form (decode_attention_single.cu) ----------
//
// The same attention with the softmax normalised before p is rounded to
// q's dtype (times v_scale first for the int4-split form), as the TPU's
// single-shot kernels do. Three launches on the chunks above, none of
// which holds more than one chunk of a row:
//   1. single_scores_kernel: block (b*H + h, c) computes chunk c's scores
//      as A's body does, writes them to an fp32 scratch [B,H,MG,S] and
//      each row's chunk (max from -1e30, sum of exp) to stats
//      [B,H,MG,n_split];
//   2. single_pv_kernel: block (b*H + h, c) forms each row's global max m
//      and sum l from the stats in chunk order, p = round(exp(s - m) / l),
//      and the chunk's p . V^T in A's PV passes, into an fp32 partial
//      [B,H,n_split,MG,hd] (into out where n_split == 1);
//   3. single_combine_kernel sums the partials in chunk order.
// S alone sets the chunks and every sum's order, so a row's output is the
// same bits at any B and for any grouping of batch rows.

// Pass 1 of kernel F (see above). Two blocks an SM up to 20 rows (at 40
// the scores would spill past 128 registers).
template <typename T, typename Kv, int kHd, int kRows>
__global__ void __launch_bounds__(kThreads, kRows <= 20 ? 2 : 1)
single_scores_kernel(const T* __restrict__ q,
                     const typename Kv::Elem* __restrict__ k,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ bias,
                     float* __restrict__ scores, float2* __restrict__ stats,
                     int H, int MG, int S, int n_split) {
  using E = typename Kv::Elem;
  constexpr int kStored = kHd / Kv::kPack;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][kHd]
  float* ps = qs + kRows * kHd;                 // [kRows][kChunk]

  const int bh = blockIdx.x, chunk = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nq = MG * kHd;
  const bool in = chunk * kChunk + tid < S;
  const int s = in ? chunk * kChunk + tid : chunk * kChunk;
  const E* kp = k + (size_t)bh * kStored * S + s;

  E kn[kSlice];
  load_rows(kn, kp, in, S);
  const T* qb = q + (size_t)bh * nq;
  for (int i = tid; i < kRows * kHd; i += kThreads)
    qs[i] = i < nq ? tt::to_f32(qb[i]) : 0.f;
  float ksc = 1.f;
  if constexpr (Kv::kQuant) ksc = in ? k_scale[(size_t)bh * S + s] : 0.f;
  __syncthreads();

  float sc[kRows];
#pragma unroll
  for (int x = 0; x < kRows; ++x) sc[x] = 0.f;
#pragma unroll 1
  for (int st = 0; st < kStored / kSlice; ++st) {
    E kc[kSlice];
#pragma unroll
    for (int e = 0; e < kSlice; ++e) kc[e] = kn[e];
    if (st + 1 < kStored / kSlice) load_rows(kn, kp, in, S);
    score_slice<Kv, kHd, kRows>(sc, qs, kc, st);
  }
  const float* bcol = bias + (size_t)b * MG * S + s;
  float* srow = scores + (size_t)bh * MG * S + s;
#pragma unroll
  for (int x = 0; x < kRows; ++x) {
    const float score = column_score<Kv>(sc[x], ksc, bcol, x, MG, S, in);
    ps[x * kChunk + tid] = score;
    if (x < MG && in) srow[(size_t)x * S] = score;
  }
  __syncthreads();

  for (int x = warp; x < MG; x += kWarps) {
    const float* row = ps + x * kChunk;
    float m = -1e30f;
#pragma unroll
    for (int i = 0; i < kChunk / 32; ++i) m = fmaxf(m, row[lane + 32 * i]);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
#pragma unroll
    for (int i = 0; i < kChunk / 32; ++i) l += expf(row[lane + 32 * i] - m);
    for (int o = 16; o > 0; o >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0)
      stats[((size_t)bh * MG + x) * n_split + chunk] = make_float2(m, l);
  }
}

// Shared memory of kernel F's pass 2 in floats: V [kHd][kVP], p
// [kRows][kChunk], one PV pass's warp partials, and (m, l) per row.
template <int kHd, int kRows>
constexpr int single_pv_smem_floats() {
  return kHd * kVP + kRows * kChunk + kWarps * pass_rows<kRows>() * kHd +
         2 * kRows;
}

// Pass 2 of kernel F (see above).
template <typename T, typename Kv, int kHd, int kRows>
__global__ void __launch_bounds__(kThreads, kHd <= 64 ? 2 : 1)
single_pv_kernel(const typename Kv::Elem* __restrict__ v,
                 const float* __restrict__ v_scale,
                 const float* __restrict__ scores,
                 const float2* __restrict__ stats, float* __restrict__ part,
                 T* __restrict__ out, int MG, int S, int n_split) {
  using E = typename Kv::Elem;
  constexpr int kStored = kHd / Kv::kPack;
  extern __shared__ float4 smem4[];
  float* vs = reinterpret_cast<float*>(smem4);          // [kHd][kVP]
  float* ps = vs + kHd * kVP;                           // [kRows][kChunk]
  float* red = ps + kRows * kChunk;                     // PV partials
  float2* ml = reinterpret_cast<float2*>(red + kWarps * pass_rows<kRows>() *
                                                   kHd);  // [kRows]

  const int bh = blockIdx.x, chunk = blockIdx.y;
  const int tid = threadIdx.x;
  const bool in = chunk * kChunk + tid < S;
  const int s = in ? chunk * kChunk + tid : chunk * kChunk;
  const E* vp = v + (size_t)bh * kStored * S + s;

  E vn[kSlice];
  load_rows(vn, vp, in, S);
  if (tid < MG) {  // row tid's max and sum over all chunks, in chunk order
    const float2* st = stats + ((size_t)bh * MG + tid) * n_split;
    float m = -1e30f;
    for (int c = 0; c < n_split; ++c) m = fmaxf(m, st[c].x);
    float l = 0.f;
    for (int c = 0; c < n_split; ++c) l += st[c].y * expf(st[c].x - m);
    ml[tid] = make_float2(m, l);
  }
  float vsc = 1.f;
  if constexpr (Kv::kQuant) vsc = in ? v_scale[(size_t)bh * S + s] : 0.f;
#pragma unroll 1
  for (int st = 0; st < kStored / kSlice; ++st) {
    E vc[kSlice];
#pragma unroll
    for (int e = 0; e < kSlice; ++e) vc[e] = vn[e];
    if (st + 1 < kStored / kSlice) load_rows(vn, vp, in, S);
#pragma unroll
    for (int e = 0; e < kSlice; ++e)
#pragma unroll
      for (int h = 0; h < Kv::kPack; ++h)
        vs[(h * kStored + st * kSlice + e) * kVP + tid] = Kv::row(vc[e], h);
  }
  __syncthreads();  // (m, l) are in shared memory

  const float* scol = scores + (size_t)bh * MG * S + s;
#pragma unroll
  for (int x = 0; x < kRows; ++x) {
    float p = 0.f;
    if (x < MG && in) {
      p = expf(scol[(size_t)x * S] - ml[x].x) / ml[x].y;
      if constexpr (Kv::kQuant) p *= vsc;
      p = tt::round_to<T>(p);
    }
    ps[x * kChunk + tid] = p;
  }
  __syncthreads();  // p and V are in shared memory

  const int nq = MG * kHd;
  float* rec = part + ((size_t)bh * n_split + chunk) * nq;
  pv_passes<kHd, kRows>(vs, ps, red, MG, [&](int x, int d, float o) {
    if (n_split == 1)
      out[(size_t)bh * nq + x * kHd + d] = tt::from_f32<T>(o);
    else
      rec[x * kHd + d] = o;
  });
}

// Pass 3 of kernel F: block (b*H + h, x) of hd threads sums row x's
// n_split partials in chunk order.
template <typename T>
__global__ void single_combine_kernel(const float* __restrict__ part,
                                      T* __restrict__ out, int MG,
                                      int n_split) {
  const int bh = blockIdx.x, x = blockIdx.y, d = threadIdx.x;
  const int nq = MG * blockDim.x;
  const float* p = part + (size_t)bh * n_split * nq + x * blockDim.x + d;
  float o = 0.f;
  for (int c = 0; c < n_split; ++c) o += p[(size_t)c * nq];
  out[(size_t)bh * nq + x * blockDim.x + d] = tt::from_f32<T>(o);
}

// Kernel F's three launches (two where S fits one chunk). k_scale and
// v_scale are the int4-split form's (null for the fp form).
template <typename T, typename Kv, int kHd, int kRows>
cudaError_t launch_single(const void* q, const void* k, const void* v,
                          const void* k_scale, const void* v_scale,
                          const void* bias, void* scores, void* stats,
                          void* part, void* out, int B, int H, int MG, int S,
                          cudaStream_t stream) {
  using E = typename Kv::Elem;
  const int n_split = (S + kChunk - 1) / kChunk;
  const dim3 grid(B * H, n_split);
  const size_t smem1 = sizeof(float) * (kRows * kHd + kRows * kChunk);
  auto k1 = single_scores_kernel<T, Kv, kHd, kRows>;
  cudaError_t err = tt::allow_smem(k1, smem1);
  if (err != cudaSuccess) return err;
  k1<<<grid, kThreads, smem1, stream>>>(
      static_cast<const T*>(q), static_cast<const E*>(k),
      static_cast<const float*>(k_scale), static_cast<const float*>(bias),
      static_cast<float*>(scores), static_cast<float2*>(stats), H, MG, S,
      n_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem2 = sizeof(float) * single_pv_smem_floats<kHd, kRows>();
  auto k2 = single_pv_kernel<T, Kv, kHd, kRows>;
  if ((err = tt::allow_smem(k2, smem2)) != cudaSuccess) return err;
  k2<<<grid, kThreads, smem2, stream>>>(
      static_cast<const E*>(v), static_cast<const float*>(v_scale),
      static_cast<const float*>(scores), static_cast<const float2*>(stats),
      static_cast<float*>(part), static_cast<T*>(out), MG, S, n_split);
  if ((err = cudaGetLastError()) != cudaSuccess || n_split == 1) return err;
  single_combine_kernel<T><<<dim3(B * H, MG), kHd, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), MG, n_split);
  return cudaGetLastError();
}

}  // namespace
