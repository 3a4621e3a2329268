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
// fp32 or bf16 storage, 16-byte aligned, C and C/H multiples of 8, K <=
// 32; fp32 logits, softmax and accumulators.
//
// What bounds it on the H100: the tap-logit product, a GEMM of B*T rows, K*H
// columns and a reduction over C (0.52 GFLOP at B=16, T=32, C=1024, K=31,
// H=16), and reading x and w_km once and writing out once (6.3 MB in fp32
// there). On the tensor cores the product is 3.1 us in fp32 (3xTF32 at 495
// TFLOP/s) and 0.5 us in bf16, the bytes 1.9 us: at the training shapes the
// kernel is small, and what matters is keeping 132 SMs busy while every
// block re-reads its x rows and w_km columns through L2.
//
// The design. A block owns TT = 16 or 32 time rows of one batch row and a
// group of HB heads: NF = K*HB tap-logit columns, padded to NFP = 8, 16 or
// 32. The wrapper picks TT, HB and NFP (the largest tile that still gives
// the grid at least 256 blocks, two an SM: a block's latency, not its
// work, sets the time), so every layer of the flagship's training step
// (K = 3, 7, 15, 31 at B=16, T=32) launches 256 blocks.
// 0. A first launch copies the group's w_km columns into a blocked, zero-
//    padded layout w_blk [H/HB][C][NFP], so that the main launch reads
//    each of its C rows as one contiguous 16-byte-aligned run (a column of
//    w_km alone is 4 bytes at a stride of H).
// 1. The logits: x rows and w_blk rows arrive along C in 128-byte slots
//    (32 fp32 or 64 bf16 channels) by 16-byte cp.async into a three-stage
//    ring, as kernel E's table does. The product runs on the tensor cores
//    (mma.sync): bf16 m16n8k16 with fp32 accumulation (A fragments by
//    ldmatrix, B by ldmatrix.trans from w_blk's [C][NFP] rows); fp32 as
//    3xTF32 m16n8k8 (each operand split by masks into hi and lo, lo*hi +
//    hi*lo + hi*hi). Each (16-row, 8-column) tile of the logits has 8 /
//    tiles warps (at most 4), which take the slot's four k-steps in turn;
//    each slot's products accumulate in fresh fragments that are added to
//    the running logits in fp32 (kernel E's finding: one fragment over the
//    whole reduction drifts past fp32's tolerance), and the warps of a
//    tile are summed in warp order through shared memory.
// 2. The softmax over each head's K taps, in shared memory on the CUDA
//    cores (about 6% of the operations), a warp per (row, head), a lane per
//    tap.
// 3. The K-tap sum, on the CUDA cores, over a window of the group's
//    channels (64 at a time) holding the block's own causal halo, the K-1
//    rows before the tile, with zeros before t = 0 and past T, so T < K (a
//    16-token caption under the K=31 layer) and a ragged last tile need no
//    padding; the first window goes out by cp.async before the logits and
//    lands while they are computed. The head of a channel is an index,
//    c / R (the TPU needed a 0/1 [H,C] matmul for it).
// Left for later: a backward kernel (the backward recomputes through the
// plain version, as tell_tpu's does), wgmma, and one launch for the four
// layers' shared x.
#include "common.cuh"

namespace {

using tt::cp_async16;
using tt::cp_async_commit;
using tt::cp_async_wait;
using tt::ldmatrix_x4;
using tt::mma_3xtf32;
using tt::mma_bf16;
using tt::split_tf32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;          // the cp.async ring
constexpr int kSlotBytes = 128;     // bytes of C per ring slot and row
constexpr int kCW = 64;             // channels per chunk of the tap sum
constexpr int kKSteps = 4;          // mma k-steps per slot (fp32 and bf16)

// Channels of C per ring slot, the x rows' pitch in the slot (16 bytes past
// the slot, so rows start on 16-byte boundaries and fragment reads spread
// over the banks), and the w_blk rows' pitch for NFP columns (8 floats or
// bf16 past NFP from 16 on, which spreads the B-fragment reads and the
// ldmatrix rows over the banks).
template <typename T>
__host__ __device__ constexpr int slot_cc() {
  return kSlotBytes / sizeof(T);
}
template <typename T>
__host__ __device__ constexpr int x_pitch() {
  return slot_cc<T>() + 16 / (int)sizeof(T);
}
__host__ __device__ constexpr int w_pitch(int nfp) {
  return nfp == 8 ? 8 : nfp + 8;
}

template <typename T, int kTT, int kNT>
__host__ __device__ constexpr int slot_elems() {
  return kTT * x_pitch<T>() + slot_cc<T>() * w_pitch(8 * kNT);
}

// 0. w_blk[g][c][f] = w_km[c][(f / HB) * H + g * HB + f % HB] for f < K*HB,
// 0 for the padding columns: block c stages row c of w_km in shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_weight_blocks_kernel(const T* __restrict__ w_km, T* __restrict__ w_blk,
                          int C, int H, int K, int HB, int NFP) {
  extern __shared__ float row[];  // [K*H]
  const int c = blockIdx.x, KH = K * H, NF = K * HB;
  for (int i = threadIdx.x; i < KH; i += kThreads)
    row[i] = tt::to_f32(w_km[(size_t)c * KH + i]);
  __syncthreads();
  for (int j = threadIdx.x; j < (H / HB) * NFP; j += kThreads) {
    const int g = j / NFP, f = j % NFP;
    const float val = f < NF ? row[(f / HB) * H + g * HB + f % HB] : 0.f;
    w_blk[((size_t)g * C + c) * NFP + f] = tt::from_f32<T>(val);
  }
}

// Start the cp.async loads of slot `kt` (channels kt*cc..): the tile's x
// rows and the group's w_blk rows; rows past T, channels past C read as 0.
template <typename T, int kTT, int kNT>
__device__ __forceinline__ void load_slot(T* slot, const T* xb,
                                          const T* wb, int t0, int kt,
                                          int T_len, int C, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kCC = slot_cc<T>();
  constexpr int kXP = kCC / kVec;             // 16-byte pieces per x row
  constexpr int kNFP = 8 * kNT;
  constexpr int kWP = kNFP / kVec;            // pieces per w_blk row
  const int c0 = kt * kCC;
  for (int i = tid; i < kTT * kXP + kCC * kWP; i += kThreads) {
    if (i < kTT * kXP) {
      const int r = i / kXP, c = c0 + (i % kXP) * kVec, t = t0 + r;
      const bool in = t < T_len && c < C;
      cp_async16(slot + r * x_pitch<T>() + (i % kXP) * kVec,
                 in ? xb + (size_t)t * C + c : xb, in);
    } else {
      const int j = i - kTT * kXP, r = j / kWP, c = c0 + r;
      const bool in = c < C;
      cp_async16(slot + kTT * x_pitch<T>() + r * w_pitch(kNFP) +
                     (j % kWP) * kVec,
                 in ? wb + (size_t)c * kNFP + (j % kWP) * kVec : wb, in);
    }
  }
}

// Start the cp.async loads of a K-tap window: rows times t0 - (K - 1) ..
// t0 + kTT - 1 (`rows` of them) of channels c0 .. c0 + cw - 1 (cw <= kCW,
// a multiple of 16 bytes' worth) into win [rows][kCW]; rows before t = 0
// or past T read as 0.
template <typename T>
__device__ __forceinline__ void load_window(T* win, const T* xb, int t0,
                                            int K, int c0, int cw, int T_len,
                                            int C, int tid, int rows) {
  constexpr int kVec = 16 / sizeof(T);
  const int pieces = cw / kVec;
  for (int i = tid; i < rows * pieces; i += kThreads) {
    const int j = i / pieces, c = (i % pieces) * kVec;
    const int ti = t0 - (K - 1) + j;
    const bool in = ti >= 0 && ti < T_len;
    cp_async16(win + j * kCW + c, in ? xb + (size_t)ti * C + c0 + c : xb,
               in);
  }
}

// part += k-step ks of a slot for the logits tile (16 rows from row 16mf,
// 8 columns from 8nt). Fragment element i is row 16mf + g + 8(i >> 1),
// column 8nt + 2c + (i & 1), with g = lane / 4, c = lane % 4.
// fp32: 3xTF32 m16n8k8 over channels 8ks..8ks+7.
__device__ __forceinline__ void mma_step(float (&part)[4], const float* xs,
                                         const float* ws, int wp, int mf,
                                         int nt, int ks, int lane) {
  constexpr int P = x_pitch<float>();
  const int g = lane >> 2, c = lane & 3;
  const float* xr = xs + (16 * mf + g) * P + 8 * ks + c;
  const float a[4] = {xr[0], xr[8 * P], xr[4], xr[8 * P + 4]};
  uint32_t ah[4], al[4];
  split_tf32(a, ah, al);
  const float* wr = ws + (8 * ks + c) * wp + 8 * nt + g;
  mma_3xtf32(part, ah, al, wr[0], wr[4 * wp]);
}

// bf16: m16n8k16 over channels 16ks..16ks+15; the A fragment by ldmatrix
// from the x rows, the B fragment by ldmatrix.trans from w_blk's [C][NFP]
// rows (lanes 0-15 give the rows: channels 16ks + lane).
__device__ __forceinline__ void mma_step(float (&part)[4],
                                         const __nv_bfloat16* xs,
                                         const __nv_bfloat16* ws, int wp,
                                         int mf, int nt, int ks, int lane) {
  constexpr int P = x_pitch<__nv_bfloat16>();
  uint32_t a[4], b[2];
  ldmatrix_x4(a, xs + (16 * mf + (lane & 15)) * P + 16 * ks +
                     8 * (lane >> 4));
  tt::ldmatrix_x2_trans(b, ws + (16 * ks + (lane & 15)) * wp + 8 * nt);
  mma_bf16(part, a, b[0], b[1]);
}

// The main launch: block (time tile, head group, batch row); see the
// header. kTT = 16 or 32 time rows, kNT = NFP / 8 column tiles.
template <typename T, int kTT, int kNT>
__global__ void __launch_bounds__(kThreads)
dynamic_conv_kernel(const T* __restrict__ x, const T* __restrict__ w_blk,
                    T* __restrict__ out, int T_len, int C, int H, int K,
                    int HB, int weight_softmax) {
  constexpr int kMF = kTT / 16;
  constexpr int kTiles = kMF * kNT;
  constexpr int kWT = kWarps / kTiles < kKSteps ? kWarps / kTiles : kKSteps;
  constexpr int kNFP = 8 * kNT;
  constexpr int kWPitch = w_pitch(kNFP);
  static_assert(kStages * slot_elems<T, kTT, kNT>() * sizeof(T) >=
                    kWarps * 128 * sizeof(float),
                "the warps' fragments fit the ring");
  extern __shared__ __align__(16) unsigned char smem[];
  float* pr = reinterpret_cast<float*>(smem);  // [kTT][kNFP] logits, p
  float* work = pr + kTT * kNFP;
  T* ring = reinterpret_cast<T*>(work);        // phase 1: the ring
  float* red = work;                           // then the warps' fragments
  T* win = reinterpret_cast<T*>(work) +        // [kTT + K - 1][kCW] window
           (size_t)kStages * slot_elems<T, kTT, kNT>();

  const int t0 = blockIdx.x * kTT;
  const int g0 = blockIdx.y, h0 = g0 * HB;
  const int b = blockIdx.z;
  const int R = C / H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* xb = x + (size_t)b * T_len * C;
  const T* wb = w_blk + (size_t)g0 * C * kNFP;
  T* ob = out + (size_t)b * T_len * C;
  const int kt_n = (C + slot_cc<T>() - 1) / slot_cc<T>();

  // the first window of the K-tap sum (phase 3) goes out first, its own
  // cp.async group, and lands while the logits are computed
  const int CB = HB * R;
  const int c_base = h0 * R;
  load_window<T>(win, xb, t0, K, c_base, min(kCW, CB), T_len, C, tid,
                 kTT + K - 1);
  cp_async_commit();

  // 1. the tap logits of the tile's rows for the group's heads
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_n)
      load_slot<T, kTT, kNT>(ring + s * slot_elems<T, kTT, kNT>(), xb, wb,
                             t0, s, T_len, C, tid);
    cp_async_commit();
  }
  const int tile = warp % kTiles, j = warp / kTiles;
  const int mf = tile / kNT, nt = tile % kNT;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slot kt visible; slot kt - 1's is free
    const int next = kt + kStages - 1;
    if (next < kt_n)
      load_slot<T, kTT, kNT>(ring + (next % kStages) *
                                        slot_elems<T, kTT, kNT>(),
                             xb, wb, t0, next, T_len, C, tid);
    cp_async_commit();
    if (j < kWT) {
      const T* xs = ring + (kt % kStages) * slot_elems<T, kTT, kNT>();
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = j; ks < kKSteps; ks += kWT)
        mma_step(part, xs, xs + kTT * x_pitch<T>(), kWPitch, mf, nt, ks,
                 lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += part[i];
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
  if (j < kWT) {
#pragma unroll
    for (int i = 0; i < 4; ++i) red[(warp * 32 + lane) * 4 + i] = acc[i];
  }
  __syncthreads();
  for (int o = tid; o < kTT * kNFP; o += kThreads) {
    const int r = o / kNFP, f = o % kNFP;
    const int fl = ((r % 8) * 4 + (f % 8) / 2) * 4 + ((r % 16) / 8) * 2 +
                   f % 2;  // lane * 4 + fragment element
    const int tl = (r / 16) * kNT + f / 8;
    float s = 0.f;
#pragma unroll
    for (int jj = 0; jj < kWT; ++jj) s += red[(jj * kTiles + tl) * 128 + fl];
    pr[o] = s;
  }
  __syncthreads();

  // 2. softmax over each head's K taps (column k*HB + hh of a row): warp
  //    w takes the (row, head) pairs w, w + 8, ..., lane k tap k (K <= 32)
  if (weight_softmax) {
    for (int i = warp; i < kTT * HB; i += kWarps) {
      float* row = pr + (i / HB) * kNFP + (i % HB);
      const float v = lane < K ? row[lane * HB] : -INFINITY;
      float m = v;
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float e = lane < K ? expf(v - m) : 0.f;
      float sum = e;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane < K) row[lane * HB] = e / sum;
    }
    __syncthreads();
  }

  // 3. out[t, c] = sum_k p[t, k, h(c)] * x[t - K + 1 + k, c] over the
  //    group's channels in windows of kCW: window row j holds time
  //    t0 - (K - 1) + j, so tap k of tile row t is row t + k
  for (int cb0 = 0; cb0 < CB; cb0 += kCW) {
    const int cw = min(kCW, CB - cb0);
    cp_async_wait<0>();
    __syncthreads();  // this window is in shared memory
    for (int i = tid; i < kTT * kCW; i += kThreads) {
      const int t = i / kCW, c = i % kCW;
      const int ti = t0 + t;
      if (c < cw && ti < T_len) {
        const float* p = pr + t * kNFP + (cb0 + c) / R;
        const T* wr = win + t * kCW + c;
        float s = 0.f;
        for (int k = 0; k < K; ++k) s += p[k * HB] * tt::to_f32(wr[k * kCW]);
        ob[(size_t)ti * C + c_base + cb0 + c] = tt::from_f32<T>(s);
      }
    }
    if (cb0 + kCW < CB) {
      __syncthreads();  // the window is read
      load_window<T>(win, xb, t0, K, c_base + cb0 + kCW,
                     min(kCW, CB - cb0 - kCW), T_len, C, tid, kTT + K - 1);
      cp_async_commit();
    }
  }
}

template <typename T, int kTT, int kNT>
cudaError_t launch_tile(const void* x, void* w_blk, void* out, int B,
                        int T_len, int C, int H, int K, int HB,
                        int weight_softmax, cudaStream_t stream) {
  const size_t ring = sizeof(T) * kStages * slot_elems<T, kTT, kNT>();
  const size_t red = sizeof(float) * kWarps * 128;
  const size_t window = sizeof(T) * (kTT + K - 1) * kCW;
  const size_t smem =
      sizeof(float) * kTT * 8 * kNT + (ring > red ? ring : red) + window;
  auto kernel = dynamic_conv_kernel<T, kTT, kNT>;
  cudaError_t err = tt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + kTT - 1) / kTT, H / HB, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_blk),
      static_cast<T*>(out), T_len, C, H, K, HB, weight_softmax);
  return cudaGetLastError();
}

template <typename T, int kTT>
cudaError_t launch_nt(const void* x, void* w_blk, void* out, int B,
                      int T_len, int C, int H, int K, int HB, int NFP,
                      int weight_softmax, cudaStream_t stream) {
  if (NFP == 8)
    return launch_tile<T, kTT, 1>(x, w_blk, out, B, T_len, C, H, K, HB,
                                  weight_softmax, stream);
  if (NFP == 16)
    return launch_tile<T, kTT, 2>(x, w_blk, out, B, T_len, C, H, K, HB,
                                  weight_softmax, stream);
  if (NFP == 32)
    return launch_tile<T, kTT, 4>(x, w_blk, out, B, T_len, C, H, K, HB,
                                  weight_softmax, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const void* x, const void* w_km, void* w_blk, void* out,
                   int B, int T_len, int C, int H, int K, int TT, int HB,
                   int NFP, int weight_softmax, cudaStream_t stream) {
  if (NFP < K * HB || HB < 1 || H % HB != 0 || C % H != 0 || C % 8 != 0 ||
      (C / H) % 8 != 0)
    return cudaErrorInvalidValue;
  conv_weight_blocks_kernel<T><<<C, kThreads, sizeof(float) * K * H,
                                 stream>>>(static_cast<const T*>(w_km),
                                           static_cast<T*>(w_blk), C, H, K,
                                           HB, NFP);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (TT == 16)
    return launch_nt<T, 16>(x, w_blk, out, B, T_len, C, H, K, HB, NFP,
                            weight_softmax, stream);
  if (TT == 32)
    return launch_nt<T, 32>(x, w_blk, out, B, T_len, C, H, K, HB, NFP,
                            weight_softmax, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, out [B,T,C] and w_km [C,K*H] in `dtype`; TT = 16 or 32 time rows a
// block, HB heads a block, NFP = 8, 16 or 32 >= K*HB logit columns a
// block; w_blk a scratch of (H/HB) * C * NFP elements of `dtype`.
extern "C" int tt_dynamic_conv(const void* x, const void* w_km, void* w_blk,
                               void* out, int B, int T, int C, int H, int K,
                               int TT, int HB, int NFP, int weight_softmax,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tt::kFloat32)
    return launch<float>(x, w_km, w_blk, out, B, T, C, H, K, TT, HB, NFP,
                         weight_softmax, st);
  if (dtype == tt::kBFloat16)
    return launch<__nv_bfloat16>(x, w_km, w_blk, out, B, T, C, H, K, TT, HB,
                                 NFP, weight_softmax, st);
  return cudaErrorInvalidValue;
}
