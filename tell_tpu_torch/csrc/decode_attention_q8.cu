// Kernel D: kernel A's decode cross-attention over an int8 or
// nibble-packed int4 K/V cache, on kernel A's split-S body
// (decode_attention.cuh; the design is in decode_attention.cu's header).
//
// Replaces tell_tpu/ops/kernels/decode_attention.py::
// fused_decode_attention_q8 (_kernel_q8, pallas_call at :399) and its
// S-tiled form _tiled_decode_attention_q8 (_kernel_q8_tiled, pallas_call at
// :347), int8 and int4 (unpack_int4, :238-249).
//
//   out[b,h,x,:] = sum_s softmax_s((q . k8[:,s]) * k_scale[s] + bias[x,s])
//                  * v_scale[s] * v8[:,s]
//
// q [B,H,MG,hd] fp32 or bf16; k8, v8 int8 [B,H,hd,S] or packed int4
// [B,H,hd/2,S] (byte d holds row d in its low nibble and row d+hd/2 in its
// high nibble, signed in [-7,7]); k_scale, v_scale fp32 [B,H,1,S]; bias
// [B,MG,S] fp32 (0 or -inf); out [B,H,MG,hd] in q's dtype.
//
// What bounds it on the H100: the K/V stream, one byte per element (int8)
// or half a byte (int4) plus 8 bytes of scales per column: a quarter or an
// eighth of kernel A's fp32 bytes. With the same body as A, the time at
// MG = 20 is set by the same shared-memory operand reads, so D is held to
// take no longer than A at the same shape.
//
// What differs from A: thread t streams its column's bytes kSlice stored
// rows a step (a warp's loads coalesce on 32 consecutive columns) and
// dequantises them exactly in registers (int8 by a cast; int4 by
// sign-extending each nibble in int32, one byte feeding rows d and
// d+hd/2, which meet q rows d and d+hd/2). k_scale[s] scales the column's
// score before the bias; v_scale[s] waits in shared memory beside p. The
// running sum l adds the raw exponentials while the PV product takes them
// times v_scale (the TPU's tiled q8 kernel, _kernel_q8_tiled). The split,
// the partials and the combine are A's, so S alone sets the order of a
// row's sums, and a batch row's output is the same bits at B=1 and B=8.
#include "decode_attention.cuh"

namespace {

template <typename T, typename Kv>
cudaError_t dispatch_d(const void* q, const void* k8, const void* v8,
                       const void* k_scale, const void* v_scale,
                       const void* bias, void* part, void* out, int B, int H,
                       int MG, int hd, int S, cudaStream_t st) {
  if (hd == 32)
    return dispatch_rows<T, Kv, 32>(q, k8, v8, k_scale, v_scale, bias, part,
                                    out, B, H, MG, S, st);
  if (hd == 64)
    return dispatch_rows<T, Kv, 64>(q, k8, v8, k_scale, v_scale, bias, part,
                                    out, B, H, MG, S, st);
  return cudaErrorInvalidValue;
}

template <typename Kv>
int dispatch_dtype(const void* q, const void* k8, const void* v8,
                   const void* k_scale, const void* v_scale, const void* bias,
                   void* part, void* out, int B, int H, int MG, int hd, int S,
                   int dtype, cudaStream_t st) {
  if (dtype == tt::kFloat32)
    return dispatch_d<float, Kv>(q, k8, v8, k_scale, v_scale, bias, part,
                                 out, B, H, MG, hd, S, st);
  if (dtype == tt::kBFloat16)
    return dispatch_d<__nv_bfloat16, Kv>(q, k8, v8, k_scale, v_scale, bias,
                                         part, out, B, H, MG, hd, S, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Kernel D: q, out in `dtype`; k8, v8 int8 [B,H,hd,S] (packed4 = 0) or
// packed int4 [B,H,hd/2,S] (packed4 = 1); k_scale, v_scale fp32 [B,H,1,S];
// part fp32 scratch of B*H*ceil(S/256)*MG*(hd+2) floats (unused, may be
// null, when S <= 256). hd 32 or 64, MG <= 40.
extern "C" int tt_decode_attention_q8(const void* q, const void* k8,
                                      const void* k_scale, const void* v8,
                                      const void* v_scale, const void* bias,
                                      void* part, void* out, int B, int H,
                                      int MG, int hd, int S, int packed4,
                                      int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (packed4)
    return dispatch_dtype<KvInt4>(q, k8, v8, k_scale, v_scale, bias, part,
                                  out, B, H, MG, hd, S, dtype, st);
  return dispatch_dtype<KvInt8>(q, k8, v8, k_scale, v_scale, bias, part,
                                out, B, H, MG, hd, S, dtype, st);
}
