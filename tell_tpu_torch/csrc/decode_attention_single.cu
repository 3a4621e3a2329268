// Kernel F: single-shot decode cross-attention, over an fp K/V cache or a
// nibble-packed int4 one contracted in two halves, on kernel A's split-S
// body (decode_attention.cuh; the design is in decode_attention.cu's
// header, F's three launches beside its kernels there).
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
// product, as the TPU kernels and the plain versions do (kernel A rounds
// nothing before its PV product: compare F with the plain version, not
// with A).
//
// What bounds it on the H100: the K/V stream, the same bytes as kernel A
// (2*B*H*hd*S elements per call; half a byte each plus 8 bytes of scales
// per column for int4). MG*S*hd multiply-adds per contraction are far
// below the card's compute for those bytes.
//
// What the design does about it: the TPU kernels hold a batch row's whole
// [MG, S] score row in VMEM; a block's shared memory cannot hold it past
// S ~2560 at MG=20, and one block per (batch rows, head) would leave most
// of the 132 SMs idle. So F runs on A's chunks: a grid of (b, h, 256-column
// chunk) blocks whatever bb is, the scores of a chunk
// written to an fp32 scratch in device memory (MG floats per column,
// fewer bytes than K's hd, and L2-resident at the tools' sizes), the
// global max and sum formed from per-chunk statistics in chunk order, and
// the normalised, rounded p meeting V in A's PV passes. No shape of S is
// refused. `bb`, the TPU tools' knob, is checked by the wrapper and changes
// nothing here, so a row's output is the same bits at any bb and B.
#include "decode_attention.cuh"

namespace {

template <typename T, typename Kv>
cudaError_t dispatch_f(const void* q, const void* k, const void* v,
                       const void* k_scale, const void* v_scale,
                       const void* bias, void* scores, void* stats,
                       void* part, void* out, int B, int H, int MG, int hd,
                       int S, cudaStream_t st) {
  if (hd != 64) return cudaErrorInvalidValue;
  return with_rows(MG, [&](auto rows) {
    return launch_single<T, Kv, 64, decltype(rows)::value>(
        q, k, v, k_scale, v_scale, bias, scores, stats, part, out, B, H, MG,
        S, st);
  });
}

}  // namespace

// Kernel F over an fp cache: q, k, v, out in `dtype`; scratch: scores fp32
// [B,H,MG,S], stats fp32 pairs [B,H,MG,ceil(S/256)] (8-byte aligned), part
// fp32 [B,H,ceil(S/256),MG,hd] (unused, may be null, when S <= 256). hd =
// 64, MG <= 40.
extern "C" int tt_decode_attention_single(const void* q, const void* k,
                                          const void* v, const void* bias,
                                          void* scores, void* stats,
                                          void* part, void* out, int B,
                                          int H, int MG, int hd, int S,
                                          int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tt::kFloat32)
    return dispatch_f<float, KvFp<float>>(q, k, v, nullptr, nullptr, bias,
                                          scores, stats, part, out, B, H, MG,
                                          hd, S, st);
  if (dtype == tt::kBFloat16)
    return dispatch_f<__nv_bfloat16, KvFp<__nv_bfloat16>>(
        q, k, v, nullptr, nullptr, bias, scores, stats, part, out, B, H, MG,
        hd, S, st);
  return cudaErrorInvalidValue;
}

// Kernel F's int4-split form: q, out in `dtype`; k4, v4 packed int4
// [B,H,hd/2,S]; k_scale, v_scale fp32 [B,H,1,S]; the scratch and shapes of
// tt_decode_attention_single.
extern "C" int tt_decode_attention_q4split(
    const void* q, const void* k4, const void* k_scale, const void* v4,
    const void* v_scale, const void* bias, void* scores, void* stats,
    void* part, void* out, int B, int H, int MG, int hd, int S, int dtype,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tt::kFloat32)
    return dispatch_f<float, KvInt4>(q, k4, v4, k_scale, v_scale, bias,
                                     scores, stats, part, out, B, H, MG, hd,
                                     S, st);
  if (dtype == tt::kBFloat16)
    return dispatch_f<__nv_bfloat16, KvInt4>(q, k4, v4, k_scale, v_scale,
                                             bias, scores, stats, part, out,
                                             B, H, MG, hd, S, st);
  return cudaErrorInvalidValue;
}
