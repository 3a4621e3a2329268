// Kernel A: multi-context decode cross-attention. Its split-S body
// (decode_attention.cuh) also carries kernel D, the same attention over an
// int8 or nibble-packed int4 K/V cache (decode_attention_q8.cu), and
// kernel F, the single-shot form that normalises p before rounding it
// (decode_attention_single.cu).
//
// Kernel A replaces tell_tpu/ops/kernels/decode_attention.py::
// fused_decode_attention (_kernel, pallas_call at :216) and its S-tiled
// form _tiled_decode_attention (_kernel_tiled, pallas_call at :177).
//
//   out[b,h,x,:] = softmax_s(q[b,h,x,:] . k[b,h,:,s] + bias[b,x,s])
//                  . v[b,h,:,s]
//
// q [B,H,MG,hd]; k, v [B,H,hd,S] (head-major, transposed, as the JAX decode
// state stores them); bias [B,MG,S] fp32 (0 or -inf); out [B,H,MG,hd]. q,
// k, v in fp32 or bf16, fp32 scores, softmax and accumulators.
//
// What bounds it on the H100: the K/V stream, 2*B*H*S*hd elements per
// layer per decode step. The query side is tiny (MG = 4 greedy or 20
// beam-5 rows of hd = 64), so this is a bandwidth kernel. The bias
// [B,MG,S] is read once per head, from L2.
//
// The design, in three parts:
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
//    per FMA). The 8 warps' partials are added in warp order through
//    shared memory. At MG = 20 these shared-memory reads, not the bytes or
//    the FMAs, set the time: the readings fit a 16-byte read costing four
//    of the SM's shared-memory cycles even when all lanes read the same
//    address.
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
#include "decode_attention.cuh"

namespace {

// Kernel A's instantiations: kRows = 4, 8, 20 or 40, head dims 32, 64, 128.
template <typename T>
cudaError_t dispatch_a(const void* q, const void* k, const void* v,
                       const void* bias, void* part, void* out, int B, int H,
                       int MG, int hd, int S, cudaStream_t st) {
  if (hd == 32)
    return dispatch_rows<T, KvFp<T>, 32>(q, k, v, nullptr, nullptr, bias,
                                         part, out, B, H, MG, S, st);
  if (hd == 64)
    return dispatch_rows<T, KvFp<T>, 64>(q, k, v, nullptr, nullptr, bias,
                                         part, out, B, H, MG, S, st);
  if (hd == 128)
    return dispatch_rows<T, KvFp<T>, 128>(q, k, v, nullptr, nullptr, bias,
                                          part, out, B, H, MG, S, st);
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
