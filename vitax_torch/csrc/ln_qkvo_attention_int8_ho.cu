// K5, the attention half of the int8 block handoff: replaces
// _ln_qkvo_fwd_int8_ho_kernel (vitax/ops/pallas_kernels.py:3669), called at
// :3784 by _qkvo_ho_fwd_call from fused_block_int8_handoff (:3863). It is K3's
// forward (ln_qkvo_attention_int8.cu) without its LN+quant prologue: it takes
// the packed LN1 output (xq, sx) that the previous block's MLP epilogue wrote,
// adds the residual in fp32 and packs LN2 of the result for the MLP half:
//
//   qkv    = bf16(f32(xq Wq) sx sw + bqkv)
//   per head: the bf16 core with fp32 softmax, attn = p·v in fp32
//   aq, sa = quant_rows(attn)
//   r1     = bf16(f32(x) + f32(aq Woq) sa swo + bo)     the handoff's rounding
//   xq2, sx2 = quant_rows(LN2(f32(r1)))                 fp32 statistics, codes
//                                                       from the fp32 LN output
//
// The first block of the encoder has no previous epilogue: with `pack` set,
// the first launch packs x itself with LN1's γ/β (vitax's pack_stream :3840,
// which runs in XLA), into xq/sx. vitax carries 8 broadcast scale lanes a row
// (_HO_SCALE_LANES); the port keeps one fp32 scale a row.
//
// Bound on the H100: the two s8 projections (2·N·D·3hhd + 2·N·hhd·D
// operations at 1979 TOP/s) and the attention core (4·spq²·hd a head, bf16
// on the tensor cores). Design: K3's Hopper sequence without its prologue,
// on one stream after the weights' column codes (quant.cuh, as [N, K]):
//   1. with `pack` only, the LN-quant of x (layernorm.cuh, row in registers);
//   2. qkv = bf16(dq(xq·W8ᵀ) + bqkv) on gemm_sm90.cuh's s8 wgmma path
//      (kEpiS8Bf16): the call K3's forward and K3's backward recompute make,
//      so qkv keeps their bits;
//   3. K13's forward core (attention_core.cuh, kRowsFwdF32) on the packed qkv
//      rows with strided operands, set up as K3's forward sets it up: query
//      rows to spq, keys masked at seq_len, attn written in fp32, never
//      rounded;
//   4. the row quantizer over attn (quant.cuh): a row spans every head;
//   5. r1 = bf16(f32(x) + (dq(aq·Wo8ᵀ) + bo)) on the s8 path
//      (kEpiS8ResidualF32: x is read in the epilogue only);
//   6. the LN-quant row pass over the bf16 r1 into xq2, sx2 (layernorm.cuh):
//      vitax quantizes the bf16-rounded r1 (:3721-3729), and a row's LN spans
//      all six N tiles of the out-projection, so it cannot sit in one tile's
//      epilogue.
// K13's p differs from the twin's softmax in its last bits, so r1 and the
// packed LN2 move within the int8 band, as K3's out does.
#include "gemm_sm90.cuh"
#include "layernorm.cuh"

// Inputs x bf16 [n, d] (n = b·spq), xq int8 [n, d] and sx fp32 [n] (written
// here when pack != 0), g1, be1 (read only when packing), g2, be2 fp32 [d],
// wqkv bf16 [d, 3hhd], bqkv [3hhd], wo bf16 [hhd, d], bo [d]. Outputs r1 bf16
// [n, d], xq2 int8 [n, d], sx2 fp32 [n]. Scratch: w8t int8 [3hhd, d], sw
// [3hhd], wo8t int8 [d, hhd], swo [d], qkv bf16 [n, 3hhd], attn fp32
// [n, hhd], aq int8 [n, hhd], sa [n].
extern "C" int vitax_ln_qkvo_attention_int8_ho_fwd(
    const void* x, void* xq, void* sx, const void* g1, const void* be1, const void* g2,
    const void* be2, const void* wqkv, const void* bqkv, const void* wo, const void* bo, void* w8t,
    void* sw, void* wo8t, void* swo, void* qkv, void* attn, void* aq, void* sa, void* r1,
    void* xq2, void* sx2, int b, int spq, int d, int seq_len, int heads, int head_dim, int pack,
    float eps, float scale, void* stream) {
  using vitax::bf16;
  namespace sm90 = vitax::sm90;
  const auto st = static_cast<cudaStream_t>(stream);
  const int n = b * spq;
  const int hhd = heads * head_dim;
  const int w = 3 * hhd;
  const auto* xb = static_cast<const bf16*>(x);
  auto* xqi = static_cast<int8_t*>(xq);
  auto* sxf = static_cast<float*>(sx);
  const auto* w8 = static_cast<const int8_t*>(w8t);
  const auto* wo8 = static_cast<const int8_t*>(wo8t);
  auto* qkvb = static_cast<bf16*>(qkv);
  auto* attnf = static_cast<float*>(attn);
  auto* aqi = static_cast<int8_t*>(aq);
  auto* saf = static_cast<float*>(sa);
  auto* r1b = static_cast<bf16*>(r1);
  if (n == 0) return cudaSuccess;
  if (b > 65535 || seq_len <= 0 || seq_len > spq) return cudaErrorInvalidValue;
  cudaError_t e = vitax::launch_quant_weight_cols_t(static_cast<const bf16*>(wqkv),
                                                    static_cast<int8_t*>(w8t),
                                                    static_cast<float*>(sw), d, w, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_weight_cols_t(static_cast<const bf16*>(wo), static_cast<int8_t*>(wo8t),
                                        static_cast<float*>(swo), hhd, d, st);
  if (e != cudaSuccess) return e;
  if (pack) {
    e = vitax::launch_layer_norm_quant<false>(xb, static_cast<const float*>(g1),
                                              static_cast<const float*>(be1), xqi, sxf, nullptr,
                                              n, d, eps, st);
    if (e != cudaSuccess) return e;
  }
  e = sm90::gemm_s8<sm90::kEpiS8Bf16>(xqi, w8, sxf, static_cast<const float*>(sw),
                                      static_cast<const float*>(bqkv), qkvb, nullptr, n, w, d, st);
  if (e != cudaSuccess) return e;
  vitax::k13::CoreArgs a{};
  a.q = qkvb, a.k = qkvb + hhd, a.v = qkvb + 2 * hhd, a.o32 = attnf;
  a.seq = seq_len, a.rows = a.kv_rows = spq, a.img_rows = a.kv_img_rows = spq, a.heads = heads;
  a.kv_heads = heads;
  a.scale = scale;
  a.ld_q = a.ld_k = a.ld_v = w;
  a.ld_o = hhd;
  e = vitax::k13::launch_core_rows<vitax::k13::kRowsFwdF32>(a, head_dim, b, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_rows(static_cast<const float*>(attnf), aqi, saf, n, hhd, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_s8<sm90::kEpiS8ResidualF32>(aqi, wo8, saf, static_cast<const float*>(swo),
                                             static_cast<const float*>(bo), r1b, nullptr, n, d,
                                             hhd, st, xb);
  if (e != cudaSuccess) return e;
  return vitax::launch_layer_norm_quant<false>(r1b, static_cast<const float*>(g2),
                                               static_cast<const float*>(be2),
                                               static_cast<int8_t*>(xq2),
                                               static_cast<float*>(sx2), nullptr, n, d, eps, st);
}
