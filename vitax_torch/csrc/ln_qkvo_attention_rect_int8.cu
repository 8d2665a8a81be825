// K8's W8A8 tier, the rect fused attention half with int8 projections:
// replaces _ln_qkvo_rect_fwd_int8_kernel (vitax/ops/pallas_kernels.py:4067),
// the int8 branch of fused_ln_qkvo_attention_rect (:4410, pallas_call at
// :4447). K3's arithmetic on K8's row sets (:4076-4109):
//
//   xqc, sxc = quant_rows(LN(xc)),  xq, sx = quant_rows(LN(x))   fp32 LN out
//   q    = bf16(f32(xqc Wq8) sxc swq + bq)      Q columns of Wqkv, per column
//   kv   = bf16(f32(xq Wkv8) sx swkv + bkv)     K and V columns
//   per head: K1's core over the spq keys, attn = p·v in fp32 (never bf16)
//   aq, sa = quant_rows(attn)
//   out  = bf16(f32(aq Woq) sa swo + bo)       [B, cpq, D], no residual
//
// Per-column codes and scales do not depend on the other columns, so
// quantizing Wqkv whole (K3's weight quantization, quant.cuh, written [N, K])
// gives the codes vitax's split Wq and Wkv get: the Q GEMM reads rows
// [0, H·hd) of the transposed codes and the KV GEMM rows [H·hd, 3·H·hd), both
// contiguous, with the matching slices of the scales and biases; K3 and K8
// hold the same weight codes. Row scales are per row, so the gathered rows'
// codes, and every output row, equal K3's for the same tokens.
//
// Bound on the H100: the two s8 projections at 1979 TOP/s (2·(B·cpq·hhd +
// B·spq·2hhd)·D and 2·B·cpq·D·hhd operations) and the core (4·cpq·spq·hd a
// head, bf16 on the tensor cores).
//
// The Hopper design (since the port's K3 moved to it): K3's forward
// sequence (ln_qkvo_attention_int8.cu) on K8's two row sets, eight launches
// on one stream after the weights' column codes (quant.cuh, Wqkv whole and
// Wo, as [N, K]):
//   1-2. the LN-quant prologue (layernorm.cuh, the row in registers) of xc
//      and of x: xqc, sxc and xq, sx;
//   3. q = bf16(dq(xqc·Wq8ᵀ) + bq) on gemm_sm90.cuh's s8 wgmma path
//      (kEpiS8Bf16) over rows [0, hhd) of the codes;
//   4. kv = bf16(dq(xq·Wkv8ᵀ) + bkv) likewise over rows [hhd, 3hhd);
//   5. K13's forward core (attention_core.cuh, kRowsFwdF32) in its rect
//      geometry: the cpq query rows of q (row stride hhd) against the spq
//      key rows of kv (K columns, then V; row stride 2hhd), keys masked at
//      seq_len, p rounded to bf16 once, attn = p·v written in fp32;
//   6. the row quantizer over the fp32 attn (quant.cuh);
//   7. out = bf16(dq(aq·Wo8ᵀ) + bo) on the s8 path (kEpiS8Bf16).
// Every launch is per row (the LN-quant, the products' epilogues, K13's
// row statistics and p·v, the row codes), and each is K3's own call, so a
// kept row's out equals K3's forward on x followed by the row gather, bit
// for bit: vitax's contract for this kernel (:4418-4419). xqc, xq, q, kv,
// the fp32 attn and aq go through device memory where the TPU kernel keeps
// them in VMEM; the scores never do.
//
// R-F, the A4W4 rect forward (vitax_ln_qkvo_attention_rect_int4_fwd):
// replaces _ln_qkvo_rect_fwd_int4_kernel (:4112), the int4 branch of
// fused_ln_qkvo_attention_rect (:4440, pallas_call at :4447). Its body
// (:4120-4152) is the int8 one's with every quantizer on the int4 grid:
// _quant_rows4 of the two fp32 LN outputs and of the fp32 attn,
// _quant_cols_host4 of Wq, Wkv and Wo (limit 7, quant.cuh), the core bf16
// with fp32 softmax, codes in int8, summed exactly by the s8 GEMM (the H100
// has no int4 tensor rate). It keeps the first design in a branch of its
// own, as K11-C does: the same steps with gemm.cuh's mma.sync s8 GEMM and
// attention.cuh's whole-row core in its rect geometry, nine launches after
// the weights' codes. Bound: the int8 tier's.
#include "attention.cuh"
#include "gemm.cuh"
#include "gemm_sm90.cuh"
#include "layernorm.cuh"

namespace {

// K8's int8 tier (L = 127), the Hopper design.
int ln_qkvo_attention_rect_int8_fwd_sm90(
    const void* xc, const void* x, const void* gamma, const void* beta, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, void* w8t, void* sw, void* wo8t, void* swo,
    void* xqc, void* sxc, void* xq, void* sx, void* q, void* kv, void* attn, void* aq, void* sa,
    void* out, int b, int cpq, int spq, int d, int seq_len, int heads, int head_dim, float eps,
    float scale, cudaStream_t st) {
  using vitax::bf16;
  namespace sm90 = vitax::sm90;
  const int nc = b * cpq;
  const int n = b * spq;
  const int hhd = heads * head_dim;
  if (nc == 0) return cudaSuccess;
  if (b > 65535 || seq_len <= 0 || seq_len > spq) return cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  const auto* bias = static_cast<const float*>(bqkv);
  auto* w8 = static_cast<int8_t*>(w8t);
  auto* swf = static_cast<float*>(sw);
  auto* xqci = static_cast<int8_t*>(xqc);
  auto* sxcf = static_cast<float*>(sxc);
  auto* xqi = static_cast<int8_t*>(xq);
  auto* sxf = static_cast<float*>(sx);
  auto* qb = static_cast<bf16*>(q);
  auto* kvb = static_cast<bf16*>(kv);
  auto* attnf = static_cast<float*>(attn);
  auto* aqi = static_cast<int8_t*>(aq);
  auto* saf = static_cast<float*>(sa);
  cudaError_t e =
      vitax::launch_quant_weight_cols_t(static_cast<const bf16*>(wqkv), w8, swf, d, 3 * hhd, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_weight_cols_t(static_cast<const bf16*>(wo), static_cast<int8_t*>(wo8t),
                                        static_cast<float*>(swo), hhd, d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_layer_norm_quant<false, false>(static_cast<const bf16*>(xc), g, be, xqci, sxcf,
                                                   nullptr, nc, d, eps, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_layer_norm_quant<false, false>(static_cast<const bf16*>(x), g, be, xqi, sxf,
                                                   nullptr, n, d, eps, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_s8<sm90::kEpiS8Bf16>(xqci, w8, sxcf, swf, bias, qb, nullptr, nc, hhd, d, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_s8<sm90::kEpiS8Bf16>(xqi, w8 + static_cast<size_t>(hhd) * d, sxf, swf + hhd,
                                      bias + hhd, kvb, nullptr, n, 2 * hhd, d, st);
  if (e != cudaSuccess) return e;
  vitax::k13::CoreArgs a{};
  a.q = qb, a.k = kvb, a.v = kvb + hhd, a.o32 = attnf;
  a.seq = seq_len, a.rows = a.img_rows = cpq, a.kv_rows = a.kv_img_rows = spq, a.heads = heads;
  a.kv_heads = heads;
  a.scale = scale;
  a.ld_q = a.ld_o = hhd;
  a.ld_k = a.ld_v = 2 * hhd;
  e = vitax::k13::launch_core_rows<vitax::k13::kRowsFwdF32>(a, head_dim, b, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_rows(static_cast<const float*>(attnf), aqi, saf, nc, hhd, st);
  if (e != cudaSuccess) return e;
  return sm90::gemm_s8<sm90::kEpiS8Bf16>(aqi, static_cast<const int8_t*>(wo8t), saf,
                                         static_cast<const float*>(swo),
                                         static_cast<const float*>(bo), static_cast<bf16*>(out),
                                         nullptr, nc, d, hhd, st);
}

// R-F (L = 7), the first design.
int ln_qkvo_attention_rect_int4_fwd_first(
    const void* xc, const void* x, const void* gamma, const void* beta, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, void* w8t, void* sw, void* wo8t, void* swo,
    void* xqc, void* sxc, void* xq, void* sx, void* q, void* kv, void* attn, void* aq, void* sa,
    void* out, int b, int cpq, int spq, int d, int seq_len, int heads, int head_dim, float eps,
    float scale, void* stream) {
  using vitax::bf16;
  constexpr int L = vitax::kQ4;
  const auto st = static_cast<cudaStream_t>(stream);
  const int nc = b * cpq;
  const int n = b * spq;
  const int hhd = heads * head_dim;
  if (nc == 0) return cudaSuccess;
  const auto* g = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  const auto* bias = static_cast<const float*>(bqkv);
  auto* w8 = static_cast<int8_t*>(w8t);
  auto* swf = static_cast<float*>(sw);
  auto* xqci = static_cast<int8_t*>(xqc);
  auto* sxcf = static_cast<float*>(sxc);
  auto* xqi = static_cast<int8_t*>(xq);
  auto* sxf = static_cast<float*>(sx);
  auto* qb = static_cast<bf16*>(q);
  auto* kvb = static_cast<bf16*>(kv);
  auto* attnf = static_cast<float*>(attn);
  auto* aqi = static_cast<int8_t*>(aq);
  auto* saf = static_cast<float*>(sa);
  cudaError_t e = vitax::launch_quant_weight_cols_t<L>(static_cast<const bf16*>(wqkv), w8, swf, d,
                                                       3 * hhd, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_weight_cols_t<L>(static_cast<const bf16*>(wo),
                                           static_cast<int8_t*>(wo8t), static_cast<float*>(swo),
                                           hhd, d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_layer_norm_quant<false, false, L>(static_cast<const bf16*>(xc), g, be, xqci,
                                                      sxcf, nullptr, nc, d, eps, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_layer_norm_quant<false, false, L>(static_cast<const bf16*>(x), g, be, xqi, sxf,
                                                      nullptr, n, d, eps, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm_s8<vitax::kS8Bf16>(xqci, w8, sxcf, swf, bias, nullptr, qb,
                                            nullptr, nc, hhd, d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm_s8<vitax::kS8Bf16>(xqi, w8 + static_cast<size_t>(hhd) * d, sxf,
                                            swf + hhd, bias + hhd, nullptr, kvb, nullptr,
                                            n, 2 * hhd, d, st);
  if (e != cudaSuccess) return e;
  const vitax::AttnGeom geom{qb,  static_cast<size_t>(hhd), cpq,   kvb, 2 * static_cast<size_t>(hhd),
                             spq, 0,                         hhd,   heads, heads,
                             b,   seq_len,                   scale};
  e = vitax::launch_attention_core_geom(geom, head_dim, attnf, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_rows<L>(static_cast<const float*>(attnf), aqi, saf, nc, hhd, st);
  if (e != cudaSuccess) return e;
  return vitax::launch_gemm_s8<vitax::kS8Bf16>(
      aqi, static_cast<const int8_t*>(wo8t), saf, static_cast<const float*>(swo),
      static_cast<const float*>(bo), nullptr, static_cast<bf16*>(out), nullptr, nc, d,
      hhd, st);
}

}  // namespace

// Inputs xc bf16 [b·cpq, d], x bf16 [b·spq, d], gamma, beta fp32 [d], wqkv bf16
// [d, 3hhd], bqkv [3hhd], wo bf16 [hhd, d], bo [d]; output out bf16 [b·cpq, d].
// Scratch: w8t int8 [3hhd, d], sw [3hhd], wo8t int8 [d, hhd], swo [d], xqc
// int8 [b·cpq, d], sxc [b·cpq], xq int8 [b·spq, d], sx [b·spq], q bf16
// [b·cpq, hhd], kv bf16 [b·spq, 2hhd], attn fp32 [b·cpq, hhd], aq int8
// [b·cpq, hhd], sa [b·cpq].
extern "C" int vitax_ln_qkvo_attention_rect_int8_fwd(
    const void* xc, const void* x, const void* gamma, const void* beta, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, void* w8t, void* sw, void* wo8t, void* swo,
    void* xqc, void* sxc, void* xq, void* sx, void* q, void* kv, void* attn, void* aq, void* sa,
    void* out, int b, int cpq, int spq, int d, int seq_len, int heads, int head_dim, float eps,
    float scale, void* stream) {
  return ln_qkvo_attention_rect_int8_fwd_sm90(
      xc, x, gamma, beta, wqkv, bqkv, wo, bo, w8t, sw, wo8t, swo, xqc, sxc, xq, sx, q, kv, attn,
      aq, sa, out, b, cpq, spq, d, seq_len, heads, head_dim, eps, scale,
      static_cast<cudaStream_t>(stream));
}

// R-F: the int8 tier's arguments on the int4 grid.
extern "C" int vitax_ln_qkvo_attention_rect_int4_fwd(
    const void* xc, const void* x, const void* gamma, const void* beta, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, void* w8t, void* sw, void* wo8t, void* swo,
    void* xqc, void* sxc, void* xq, void* sx, void* q, void* kv, void* attn, void* aq, void* sa,
    void* out, int b, int cpq, int spq, int d, int seq_len, int heads, int head_dim, float eps,
    float scale, void* stream) {
  return ln_qkvo_attention_rect_int4_fwd_first(
      xc, x, gamma, beta, wqkv, bqkv, wo, bo, w8t, sw, wo8t, swo, xqc, sxc, xq, sx, q, kv, attn,
      aq, sa, out, b, cpq, spq, d, seq_len, heads, head_dim, eps, scale, stream);
}
