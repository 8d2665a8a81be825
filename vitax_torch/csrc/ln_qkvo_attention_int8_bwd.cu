// K3 backward under int8_grad, the fused LN-QKVO attention half: replaces
// _ln_qkvo_bwd_int8_kernel (vitax/ops/pallas_kernels.py:2977), the int8
// branch of _fused_ln_qkvo_bwd (:3232, pallas_call at :3252), with int8_dw
// off or on and int4_grad off. In the order of the Pallas body (:3003-3088), the
// SwitchBack split (int8 recompute and dx-path, bf16 core grads and weight
// grads):
//
//   recompute: xn32 = LN1(x), xn = bf16(xn32); xq, sx = quant_rows(xn32)
//              qkv = bf16(f32(xq Wq) sx sw + bqkv); the core with bf16 attn
//              (_attn_core_recompute :2814 rounds it, unlike the forward)
//   doq, sdo = quant_rows(do); dattn = bf16(f32(doq Wor^T) sdo swor)
//   dWo = attn^T do, dbo = Σ do
//   dqkv = the core grads (bf16, K1's query-tile and key-tile passes)
//   dqq, sdq = quant_rows(dqkv); dxn = f32(dqq Wr^T) sdq swr
//   dW = xn^T dqkv, db = Σ f32(dqkv)
//   LN tail: dx = bf16(dx_ln), dγ = Σ dxn x̂, dβ = Σ dxn
//
// With int8_dw the two weight grads are the per-group int8 products with
// row-scale folding (:3041-3049, :3077-3084; dw_int8.cuh), over groups of
// `group` rows (the wrapper's: whole images, tile*spq):
//   dWo = Σ_z f32(quant_cols(attn_z sdo_z)^T doq_z) sat_z    attn the bf16 recompute
//   dW  = Σ_z f32(quant_cols(xn32_z sdq_z)^T dqq_z) sxn_z    xn32 the fp32 LN output
//
// GQA (K7's int8 tier, the kv_heads branch of :2977): kv_heads < heads packs
// qkv, dqkv and the weights' columns as [q | k | v] at width (H + 2·Hkv)·hd;
// the core grads sum dK and dV of each kv group over its H/Hkv query heads
// in fp32 before one cast, and the rest runs as above at that width.
//
// The first launches quantize the weights (quant.cuh): Wq/sw, Wqkv per
// output column, as [W, D]; Wr/swr and Wor/swor, Wqkv and Wo per row,
// contracted over their columns, as they are. Weight and vector grads come
// out in fp32, as the TPU kernel's outputs.
//
// Bound on the H100: the projections (three s8 at 1979 TOP/s, and two
// bf16 kTN at 989 TFLOP/s or, with int8_dw, two s8) on the tensor cores,
// and the attention core's recompute and backward.
//
// The Hopper design, every kv_heads (K1's backward's sequence,
// ln_qkvo_attention_bwd.cu, with the int8 pieces swapped in):
//   1. the LN-quant recompute (layernorm.cuh: the row in registers) writes
//      xq, sx and xn (bf16, or fp32 under int8_dw);
//   2. qkv on gemm_sm90.cuh's s8 wgmma path (kEpiS8Bf16 + bias);
//   3. K13's forward core (attention_core.cuh) on the packed qkv rows with
//      strided operands, attn in bf16 as _attn_core_recompute rounds it;
//   4. doq, sdo; dattn = bf16(f32(doq·Wo8rᵀ)·sdo·swor) on the s8 path;
//   5. dWo: gemm_sm90.cuh's kTN or, under int8_dw, dw_int8.cuh's operand
//      packs (each group's rows padded to the 128-code K tile) and the s8
//      path's group fold (kEpiS8Group); dbo a column sum;
//   6. the core grads through K13's three backward passes (a row pass
//      writing m·scale·log2e, 1/l and dd from the bf16 attn, a key pass for
//      dk, dv, a query pass for dq), written straight into dqkv's packed
//      columns: neither P nor ds reaches device memory (the first design
//      kept 2·B·H·L² bf16 of them, 66 MB at b32 spq 200). With kv_heads <
//      heads the core runs in its GQA geometry (attention_core.cuh's
//      CoreArgs::kv_heads): query head h reads k, v of group h·Hkv/H, and
//      a key pass block owns a (64-key tile, kv group) and walks the query
//      tiles of the group's H/Hkv heads in turn, dK and dV in fp32
//      registers across the walk, scaled and cast once;
//   7. dqq, sdq (dqkv's row codes), then dxn on the s8 path (kEpiS8F32);
//   8. dW (kTN, or the group fold from the fp32 xn), dbqkv, the LN tail.
// The core's grads are K1's backward's, so dqkv and everything downstream
// of it move from the first design (as K1's did when it took K13's core),
// within the int8 band; the products' epilogues keep gemm.cuh's fp32
// operations. No float atomics: two runs give the same bits.
//
// K11-D, the int4_grad branch (vitax_ln_qkvo_attention_int4_bwd): the same
// Pallas body with _qr = _quant_rows4 (:2998) and the int4 weight forms the
// caller passes (_quant_cols_host4 of Wqkv for the recompute,
// _quant_rows_host4 of Wqkv and Wo for dxn and dattn, :3247-3250): every
// quantizer of the recompute and the dx-path on the int4 grid (limit 7,
// quant.cuh), the core grads bf16. It runs the Hopper sequence above at
// L = 7, with and without kv_heads (G-B): the weights' codes, the LN-quant
// recompute and the row codes of do and dqkv on the int4 grid, codes in
// int8 on the same s8 products, K13's forward recompute and three passes.
// Under int8_dw the two weight grads are products of int8 codes packed
// fresh per column over each group, both operands, with no row-scale
// folding (:3033-3040, :3071-3076):
//   dWo = Σ_z f32(quant_cols(attn_z)^T quant_cols(do_z)) sat_z sdo_z
//   dW  = Σ_z f32(quant_cols(xn32_z)^T quant_cols(dqkv_z)) sxn_z sdq_z
// over K3's groups: dw_int8.cuh's column packs of both operands (each
// group's rows padded to the 128-code K tile), then the s8 path's
// two-scale group fold (kEpiS8GroupRC), in gemm.cuh's kS8GroupF32RC order.
#include "dw_int8.cuh"
#include "gemm.cuh"
#include "gemm_sm90.cuh"
#include "layernorm.cuh"

namespace {

// The Hopper design on the grid of limit L: K3 and K7 (L = 127), K11-D and
// G-B (L = 7). sdoc and sdqc, do's and dqkv's column scales, are the int4
// int8_dw's (null at L = 127, whose fold reuses their row codes).
template <int L>
int ln_qkvo_attention_quant_bwd_sm90(
    const void* x, const void* gamma, const void* beta, const void* bqkv, const void* wqkv,
    const void* wo, const void* dout, void* dx, void* dgamma, void* dbeta, void* dwqkv,
    void* dbqkv, void* dwo, void* dbo, void* w8t, void* sw, void* w8r, void* swr, void* wo8r,
    void* swor, void* xn, void* xq, void* sx, void* qkv, void* attn, void* doq, void* sdo,
    void* dattn, void* stats, void* dqkv, void* dqq, void* sdq, void* dxn, void* ws, void* atct,
    void* sat, void* doqt, void* sdoc, void* xnct, void* sxn, void* dqqt, void* sdqc, int b,
    int spq, int d, int seq_len, int heads, int kv_heads, int head_dim, int group, int int8_dw,
    float eps, float scale, cudaStream_t st) {
  using vitax::bf16;
  namespace sm90 = vitax::sm90;
  const int n = b * spq;
  const int hhd = heads * head_dim;
  const int kvw = kv_heads * head_dim;
  const int w = hhd + 2 * kvw;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* dob = static_cast<const bf16*>(dout);
  auto* xqi = static_cast<int8_t*>(xq);
  auto* sxf = static_cast<float*>(sx);
  auto* qkvb = static_cast<bf16*>(qkv);
  auto* attnb = static_cast<bf16*>(attn);
  auto* doqi = static_cast<int8_t*>(doq);
  auto* sdof = static_cast<float*>(sdo);
  auto* dattnb = static_cast<bf16*>(dattn);
  auto* dqkvb = static_cast<bf16*>(dqkv);
  auto* dqqi = static_cast<int8_t*>(dqq);
  auto* sdqf = static_cast<float*>(sdq);
  auto* dxnf = static_cast<float*>(dxn);
  auto* wsf = static_cast<float*>(ws);
  constexpr bool kCols = L == vitax::kQ4;  // int8_dw on fresh column packs
  if (b > 65535 || seq_len <= 0 || seq_len > spq) return cudaErrorInvalidValue;

  const auto* wqkvb = static_cast<const bf16*>(wqkv);
  cudaError_t e = vitax::launch_quant_weight_cols_t<L>(wqkvb, static_cast<int8_t*>(w8t),
                                                       static_cast<float*>(sw), d, w, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_weight_rows<L>(wqkvb, static_cast<int8_t*>(w8r),
                                         static_cast<float*>(swr), d, w, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_weight_rows<L>(static_cast<const bf16*>(wo),
                                         static_cast<int8_t*>(wo8r), static_cast<float*>(swor),
                                         hhd, d, st);
  if (e != cudaSuccess) return e;

  // recompute LN1 (+ codes), qkv (s8) and the attention core (K13's forward)
  const auto* g32 = static_cast<const float*>(gamma);
  const auto* be32 = static_cast<const float*>(beta);
  e = int8_dw ? vitax::launch_layer_norm_quant<false, true, L>(xb, g32, be32, xqi, sxf, xn, n, d,
                                                               eps, st)
              : vitax::launch_layer_norm_quant<false, false, L>(xb, g32, be32, xqi, sxf, xn, n, d,
                                                                eps, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_s8<sm90::kEpiS8Bf16>(xqi, static_cast<const int8_t*>(w8t), sxf,
                                      static_cast<const float*>(sw),
                                      static_cast<const float*>(bqkv), qkvb, nullptr, n, w, d, st);
  if (e != cudaSuccess) return e;
  vitax::k13::CoreArgs a{};
  a.q = qkvb, a.k = qkvb + hhd, a.v = qkvb + hhd + kvw;
  a.o = attnb, a.out = attnb, a.dout = dattnb;
  a.dq = dqkvb, a.dk = dqkvb + hhd, a.dv = dqkvb + hhd + kvw;
  a.stats = static_cast<float*>(stats);
  a.seq = seq_len, a.rows = a.kv_rows = spq, a.img_rows = a.kv_img_rows = spq, a.heads = heads;
  a.kv_heads = kv_heads;
  a.seq_pad = (spq + vitax::k13::kRows - 1) / vitax::k13::kRows * vitax::k13::kRows;
  a.scale = scale;
  a.ld_q = a.ld_k = a.ld_v = a.ld_dq = a.ld_dk = a.ld_dv = w;
  a.ld_o = a.ld_do = hhd;
  e = vitax::k13::launch_core_fwd(a, head_dim, b, st);
  if (e != cudaSuccess) return e;

  // out-projection grads: dattn in s8, dWo and dbo
  e = vitax::launch_quant_rows<L>(dob, doqi, sdof, n, d, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_s8<sm90::kEpiS8Bf16>(doqi, static_cast<const int8_t*>(wo8r), sdof,
                                      static_cast<const float*>(swor), nullptr, dattnb, nullptr,
                                      n, hhd, d, st);
  if (e != cudaSuccess) return e;
  const int gp = vitax::dw_group_pad(group);
  const int kp = vitax::dw_groups(n, group) * gp;
  if (!int8_dw) {
    e = sm90::gemm_tn(attnb, dob, static_cast<float*>(dwo), wsf, hhd, d, n, st);
  } else if (kCols) {  // fresh per-column packs of both operands
    e = vitax::launch_dw_cols_operands(attnb, dob, n, hhd, d, group, gp,
                                       static_cast<int8_t*>(atct), static_cast<float*>(sat),
                                       static_cast<int8_t*>(doqt), static_cast<float*>(sdoc), st);
    if (e == cudaSuccess)
      e = sm90::gemm_s8_groups_rc(static_cast<const int8_t*>(atct),
                                  static_cast<const int8_t*>(doqt), static_cast<const float*>(sat),
                                  static_cast<const float*>(sdoc), static_cast<float*>(dwo), hhd,
                                  d, kp, gp, st);
  } else {  // row-scale folding into the dx-path's int8 codes
    e = vitax::launch_dw_int8_operands(attnb, sdof, doqi, n, hhd, d, group, gp,
                                       static_cast<int8_t*>(atct), static_cast<float*>(sat),
                                       static_cast<int8_t*>(doqt), st);
    if (e == cudaSuccess)
      e = sm90::gemm_s8_groups(static_cast<const int8_t*>(atct), static_cast<const int8_t*>(doqt),
                               static_cast<const float*>(sat), static_cast<float*>(dwo), hhd, d,
                               kp, gp, st);
  }
  if (e != cudaSuccess) return e;
  e = vitax::launch_colsum(dob, static_cast<float*>(dbo), wsf, n, d, st);
  if (e != cudaSuccess) return e;

  // attention-core grads -> dqkv (K13's three passes)
  e = vitax::k13::launch_core_bwd(a, head_dim, b, st);
  if (e != cudaSuccess) return e;

  // QKV projection grads (dxn in s8) and the LN tail
  e = vitax::launch_quant_rows<L>(static_cast<const bf16*>(dqkvb), dqqi, sdqf, n, w, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_s8<sm90::kEpiS8F32>(dqqi, static_cast<const int8_t*>(w8r), sdqf,
                                     static_cast<const float*>(swr), nullptr, nullptr, dxnf, n, d,
                                     w, st);
  if (e != cudaSuccess) return e;
  if (!int8_dw) {
    e = sm90::gemm_tn(static_cast<const bf16*>(xn), dqkvb, static_cast<float*>(dwqkv), wsf, d, w,
                      n, st);
  } else if (kCols) {
    e = vitax::launch_dw_cols_operands(static_cast<const float*>(xn),
                                       static_cast<const bf16*>(dqkvb), n, d, w, group, gp,
                                       static_cast<int8_t*>(xnct), static_cast<float*>(sxn),
                                       static_cast<int8_t*>(dqqt), static_cast<float*>(sdqc), st);
    if (e == cudaSuccess)
      e = sm90::gemm_s8_groups_rc(static_cast<const int8_t*>(xnct),
                                  static_cast<const int8_t*>(dqqt), static_cast<const float*>(sxn),
                                  static_cast<const float*>(sdqc), static_cast<float*>(dwqkv), d, w,
                                  kp, gp, st);
  } else {
    e = vitax::launch_dw_int8_operands(static_cast<const float*>(xn), sdqf, dqqi, n, d, w, group,
                                       gp, static_cast<int8_t*>(xnct), static_cast<float*>(sxn),
                                       static_cast<int8_t*>(dqqt), st);
    if (e == cudaSuccess)
      e = sm90::gemm_s8_groups(static_cast<const int8_t*>(xnct), static_cast<const int8_t*>(dqqt),
                               static_cast<const float*>(sxn), static_cast<float*>(dwqkv), d, w,
                               kp, gp, st);
  }
  if (e != cudaSuccess) return e;
  e = vitax::launch_colsum(static_cast<const bf16*>(dqkvb), static_cast<float*>(dbqkv), wsf, n,
                           w, st);
  if (e != cudaSuccess) return e;
  return vitax::launch_layer_norm_bwd<bf16, float>(
      xb, static_cast<const float*>(gamma), dxnf, nullptr, static_cast<bf16*>(dx),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), wsf, n, d, eps, st);
}

}  // namespace

// Inputs x, dout bf16 [n, d], gamma, beta fp32 [d], bqkv [w], wqkv bf16
// [d, w], wo bf16 [hhd, d], w = (heads + 2 kv_heads) head_dim. Outputs dx
// (bf16 [n, d]) and fp32 dgamma, dbeta [d], dwqkv [d, w], dbqkv [w], dwo
// [hhd, d], dbo [d]. Scratch (bf16 unless noted): w8t int8 [w, d], sw fp32
// [w], w8r int8 [d, w], swr fp32 [d], wo8r int8 [hhd, d], swor fp32 [hhd],
// xn [n,d], xq int8 [n,d], sx fp32 [n], qkv [n,w], attn [n,hhd], doq int8
// [n,d], sdo fp32 [n], dattn [n,hhd], dqkv [n,w], dqq int8 [n,w], sdq fp32
// [n], dxn fp32 [n,d], ws fp32 vitax_ln_qkvo_attention_bwd_ws(n, d, hhd, w);
// stats fp32 vitax_attention_core_bwd_ws(b, spq, heads) (heads a multiple
// of kv_heads); with int8_dw (else null; xn is then fp32 [n, d]), kp =
// groups * round_up(group, 128):
// atct int8 [hhd, kp], sat fp32 [groups, hhd], doqt int8 [d, kp], xnct int8
// [d, kp], sxn fp32 [groups, d], dqqt int8 [w, kp].
extern "C" int vitax_ln_qkvo_attention_int8_bwd(
    const void* x, const void* gamma, const void* beta, const void* bqkv, const void* wqkv,
    const void* wo, const void* dout, void* dx, void* dgamma, void* dbeta, void* dwqkv,
    void* dbqkv, void* dwo, void* dbo, void* w8t, void* sw, void* w8r, void* swr, void* wo8r,
    void* swor, void* xn, void* xq, void* sx, void* qkv, void* attn, void* doq, void* sdo,
    void* dattn, void* stats, void* dqkv, void* dqq, void* sdq, void* dxn, void* ws, void* atct,
    void* sat, void* doqt, void* xnct, void* sxn, void* dqqt, int b, int spq, int d, int seq_len,
    int heads, int kv_heads, int head_dim, int group, int int8_dw, float eps, float scale,
    void* stream) {
  if (kv_heads <= 0 || heads % kv_heads) return cudaErrorInvalidValue;
  return ln_qkvo_attention_quant_bwd_sm90<vitax::kQ8>(
      x, gamma, beta, bqkv, wqkv, wo, dout, dx, dgamma, dbeta, dwqkv, dbqkv, dwo, dbo, w8t, sw,
      w8r, swr, wo8r, swor, xn, xq, sx, qkv, attn, doq, sdo, dattn, stats, dqkv, dqq, sdq, dxn,
      ws, atct, sat, doqt, nullptr, xnct, sxn, dqqt, nullptr, b, spq, d, seq_len, heads,
      kv_heads, head_dim, group, int8_dw, eps, scale, static_cast<cudaStream_t>(stream));
}

// K11-D and G-B: K3's arguments on the int4 grid; with int8_dw (else null)
// the fresh column packs of both operands of each weight grad, each group's
// rows padded to 128 (kp as K3's): atct int8 [hhd, kp] and sat [groups,
// hhd], doqt int8 [d, kp] and sdoc [groups, d] (dWo); xnct int8 [d, kp] and
// sxn [groups, d], dqqt int8 [w, kp] and sdqc [groups, w] (dW).
extern "C" int vitax_ln_qkvo_attention_int4_bwd(
    const void* x, const void* gamma, const void* beta, const void* bqkv, const void* wqkv,
    const void* wo, const void* dout, void* dx, void* dgamma, void* dbeta, void* dwqkv,
    void* dbqkv, void* dwo, void* dbo, void* w8t, void* sw, void* w8r, void* swr, void* wo8r,
    void* swor, void* xn, void* xq, void* sx, void* qkv, void* attn, void* doq, void* sdo,
    void* dattn, void* stats, void* dqkv, void* dqq, void* sdq, void* dxn, void* ws, void* atct,
    void* sat, void* doqt, void* sdoc, void* xnct, void* sxn, void* dqqt, void* sdqc, int b,
    int spq, int d, int seq_len, int heads, int kv_heads, int head_dim, int group, int int8_dw,
    float eps, float scale, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads) return cudaErrorInvalidValue;
  return ln_qkvo_attention_quant_bwd_sm90<vitax::kQ4>(
      x, gamma, beta, bqkv, wqkv, wo, dout, dx, dgamma, dbeta, dwqkv, dbqkv, dwo, dbo, w8t, sw,
      w8r, swr, wo8r, swor, xn, xq, sx, qkv, attn, doq, sdo, dattn, stats, dqkv, dqq, sdq, dxn,
      ws, atct, sat, doqt, sdoc, xnct, sxn, dqqt, sdqc, b, spq, d, seq_len, heads, kv_heads,
      head_dim, group, int8_dw, eps, scale, static_cast<cudaStream_t>(stream));
}
