// K8 backward under int8_grad, the rect fused attention half: replaces
// _ln_qkvo_rect_bwd_int8_kernel (vitax/ops/pallas_kernels.py:4253), the int8
// branch of _fused_ln_qkvo_rect_bwd (:4491, pallas_call at :4534), with
// int8_dw off or on. K3's SwitchBack split (ln_qkvo_
// attention_int8_bwd.cu) on K8's two row sets, in the order of the Pallas
// body (:4273-4385):
//
//   recompute: xnc32 = LN(xc), xn32 = LN(x); xqc, sxc = quant_rows(xnc32),
//              xq, sx = quant_rows(xn32)
//              q = bf16(f32(xqc Wq8) sxc swq + bq), kv = bf16(f32(xq Wkv8) sx swkv + bkv)
//              attn: K8's core, bf16 (the backward's recompute rounds it)
//   doq, sdo = quant_rows(do); dattn = bf16(f32(doq Wor^T) sdo swor)
//   dq, dkv: the bf16 rect core grads (attention_bwd.cuh, rect geometry)
//   dqq, sdq = quant_rows(dq);    dxnc = f32(dqq Wqr^T) sdq swqr
//   dkvq, sdkv = quant_rows(dkv); dxn  = f32(dkvq Wkvr^T) sdkv swkvr
//   dxc, dx, dγ, dβ: the two LN backwards, as the bf16 tier
//   dWo, dWq, dWkv: bf16 products (attn^T do, bf16(xnc32)^T dq,
//   bf16(xn32)^T dkv), or with int8_dw the per-group int8 products with
//   row-scale folding (dw_int8.cuh):
//     dWo  = Σ_z f32(quant_cols(attn_z sdo_z)^T doq_z) sat_z      groups of group_c rows
//     dWq  = Σ_z f32(quant_cols(xnc32_z sdq_z)^T dqq_z) sxnc_z    groups of group_c rows
//     dWkv = Σ_z f32(quant_cols(xn32_z sdkv_z)^T dkvq_z) sxn_z    groups of group_k rows
//   dbq = Σ f32(dq), dbkv = Σ f32(dkv), dbo = Σ do
//
// The weights' codes: Wq8/Wkv8 per output column, the forward's (Wqkv
// quantized whole, written [3hhd, d]; a column's code does not depend on
// the others); Wqr, Wkvr and Wor per row over their own columns
// (_quant_rows_host of the slices Wq [d, hhd] and Wkv [d, 2hhd], read in place
// by row stride, so their row scales are those of the slices, not of Wqkv's
// whole rows). The int8_dw groups are vitax's grid step: tile images of
// _qkvo_bwd_tile(b, spq) (:3223), so tile·cpq rows on the Q side and for dWo,
// tile·spq rows on the KV side; the wrapper passes both.
//
// Bound on the H100: the s8 projections (four, and three more under
// int8_dw) and two bf16 kTN products on the tensor cores, and the core's
// recompute and backward.
//
// The Hopper design: K3's backward sequence (ln_qkvo_attention_int8_bwd.cu)
// on K8's two row sets, after the weights' codes (quant.cuh):
//   1. the LN-quant recompute of xc and of x (layernorm.cuh, the row in
//      registers): xqc, sxc, xq, sx and xnc, xn (bf16, or fp32 under
//      int8_dw);
//   2. q and kv on gemm_sm90.cuh's s8 wgmma path (kEpiS8Bf16 + bias);
//   3. K13's forward core (attention_core.cuh) in its rect geometry (the
//      cpq query rows of q against the spq key rows of kv), attn in bf16 as
//      vitax's recompute rounds it;
//   4. doq, sdo; dattn = bf16(f32(doq·Wo8rᵀ)·sdo·swor) on the s8 path;
//   5. dWo: gemm_sm90.cuh's kTN or, under int8_dw, dw_int8.cuh's operand
//      packs over group_c rows (each group's rows padded to the 128-code K
//      tile) and the s8 path's group fold (kEpiS8Group); dbo a column sum;
//   6. the core grads through K13's three passes in the rect geometry: the
//      row pass over the cpq query rows (m·scale·log2e, 1/l and dd from the
//      bf16 attn into the stats scratch), the key pass over the spq key rows
//      (dk, dv into kv's packed columns of dkv, 0 on the keys >= seq_len),
//      the query pass (dq): neither P nor ds reaches device memory (the
//      first design kept 2·B·H·cpq·spq bf16 of them, 61 MB at b192 cpq 64
//      spq 104);
//   7. dqq, sdq, then dxnc on the s8 path (kEpiS8F32); dkvq, sdkv, then dxn;
//   8. dWq over group_c rows and dWkv over group_k (kTN, or the group folds
//      from the fp32 xnc and xn); dbq, dbkv column sums;
//   9. the two LN backwards (launch_layer_norm_bwd_two).
// xc's zero pad rows [cap, cpq) are query rows like any other: vitax
// computes them, and their dO (zero as the caller cuts it, but whatever it
// is) enters dk, dv, dWq, dWo and dbq. The core grads are K3's backward's,
// so they move from the first design within the int8 band. No float
// atomics: two runs give the same bits.
//
// R-B, the int4_grad branch (vitax_ln_qkvo_attention_rect_int4_bwd): the
// same Pallas body with _qr = _quant_rows4 (:4272) and the int4 weight
// forms the caller passes (_quant_cols_host4 of Wq and Wkv for the
// recompute, _quant_rows_host4 of Wq, Wkv and Wo for the dx-path,
// :4523-4529): every quantizer of the recompute and the dx-path (dattn,
// dxnc, dxn) on the int4 grid (limit 7, quant.cuh), the core grads bf16. It
// runs the Hopper sequence above at L = 7: the weights' codes, the LN-quant
// recompute of xc and x and the row codes of do, dq and dkv on the int4
// grid, codes in int8 on the same s8 products (no int4 tensor rate on the
// H100), K13's forward recompute and three passes in the rect geometry.
// Under int8_dw (R-B dw) the three weight grads are products of int8 codes
// packed fresh per column over each group, both operands, with no row-scale
// folding (:4310-4315, :4352-4362):
//   dWo  = Σ_z f32(quant_cols(attn_z)^T quant_cols(do_z)) sat_z sdo_z      group_c rows
//   dWq  = Σ_z f32(quant_cols(xnc32_z)^T quant_cols(dq_z)) sxnc_z sdq_z    group_c rows
//   dWkv = Σ_z f32(quant_cols(xn32_z)^T quant_cols(dkv_z)) sxn_z sdkv_z    group_k rows
// over the int8 tier's groups: dw_int8.cuh's column packs of both operands
// (each group's rows padded to the 128-code K tile), then the s8 path's
// two-scale group fold (kEpiS8GroupRC), in vitax's order. The pad rows of
// xc and x (zero rows, whose LN output is beta) enter the column scales as
// in vitax; nothing masks them.
#include "dw_int8.cuh"
#include "gemm_sm90.cuh"
#include "layernorm.cuh"

namespace {

// The Hopper design on the grid of limit L: K8's int8 tier (L = 127) and
// R-B (L = 7). sdoc, sdqc and sdkvc, the column scales of do, dq and dkv,
// are R-B dw's (null at L = 127, whose folds reuse their row codes).
template <int L>
int ln_qkvo_attention_rect_quant_bwd_sm90(
    const void* xc, const void* x, const void* gamma, const void* beta, const void* bqkv,
    const void* wqkv, const void* wo, const void* dout, void* dxc, void* dx, void* dgamma,
    void* dbeta, void* dwq, void* dwkv, void* dbq, void* dbkv, void* dwo, void* dbo, void* w8t,
    void* sw, void* wq8r, void* swqr, void* wkv8r, void* swkvr, void* wo8r, void* swor,
    void* xnc, void* xqc, void* sxc, void* xn, void* xq, void* sx, void* q, void* kv, void* attn,
    void* doq, void* sdo, void* dattn, void* stats, void* dq, void* dkv, void* dqq, void* sdq,
    void* dkvq, void* sdkv, void* dxnc, void* dxn, void* g2, void* b2, void* ws, void* atct,
    void* sat, void* doqt, void* sdoc, void* xnct, void* sxnc, void* dqqt, void* sdqc,
    void* xnkt, void* sxnk, void* dkvqt, void* sdkvc, int b, int cpq, int spq, int d,
    int seq_len, int heads, int head_dim, int group_c, int group_k, int int8_dw, float eps,
    float scale, cudaStream_t st) {
  using vitax::bf16;
  namespace sm90 = vitax::sm90;
  constexpr bool kCols = L == vitax::kQ4;  // int8_dw on fresh column packs
  const int nc = b * cpq;
  const int n = b * spq;
  const int hhd = heads * head_dim;
  if (nc == 0 || n == 0 || b > 65535 || seq_len <= 0 || seq_len > spq)
    return cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  const auto* bias = static_cast<const float*>(bqkv);
  const auto* wqkvb = static_cast<const bf16*>(wqkv);
  const auto* dob = static_cast<const bf16*>(dout);
  auto* w8 = static_cast<int8_t*>(w8t);
  auto* swf = static_cast<float*>(sw);
  auto* xqci = static_cast<int8_t*>(xqc);
  auto* sxcf = static_cast<float*>(sxc);
  auto* xqi = static_cast<int8_t*>(xq);
  auto* sxf = static_cast<float*>(sx);
  auto* qb = static_cast<bf16*>(q);
  auto* kvb = static_cast<bf16*>(kv);
  auto* attnb = static_cast<bf16*>(attn);
  auto* doqi = static_cast<int8_t*>(doq);
  auto* sdof = static_cast<float*>(sdo);
  auto* dattnb = static_cast<bf16*>(dattn);
  auto* dqb = static_cast<bf16*>(dq);
  auto* dkvb = static_cast<bf16*>(dkv);
  auto* dqqi = static_cast<int8_t*>(dqq);
  auto* sdqf = static_cast<float*>(sdq);
  auto* dkvqi = static_cast<int8_t*>(dkvq);
  auto* sdkvf = static_cast<float*>(sdkv);
  auto* dxncf = static_cast<float*>(dxnc);
  auto* dxnf = static_cast<float*>(dxn);
  auto* wsf = static_cast<float*>(ws);

  // the weights' codes
  cudaError_t e = vitax::launch_quant_weight_cols_t<L>(wqkvb, w8, swf, d, 3 * hhd, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_weight_rows<L>(wqkvb, static_cast<int8_t*>(wq8r),
                                         static_cast<float*>(swqr), d, hhd, st, 3 * hhd);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_weight_rows<L>(wqkvb + hhd, static_cast<int8_t*>(wkv8r),
                                         static_cast<float*>(swkvr), d, 2 * hhd, st, 3 * hhd);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_weight_rows<L>(static_cast<const bf16*>(wo),
                                         static_cast<int8_t*>(wo8r), static_cast<float*>(swor),
                                         hhd, d, st);
  if (e != cudaSuccess) return e;

  // recompute both LNs (+ codes; xnc and xn for the weight grads, fp32 under
  // int8_dw), q and kv (s8) and the core (K13's forward, rect geometry)
  const auto* xcb = static_cast<const bf16*>(xc);
  const auto* xb = static_cast<const bf16*>(x);
  e = int8_dw ? vitax::launch_layer_norm_quant<false, true, L>(xcb, g, be, xqci, sxcf, xnc, nc, d,
                                                               eps, st)
              : vitax::launch_layer_norm_quant<false, false, L>(xcb, g, be, xqci, sxcf, xnc, nc,
                                                                d, eps, st);
  if (e != cudaSuccess) return e;
  e = int8_dw ? vitax::launch_layer_norm_quant<false, true, L>(xb, g, be, xqi, sxf, xn, n, d, eps,
                                                               st)
              : vitax::launch_layer_norm_quant<false, false, L>(xb, g, be, xqi, sxf, xn, n, d,
                                                                eps, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_s8<sm90::kEpiS8Bf16>(xqci, w8, sxcf, swf, bias, qb, nullptr, nc, hhd, d, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_s8<sm90::kEpiS8Bf16>(xqi, w8 + static_cast<size_t>(hhd) * d, sxf, swf + hhd,
                                      bias + hhd, kvb, nullptr, n, 2 * hhd, d, st);
  if (e != cudaSuccess) return e;
  vitax::k13::CoreArgs a{};
  a.q = qb, a.k = kvb, a.v = kvb + hhd;
  a.o = attnb, a.out = attnb, a.dout = dattnb;
  a.dq = dqb, a.dk = dkvb, a.dv = dkvb + hhd;
  a.stats = static_cast<float*>(stats);
  a.seq = seq_len, a.rows = a.img_rows = cpq, a.kv_rows = a.kv_img_rows = spq, a.heads = heads;
  a.kv_heads = heads;
  a.seq_pad = (cpq + vitax::k13::kRows - 1) / vitax::k13::kRows * vitax::k13::kRows;
  a.scale = scale;
  a.ld_q = a.ld_o = a.ld_do = a.ld_dq = hhd;
  a.ld_k = a.ld_v = a.ld_dk = a.ld_dv = 2 * hhd;
  e = vitax::k13::launch_core_fwd(a, head_dim, b, st);
  if (e != cudaSuccess) return e;

  // out-projection grads: dattn in s8, dWo and dbo over the bf16 do
  e = vitax::launch_quant_rows<L>(dob, doqi, sdof, nc, d, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_s8<sm90::kEpiS8Bf16>(doqi, static_cast<const int8_t*>(wo8r), sdof,
                                      static_cast<const float*>(swor), nullptr, dattnb, nullptr,
                                      nc, hhd, d, st);
  if (e != cudaSuccess) return e;
  const int gpc = vitax::dw_group_pad(group_c);
  const int gpk = vitax::dw_group_pad(group_k);
  const int kpc = vitax::dw_groups(nc, group_c) * gpc;
  const int kpk = vitax::dw_groups(n, group_k) * gpk;
  if (!int8_dw) {
    e = sm90::gemm_tn(attnb, dob, static_cast<float*>(dwo), wsf, hhd, d, nc, st);
  } else if (kCols) {  // fresh per-column packs of both operands
    e = vitax::launch_dw_cols_operands(attnb, dob, nc, hhd, d, group_c, gpc,
                                       static_cast<int8_t*>(atct), static_cast<float*>(sat),
                                       static_cast<int8_t*>(doqt), static_cast<float*>(sdoc), st);
    if (e == cudaSuccess)
      e = sm90::gemm_s8_groups_rc(static_cast<const int8_t*>(atct),
                                  static_cast<const int8_t*>(doqt), static_cast<const float*>(sat),
                                  static_cast<const float*>(sdoc), static_cast<float*>(dwo), hhd,
                                  d, kpc, gpc, st);
  } else {  // row-scale folding into the dx-path's int8 codes
    e = vitax::launch_dw_int8_operands(attnb, sdof, doqi, nc, hhd, d, group_c, gpc,
                                       static_cast<int8_t*>(atct), static_cast<float*>(sat),
                                       static_cast<int8_t*>(doqt), st);
    if (e == cudaSuccess)
      e = sm90::gemm_s8_groups(static_cast<const int8_t*>(atct), static_cast<const int8_t*>(doqt),
                               static_cast<const float*>(sat), static_cast<float*>(dwo), hhd, d,
                               kpc, gpc, st);
  }
  if (e != cudaSuccess) return e;
  e = vitax::launch_colsum(dob, static_cast<float*>(dbo), wsf, nc, d, st);
  if (e != cudaSuccess) return e;

  // the core grads: dq on the xc rows, dk and dv on the x rows (K13's passes)
  e = vitax::k13::launch_core_bwd(a, head_dim, b, st);
  if (e != cudaSuccess) return e;

  // projection grads of the two row sets (dxn in s8) and the two LN tails
  e = vitax::launch_quant_rows<L>(static_cast<const bf16*>(dqb), dqqi, sdqf, nc, hhd, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_s8<sm90::kEpiS8F32>(dqqi, static_cast<const int8_t*>(wq8r), sdqf,
                                     static_cast<const float*>(swqr), nullptr, nullptr, dxncf, nc,
                                     d, hhd, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_rows<L>(static_cast<const bf16*>(dkvb), dkvqi, sdkvf, n, 2 * hhd, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_s8<sm90::kEpiS8F32>(dkvqi, static_cast<const int8_t*>(wkv8r), sdkvf,
                                     static_cast<const float*>(swkvr), nullptr, nullptr, dxnf, n,
                                     d, 2 * hhd, st);
  if (e != cudaSuccess) return e;
  if (!int8_dw) {
    e = sm90::gemm_tn(static_cast<const bf16*>(xnc), dqb, static_cast<float*>(dwq), wsf, d, hhd,
                      nc, st);
    if (e != cudaSuccess) return e;
    e = sm90::gemm_tn(static_cast<const bf16*>(xn), dkvb, static_cast<float*>(dwkv), wsf, d,
                      2 * hhd, n, st);
  } else if (kCols) {
    e = vitax::launch_dw_cols_operands(static_cast<const float*>(xnc),
                                       static_cast<const bf16*>(dqb), nc, d, hhd, group_c, gpc,
                                       static_cast<int8_t*>(xnct), static_cast<float*>(sxnc),
                                       static_cast<int8_t*>(dqqt), static_cast<float*>(sdqc), st);
    if (e != cudaSuccess) return e;
    e = sm90::gemm_s8_groups_rc(static_cast<const int8_t*>(xnct), static_cast<const int8_t*>(dqqt),
                                static_cast<const float*>(sxnc), static_cast<const float*>(sdqc),
                                static_cast<float*>(dwq), d, hhd, kpc, gpc, st);
    if (e != cudaSuccess) return e;
    e = vitax::launch_dw_cols_operands(static_cast<const float*>(xn),
                                       static_cast<const bf16*>(dkvb), n, d, 2 * hhd, group_k, gpk,
                                       static_cast<int8_t*>(xnkt), static_cast<float*>(sxnk),
                                       static_cast<int8_t*>(dkvqt), static_cast<float*>(sdkvc),
                                       st);
    if (e != cudaSuccess) return e;
    e = sm90::gemm_s8_groups_rc(static_cast<const int8_t*>(xnkt),
                                static_cast<const int8_t*>(dkvqt), static_cast<const float*>(sxnk),
                                static_cast<const float*>(sdkvc), static_cast<float*>(dwkv), d,
                                2 * hhd, kpk, gpk, st);
  } else {
    e = vitax::launch_dw_int8_operands(static_cast<const float*>(xnc), sdqf, dqqi, nc, d, hhd,
                                       group_c, gpc, static_cast<int8_t*>(xnct),
                                       static_cast<float*>(sxnc), static_cast<int8_t*>(dqqt), st);
    if (e != cudaSuccess) return e;
    e = sm90::gemm_s8_groups(static_cast<const int8_t*>(xnct), static_cast<const int8_t*>(dqqt),
                             static_cast<const float*>(sxnc), static_cast<float*>(dwq), d, hhd,
                             kpc, gpc, st);
    if (e != cudaSuccess) return e;
    e = vitax::launch_dw_int8_operands(static_cast<const float*>(xn), sdkvf, dkvqi, n, d, 2 * hhd,
                                       group_k, gpk, static_cast<int8_t*>(xnkt),
                                       static_cast<float*>(sxnk), static_cast<int8_t*>(dkvqt), st);
    if (e != cudaSuccess) return e;
    e = sm90::gemm_s8_groups(static_cast<const int8_t*>(xnkt), static_cast<const int8_t*>(dkvqt),
                             static_cast<const float*>(sxnk), static_cast<float*>(dwkv), d,
                             2 * hhd, kpk, gpk, st);
  }
  if (e != cudaSuccess) return e;
  e = vitax::launch_colsum(static_cast<const bf16*>(dqb), static_cast<float*>(dbq), wsf, nc, hhd,
                           st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_colsum(static_cast<const bf16*>(dkvb), static_cast<float*>(dbkv), wsf, n,
                           2 * hhd, st);
  if (e != cudaSuccess) return e;
  return vitax::launch_layer_norm_bwd_two<bf16, float>(
      xcb, dxncf, static_cast<bf16*>(dxc), nc, xb, dxnf, static_cast<bf16*>(dx), n, g,
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), static_cast<float*>(g2),
      static_cast<float*>(b2), wsf, d, eps, st);
}

}  // namespace

// Inputs xc, dout bf16 [b·cpq, d], x bf16 [b·spq, d], gamma, beta fp32 [d],
// bqkv [3hhd], wqkv bf16 [d, 3hhd], wo bf16 [hhd, d]. Outputs as the bf16
// tier's. Scratch: w8t int8 [3hhd, d], sw [3hhd], wq8r int8 [d, hhd], swqr
// [d], wkv8r int8 [d, 2hhd], swkvr [d], wo8r int8 [hhd, d], swor [hhd]; xnc
// [b·cpq, d] and xn [b·spq, d] (bf16, or fp32 under int8_dw), xqc int8 and
// sxc, xq int8 and sx; q, kv, attn, dattn, dq, dkv bf16 as the bf16 tier's;
// doq int8 [b·cpq, d], sdo; stats fp32 vitax_attention_core_bwd_ws(b, cpq,
// heads) (K13's row statistics, padded from cpq); dqq int8 [b·cpq, hhd], sdq;
// dkvq int8 [b·spq, 2hhd], sdkv; dxnc, dxn fp32; g2, b2 fp32 [d]; ws fp32
// vitax_ln_qkvo_attention_rect_bwd_ws. With int8_dw (else null), kpc =
// groups·round_up(group_c, 128), kpk = groups·round_up(group_k, 128): atct
// int8 [hhd, kpc], sat [groups, hhd], doqt int8 [d, kpc], xnct int8 [d, kpc],
// sxnc [groups, d], dqqt int8 [hhd, kpc], xnkt int8 [d, kpk], sxnk [groups,
// d], dkvqt int8 [2hhd, kpk].
extern "C" int vitax_ln_qkvo_attention_rect_int8_bwd(
    const void* xc, const void* x, const void* gamma, const void* beta, const void* bqkv,
    const void* wqkv, const void* wo, const void* dout, void* dxc, void* dx, void* dgamma,
    void* dbeta, void* dwq, void* dwkv, void* dbq, void* dbkv, void* dwo, void* dbo, void* w8t,
    void* sw, void* wq8r, void* swqr, void* wkv8r, void* swkvr, void* wo8r, void* swor,
    void* xnc, void* xqc, void* sxc, void* xn, void* xq, void* sx, void* q, void* kv, void* attn,
    void* doq, void* sdo, void* dattn, void* stats, void* dq, void* dkv, void* dqq, void* sdq,
    void* dkvq, void* sdkv, void* dxnc, void* dxn, void* g2, void* b2, void* ws, void* atct,
    void* sat, void* doqt, void* xnct, void* sxnc, void* dqqt, void* xnkt, void* sxnk,
    void* dkvqt, int b, int cpq, int spq, int d, int seq_len, int heads, int head_dim,
    int group_c, int group_k, int int8_dw, float eps, float scale, void* stream) {
  return ln_qkvo_attention_rect_quant_bwd_sm90<vitax::kQ8>(
      xc, x, gamma, beta, bqkv, wqkv, wo, dout, dxc, dx, dgamma, dbeta, dwq, dwkv, dbq, dbkv, dwo,
      dbo, w8t, sw, wq8r, swqr, wkv8r, swkvr, wo8r, swor, xnc, xqc, sxc, xn, xq, sx, q, kv, attn,
      doq, sdo, dattn, stats, dq, dkv, dqq, sdq, dkvq, sdkv, dxnc, dxn, g2, b2, ws, atct, sat,
      doqt, nullptr, xnct, sxnc, dqqt, nullptr, xnkt, sxnk, dkvqt, nullptr, b, cpq, spq, d,
      seq_len, heads, head_dim, group_c, group_k, int8_dw, eps, scale,
      static_cast<cudaStream_t>(stream));
}

// R-B: the int8 tier's arguments on the int4 grid; with int8_dw (else null)
// the fresh column packs of both operands of each weight grad, each group's
// rows padded to 128 (kpc and kpk as the int8 tier's): atct and sat, doqt
// and sdoc [groups, d] (dWo); xnct and sxnc, dqqt and sdqc [groups, hhd]
// (dWq); xnkt and sxnk, dkvqt and sdkvc [groups, 2hhd] (dWkv).
extern "C" int vitax_ln_qkvo_attention_rect_int4_bwd(
    const void* xc, const void* x, const void* gamma, const void* beta, const void* bqkv,
    const void* wqkv, const void* wo, const void* dout, void* dxc, void* dx, void* dgamma,
    void* dbeta, void* dwq, void* dwkv, void* dbq, void* dbkv, void* dwo, void* dbo, void* w8t,
    void* sw, void* wq8r, void* swqr, void* wkv8r, void* swkvr, void* wo8r, void* swor,
    void* xnc, void* xqc, void* sxc, void* xn, void* xq, void* sx, void* q, void* kv, void* attn,
    void* doq, void* sdo, void* dattn, void* stats, void* dq, void* dkv, void* dqq, void* sdq,
    void* dkvq, void* sdkv, void* dxnc, void* dxn, void* g2, void* b2, void* ws, void* atct,
    void* sat, void* doqt, void* sdoc, void* xnct, void* sxnc, void* dqqt, void* sdqc,
    void* xnkt, void* sxnk, void* dkvqt, void* sdkvc, int b, int cpq, int spq, int d,
    int seq_len, int heads, int head_dim, int group_c, int group_k, int int8_dw, float eps,
    float scale, void* stream) {
  return ln_qkvo_attention_rect_quant_bwd_sm90<vitax::kQ4>(
      xc, x, gamma, beta, bqkv, wqkv, wo, dout, dxc, dx, dgamma, dbeta, dwq, dwkv, dbq, dbkv, dwo,
      dbo, w8t, sw, wq8r, swqr, wkv8r, swkvr, wo8r, swor, xnc, xqc, sxc, xn, xq, sx, q, kv, attn,
      doq, sdo, dattn, stats, dq, dkv, dqq, sdq, dkvq, sdkv, dxnc, dxn, g2, b2, ws, atct, sat,
      doqt, sdoc, xnct, sxnc, dqqt, sdqc, xnkt, sxnk, dkvqt, sdkvc, b, cpq, spq, d, seq_len,
      heads, head_dim, group_c, group_k, int8_dw, eps, scale, static_cast<cudaStream_t>(stream));
}
