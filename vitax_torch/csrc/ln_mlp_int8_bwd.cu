// K4 backward under int8_grad, the fused LN-MLP half: replaces
// _ln_mlp_bwd_int8_kernel (vitax/ops/pallas_kernels.py:1122), reached
// through _ln_mlp_2d_int8g_bwd (:1859) -> _ln_mlp_bwd_int8_call (pallas_call
// at :1820), with int8_dw off or on. In the order of the Pallas body
// (:1134-1224), the SwitchBack split (int8 dx-path, bf16 weight grads):
//
//   xn     = bf16(LN2(x)); xq, sxq = quant_rows(f32(xn))   from the bf16-
//            rounded xn (:1155; the forward quantizes the fp32 one)
//   a1     = f32(xq W1c) sxq s1c + b1                       fc1 recompute
//   doq, sdo = quant_rows(do)
//   dh1_32 = f32(doq W2r^T) sdo s2r * gelu_grad_q(a1); dh1 = bf16(dh1_32)
//   h1     = bf16(gelu_q(a1))
//   dW2 = h1^T do, db2 = Σ do;  dW1 = xn^T dh1, db1 = Σ dh1_32 (fp32)
//   dh1q, sd = quant_rows(dh1_32);  dxn = f32(dh1q W1r^T) sd s1r
//   LN tail: dx = do + bf16(dx_ln), dγ = Σ dxn x̂, dβ = Σ dxn
//
// With residual == 0 it is the kernel's `residual=False` branch (:1219, and
// K11-B's :1096), the MLP half per model shard under tensor parallelism: dx
// = bf16(dx_ln), no do +; every other output is the same bits.
//
// With int8_dw the two weight grads are the per-group int8 products with
// row-scale folding (:1173-1197; dw_int8.cuh), over groups of `group` rows
// (the wrapper's: 128, the last one ragged):
//   dW2 = Σ_z f32(quant_cols(h1_z sdo_z)^T doq_z) sh_z
//   dW1 = Σ_z f32(quant_cols(xn_z sd_z)^T dh1q_z) sxn_z
//
// The first launches quantize the weights (quant.cuh): W1c/s1c, W1 per
// output column, as [M, D]; W2r/s2r and W1r/s1r, W2 and W1 per row,
// contracted over their columns, as they are ([M, D], [D, M]).
// Weight and vector grads come out in fp32, as the TPU kernel's outputs.
//
// Bound on the H100: the five products (three s8, and two bf16 kTN or, with
// int8_dw, two s8) on the tensor cores: 2·N·D·M each, int8 at 1979 TOP/s
// and bf16 at 989 TFLOP/s. The Hopper design (vitax_ln_mlp_int8_bwd):
//   1. the LN-quant prologue (layernorm.cuh: the row in registers, the
//      resident grid, the next row's loads in flight) writes xq, sx and the
//      bf16 xn; doq, sdo are do's row codes;
//   2. the fc1 recompute and the dh1 product as one launch of
//      gemm_sm90.cuh's s8 wgmma path, the dual product (kEpiS8GeluPair): two
//      int32 accumulators over D for each [128, 128] tile of [N, M], whose
//      epilogue writes h1, dh1 and dh1_32; a1 never reaches device memory;
//   3. db2, db1: column sums (colsum.cuh); dh1q, sd: dh1_32's row codes;
//   4. dW2, dW1: gemm_sm90.cuh's kTN (split K, ordered second pass) or,
//      under int8_dw, dw_int8.cuh's operand packs (each group's rows padded
//      to the 128-code K tile) and the s8 path's group fold (kEpiS8Group);
//   5. dxn = dh1q·W1rᵀ on the s8 path (kEpiS8F32), then the LN tail.
// No float atomics: two runs give the same bits. The epilogues keep
// gemm.cuh's fp32 operations in its order (quant.cuh: no fast math), so
// every output keeps the first design's bits but the bf16 weight grads,
// whose fp32 sums are now taken over other tiles.
//
// K11-B, the A4W4 dx-path backward under int4_grad (vitax_ln_mlp_int4_bwd):
// replaces _ln_mlp_bwd_int4_kernel (:1003), reached through
// _ln_mlp_2d_int4_bwd (:1957) -> _ln_mlp_bwd_int4_call (pallas_call at
// :1914). Its body (:1017-1109) is K4's with every quantizer of the
// recompute and the dx-path on the int4 grid (_quant_rows4 of xn, do and
// dh1_32; _quant_rows_host4 / _quant_cols_host4 of W1 and W2: limit 7,
// quant.cuh). It runs the Hopper sequence above at L = 7, codes in int8 on
// the same s8 products (the H100 has no int4 tensor rate). The weight grads
// never go below 8 bits: bf16 products on kTN, or under int8_dw
// (:1057-1074) products of int8 codes packed fresh per column over each
// group of rows, both operands, with no row-scale folding (the dx-path
// codes are int4):
//   dW2 = Σ_z f32(quant_cols(h1_z)^T quant_cols(do_z)) sh_z sdo_z
//   dW1 = Σ_z f32(quant_cols(xn_z)^T quant_cols(dh1_32_z)) sxn_z sdh_z
// (dw_int8.cuh's column packs of both operands, each group's rows padded to
// the 128-code K tile, then the s8 path's two-scale group fold,
// kEpiS8GroupRC, in vitax's order; no bf16 dh1 is written). vitax's group
// is a grid step's row chunk, _ln_mlp_rows(npad) // _bwd_chunks (:1393,
// :1405) of the rows padded by _ln_mlp_pad (:1412); the pad rows' h1 and xn
// are not zero, so the wrapper pads the rows to a whole number of groups
// and passes vitax's group. Every output keeps the first design's bits (the
// zero-padded integer sums are exact, and the fold keeps gemm.cuh's
// kS8GroupF32RC order) but the bf16 weight grads.
#include "dw_int8.cuh"
#include "gemm_sm90.cuh"
#include "layernorm.cuh"

namespace {

// The Hopper design on the grid of limit L: K4 (L = 127) and K11-B (L = 7).
// sdoc and sdhc, do's and dh1_32's column scales, are K11-B's int8_dw's
// (null at L = 127, whose folds reuse their row codes).
template <int L>
int ln_mlp_quant_bwd_sm90(const void* x, const void* gamma, const void* beta, const void* b1,
                          const void* w1, const void* w2, const void* dout, void* dx,
                          void* dgamma, void* dbeta, void* dw1, void* db1, void* dw2, void* db2,
                          void* w1r, void* s1r, void* w2r, void* s2r, void* w1c, void* s1c,
                          void* xn, void* xq, void* sx, void* h1, void* doq, void* sdo,
                          void* dh1f, void* dh1, void* dh1q, void* sdh, void* dxn, void* ws,
                          void* h1ct, void* sh, void* doqt, void* sdoc, void* xnct, void* sxn,
                          void* dh1qt, void* sdhc, int n, int d, int m, int group, int int8_dw,
                          float eps, int residual, cudaStream_t st) {
  using vitax::bf16;
  namespace sm90 = vitax::sm90;
  constexpr bool kCols = L == vitax::kQ4;  // int8_dw on fresh column packs
  const auto* w1b = static_cast<const bf16*>(w1);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* dob = static_cast<const bf16*>(dout);
  const auto* w1ri = static_cast<const int8_t*>(w1r);
  const auto* w2ri = static_cast<const int8_t*>(w2r);
  const auto* w1ci = static_cast<const int8_t*>(w1c);
  auto* xnb = static_cast<bf16*>(xn);
  auto* xqi = static_cast<int8_t*>(xq);
  auto* sxf = static_cast<float*>(sx);
  auto* h1b = static_cast<bf16*>(h1);
  auto* doqi = static_cast<int8_t*>(doq);
  auto* sdof = static_cast<float*>(sdo);
  auto* dh1ff = static_cast<float*>(dh1f);
  auto* dh1b = static_cast<bf16*>(dh1);
  auto* dh1qi = static_cast<int8_t*>(dh1q);
  auto* sdhf = static_cast<float*>(sdh);
  auto* dxnf = static_cast<float*>(dxn);
  auto* wsf = static_cast<float*>(ws);

  cudaError_t e = vitax::launch_quant_weight_rows<L>(w1b, static_cast<int8_t*>(w1r),
                                                     static_cast<float*>(s1r), d, m, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_weight_rows<L>(static_cast<const bf16*>(w2), static_cast<int8_t*>(w2r),
                                         static_cast<float*>(s2r), m, d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_weight_cols_t<L>(w1b, static_cast<int8_t*>(w1c),
                                           static_cast<float*>(s1c), d, m, st);
  if (e != cudaSuccess) return e;

  // the LN-quant recompute, do's row codes, then fc1's recompute and dh1 as
  // one dual s8 product
  e = vitax::launch_layer_norm_quant<true, false, L>(xb, static_cast<const float*>(gamma),
                                                     static_cast<const float*>(beta), xqi, sxf,
                                                     xnb, n, d, eps, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_rows<L>(dob, doqi, sdof, n, d, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_s8_gelu_pair(xqi, w1ci, sxf, static_cast<const float*>(s1c),
                              static_cast<const float*>(b1), doqi, w2ri, sdof,
                              static_cast<const float*>(s2r), h1b, int8_dw ? nullptr : dh1b,
                              dh1ff, n, m, d, st);
  if (e != cudaSuccess) return e;

  // the vector grads and dh1_32's row codes
  e = vitax::launch_colsum(dob, static_cast<float*>(db2), wsf, n, d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_colsum(static_cast<const float*>(dh1ff), static_cast<float*>(db1), wsf, n, m,
                           st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_rows<L>(static_cast<const float*>(dh1ff), dh1qi, sdhf, n, m, st);
  if (e != cudaSuccess) return e;

  // the weight grads
  const int gp = vitax::dw_group_pad(group);
  const int kp = vitax::dw_groups(n, group) * gp;
  if (!int8_dw) {
    e = sm90::gemm_tn(h1b, dob, static_cast<float*>(dw2), wsf, m, d, n, st);
    if (e != cudaSuccess) return e;
    e = sm90::gemm_tn(xnb, dh1b, static_cast<float*>(dw1), wsf, d, m, n, st);
  } else if (kCols) {  // fresh per-column packs of both operands
    e = vitax::launch_dw_cols_operands(h1b, dob, n, m, d, group, gp, static_cast<int8_t*>(h1ct),
                                       static_cast<float*>(sh), static_cast<int8_t*>(doqt),
                                       static_cast<float*>(sdoc), st);
    if (e != cudaSuccess) return e;
    e = sm90::gemm_s8_groups_rc(static_cast<const int8_t*>(h1ct), static_cast<const int8_t*>(doqt),
                                static_cast<const float*>(sh), static_cast<const float*>(sdoc),
                                static_cast<float*>(dw2), m, d, kp, gp, st);
    if (e != cudaSuccess) return e;
    e = vitax::launch_dw_cols_operands(xnb, static_cast<const float*>(dh1ff), n, d, m, group, gp,
                                       static_cast<int8_t*>(xnct), static_cast<float*>(sxn),
                                       static_cast<int8_t*>(dh1qt), static_cast<float*>(sdhc), st);
    if (e != cudaSuccess) return e;
    e = sm90::gemm_s8_groups_rc(static_cast<const int8_t*>(xnct),
                                static_cast<const int8_t*>(dh1qt), static_cast<const float*>(sxn),
                                static_cast<const float*>(sdhc), static_cast<float*>(dw1), d, m,
                                kp, gp, st);
  } else {  // row-scale folding into the dx-path's int8 codes
    e = vitax::launch_dw_int8_operands(h1b, sdof, doqi, n, m, d, group, gp,
                                       static_cast<int8_t*>(h1ct), static_cast<float*>(sh),
                                       static_cast<int8_t*>(doqt), st);
    if (e != cudaSuccess) return e;
    e = sm90::gemm_s8_groups(static_cast<const int8_t*>(h1ct), static_cast<const int8_t*>(doqt),
                             static_cast<const float*>(sh), static_cast<float*>(dw2), m, d, kp,
                             gp, st);
    if (e != cudaSuccess) return e;
    e = vitax::launch_dw_int8_operands(xnb, sdhf, dh1qi, n, d, m, group, gp,
                                       static_cast<int8_t*>(xnct), static_cast<float*>(sxn),
                                       static_cast<int8_t*>(dh1qt), st);
    if (e != cudaSuccess) return e;
    e = sm90::gemm_s8_groups(static_cast<const int8_t*>(xnct), static_cast<const int8_t*>(dh1qt),
                             static_cast<const float*>(sxn), static_cast<float*>(dw1), d, m, kp,
                             gp, st);
  }
  if (e != cudaSuccess) return e;

  // dxn on the s8 path and the LN tail
  e = sm90::gemm_s8<sm90::kEpiS8F32>(dh1qi, w1ri, sdhf, static_cast<const float*>(s1r), nullptr,
                                     nullptr, dxnf, n, d, m, st);
  if (e != cudaSuccess) return e;
  return vitax::launch_layer_norm_bwd<bf16, float>(
      xb, static_cast<const float*>(gamma), dxnf, residual ? dob : nullptr,
      static_cast<bf16*>(dx), static_cast<float*>(dgamma), static_cast<float*>(dbeta), wsf, n, d,
      eps, st);
}

}  // namespace

// Inputs x, dout bf16 [n, d], gamma, beta fp32 [d], b1 [m], w1 bf16 [d, m],
// w2 bf16 [m, d]. Outputs dx (bf16 [n, d]) and fp32 dgamma, dbeta [d], dw1
// [d, m], db1 [m], dw2 [m, d], db2 [d]. Scratch: w1r int8 [d, m], s1r [d],
// w2r int8 [m, d], s2r [m], w1c int8 [m, d], s1c [m], xn bf16 [n,d], xq int8
// [n,d], sx [n], h1 bf16 [n,m], doq int8 [n,d], sdo [n], dh1f fp32 [n,m]
// (dh1_32), dh1 bf16 [n,m] (null under int8_dw: the bf16 dW1 alone reads
// it), dh1q int8 [n,m], sdh [n], dxn fp32 [n,d], ws fp32
// vitax_ln_mlp_bwd_ws(n, d, m); with int8_dw (else null), kp = groups *
// round_up(group, 128): h1ct int8 [m, kp], sh fp32 [groups, m], doqt int8
// [d, kp], xnct int8 [d, kp], sxn fp32 [groups, d], dh1qt int8 [m, kp].
// residual 0: dx = bf16(dx_ln), without do +. d % 16 == 0, m % 16 == 0.
extern "C" int vitax_ln_mlp_int8_bwd(
    const void* x, const void* gamma, const void* beta, const void* b1, const void* w1,
    const void* w2, const void* dout, void* dx, void* dgamma, void* dbeta, void* dw1, void* db1,
    void* dw2, void* db2, void* w1r, void* s1r, void* w2r, void* s2r, void* w1c, void* s1c,
    void* xn, void* xq, void* sx, void* h1, void* doq, void* sdo, void* dh1f, void* dh1,
    void* dh1q, void* sdh, void* dxn, void* ws, void* h1ct, void* sh, void* doqt, void* xnct,
    void* sxn, void* dh1qt, int n, int d, int m, int group, int int8_dw, float eps, int residual,
    void* stream) {
  return ln_mlp_quant_bwd_sm90<vitax::kQ8>(
      x, gamma, beta, b1, w1, w2, dout, dx, dgamma, dbeta, dw1, db1, dw2, db2, w1r, s1r, w2r, s2r,
      w1c, s1c, xn, xq, sx, h1, doq, sdo, dh1f, dh1, dh1q, sdh, dxn, ws, h1ct, sh, doqt, nullptr,
      xnct, sxn, dh1qt, nullptr, n, d, m, group, int8_dw, eps, residual,
      static_cast<cudaStream_t>(stream));
}

// K11-B: K4's arguments on the int4 grid; with int8_dw (else null) the
// fresh column packs of both operands of each weight grad, each group's rows
// padded to 128 (kp as K4's): h1ct int8 [m, kp] and sh [groups, m], doqt
// int8 [d, kp] and sdoc [groups, d] (dW2); xnct int8 [d, kp] and sxn
// [groups, d], dh1qt int8 [m, kp] and sdhc [groups, m] (dW1). x and dout
// hold a whole number of groups of rows.
extern "C" int vitax_ln_mlp_int4_bwd(
    const void* x, const void* gamma, const void* beta, const void* b1, const void* w1,
    const void* w2, const void* dout, void* dx, void* dgamma, void* dbeta, void* dw1, void* db1,
    void* dw2, void* db2, void* w1r, void* s1r, void* w2r, void* s2r, void* w1c, void* s1c,
    void* xn, void* xq, void* sx, void* h1, void* doq, void* sdo, void* dh1f, void* dh1,
    void* dh1q, void* sdh, void* dxn, void* ws, void* h1ct, void* sh, void* doqt, void* sdoc,
    void* xnct, void* sxn, void* dh1qt, void* sdhc, int n, int d, int m, int group, int int8_dw,
    float eps, int residual, void* stream) {
  return ln_mlp_quant_bwd_sm90<vitax::kQ4>(
      x, gamma, beta, b1, w1, w2, dout, dx, dgamma, dbeta, dw1, db1, dw2, db2, w1r, s1r, w2r, s2r,
      w1c, s1c, xn, xq, sx, h1, doq, sdo, dh1f, dh1, dh1q, sdh, dxn, ws, h1ct, sh, doqt, sdoc,
      xnct, sxn, dh1qt, sdhc, n, d, m, group, int8_dw, eps, residual,
      static_cast<cudaStream_t>(stream));
}
