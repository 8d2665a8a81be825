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
// int8_dw, two s8), on the tensor cores. This first design is the
// multi-launch form of the bf16 backward (ln_mlp_bwd.cu) with the s8 GEMM and
// the row quantizer swapped in: a1 and dh1_32 (fp32 [N, M]) and the codes go
// through device memory, the bf16 weight grads are split-K kTN products with
// an ordered second pass and the vector grads two-pass column sums: no float
// atomics, two runs give the same bits.
//
// K11-B, the A4W4 dx-path backward under int4_grad (vitax_ln_mlp_int4_bwd):
// replaces _ln_mlp_bwd_int4_kernel (:1003), reached through
// _ln_mlp_2d_int4_bwd (:1957) -> _ln_mlp_bwd_int4_call (pallas_call at
// :1914). Its body (:1017-1109) is K4's with every quantizer of the
// recompute and the dx-path on the int4 grid (_quant_rows4 of xn, do and
// dh1_32; _quant_rows_host4 / _quant_cols_host4 of W1 and W2: limit 7,
// quant.cuh), so this is the same launch sequence at L = 7. The weight
// grads never go below 8 bits: bf16 products, or under int8_dw (:1057-1074)
// products of int8 codes packed fresh per column over each group of rows,
// both operands, with no row-scale folding (the dx-path codes are int4):
//   dW2 = Σ_z f32(quant_cols(h1_z)^T quant_cols(do_z)) sh_z sdo_z
//   dW1 = Σ_z f32(quant_cols(xn_z)^T quant_cols(dh1_32_z)) sxn_z sdh_z
// (dw_int8.cuh's launch_dw_int8_cols). vitax's group is a grid step's row
// chunk, _ln_mlp_rows(npad) // _bwd_chunks (:1393, :1405) of the rows
// padded by _ln_mlp_pad (:1412); the pad rows' h1 and xn are not zero, so
// the wrapper pads the rows to a whole number of groups and passes vitax's
// group. Bound and design: K4's.
#include "dw_int8.cuh"
#include "gemm.cuh"
#include "layernorm.cuh"

namespace {

// The backward on the grid of limit L (127: K4, 7: K11-B).
template <int L>
int ln_mlp_quant_bwd(
    const void* x, const void* gamma, const void* beta, const void* b1, const void* w1,
    const void* w2, const void* dout, void* dx, void* dgamma, void* dbeta, void* dw1, void* db1,
    void* dw2, void* db2, void* w1r, void* s1r, void* w2r, void* s2r, void* w1c, void* s1c,
    void* xn, void* xq, void* sx, void* a1, void* h1, void* doq, void* sdo, void* dh1f,
    void* dh1, void* dh1q, void* sdh, void* dxn, void* ws, void* h1ct, void* sh, void* doqt,
    void* sdoc, void* xnct, void* sxn, void* dh1qt, void* sdhc, int n, int d, int m, int group,
    int int8_dw, float eps, void* stream) {
  using vitax::bf16;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* w1b = static_cast<const bf16*>(w1);
  cudaError_t e = vitax::launch_quant_weight_rows<L>(w1b, static_cast<int8_t*>(w1r),
                                                     static_cast<float*>(s1r), d, m, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_weight_rows<L>(static_cast<const bf16*>(w2),
                                         static_cast<int8_t*>(w2r), static_cast<float*>(s2r), m,
                                         d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_weight_cols_t<L>(w1b, static_cast<int8_t*>(w1c),
                                           static_cast<float*>(s1c), d, m, st);
  if (e != cudaSuccess) return e;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* dob = static_cast<const bf16*>(dout);
  auto* xnb = static_cast<bf16*>(xn);
  auto* xqi = static_cast<int8_t*>(xq);
  auto* sxf = static_cast<float*>(sx);
  auto* a1f = static_cast<float*>(a1);
  auto* h1b = static_cast<bf16*>(h1);
  auto* doqi = static_cast<int8_t*>(doq);
  auto* sdof = static_cast<float*>(sdo);
  auto* dh1ff = static_cast<float*>(dh1f);
  auto* dh1b = static_cast<bf16*>(dh1);
  auto* dh1qi = static_cast<int8_t*>(dh1q);
  auto* sdhf = static_cast<float*>(sdh);
  auto* dxnf = static_cast<float*>(dxn);
  auto* wsf = static_cast<float*>(ws);

  e = vitax::launch_layer_norm_quant<true, false, L>(
      xb, static_cast<const float*>(gamma), static_cast<const float*>(beta), xqi, sxf, xnb, n, d,
      eps, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm_s8<vitax::kS8GeluQAux>(
      xqi, static_cast<const int8_t*>(w1c), sxf, static_cast<const float*>(s1c),
      static_cast<const float*>(b1), nullptr, nullptr, h1b, a1f, n, m, d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_rows<L>(dob, doqi, sdof, n, d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm_s8<vitax::kS8GeluQGrad>(doqi, static_cast<const int8_t*>(w2r), sdof,
                                                 static_cast<const float*>(s2r), nullptr, nullptr,
                                                 a1f, dh1b, dh1ff, n, m, d, st);
  if (e != cudaSuccess) return e;
  if (!int8_dw) {
    e = vitax::launch_gemm_tn(h1b, dob, static_cast<float*>(dw2), wsf, m, d, n, st);
    if (e != cudaSuccess) return e;
    e = vitax::launch_gemm_tn(xnb, dh1b, static_cast<float*>(dw1), wsf, d, m, n, st);
    if (e != cudaSuccess) return e;
  }
  e = vitax::launch_colsum(dob, static_cast<float*>(db2), wsf, n, d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_colsum(static_cast<const float*>(dh1ff), static_cast<float*>(db1), wsf, n, m,
                           st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_rows<L>(static_cast<const float*>(dh1ff), dh1qi, sdhf, n, m, st);
  if (e != cudaSuccess) return e;
  if (int8_dw && L == vitax::kQ4) {  // fresh per-column packs of both operands
    e = vitax::launch_dw_int8_cols<bf16, bf16>(
        h1b, dob, n, m, d, group, static_cast<int8_t*>(h1ct), static_cast<float*>(sh),
        static_cast<int8_t*>(doqt), static_cast<float*>(sdoc), static_cast<float*>(dw2), st);
    if (e != cudaSuccess) return e;
    e = vitax::launch_dw_int8_cols<bf16, float>(
        xnb, dh1ff, n, d, m, group, static_cast<int8_t*>(xnct), static_cast<float*>(sxn),
        static_cast<int8_t*>(dh1qt), static_cast<float*>(sdhc), static_cast<float*>(dw1), st);
    if (e != cudaSuccess) return e;
  } else if (int8_dw) {  // row-scale folding into the dx-path's int8 codes
    e = vitax::launch_dw_int8<bf16>(h1b, sdof, doqi, n, m, d, group, static_cast<int8_t*>(h1ct),
                                    static_cast<float*>(sh), static_cast<int8_t*>(doqt),
                                    static_cast<float*>(dw2), st);
    if (e != cudaSuccess) return e;
    e = vitax::launch_dw_int8<bf16>(xnb, sdhf, dh1qi, n, d, m, group, static_cast<int8_t*>(xnct),
                                    static_cast<float*>(sxn), static_cast<int8_t*>(dh1qt),
                                    static_cast<float*>(dw1), st);
    if (e != cudaSuccess) return e;
  }
  e = vitax::launch_gemm_s8<vitax::kS8F32>(dh1qi, static_cast<const int8_t*>(w1r), sdhf,
                                           static_cast<const float*>(s1r), nullptr, nullptr,
                                           nullptr, nullptr, dxnf, n, d, m, st);
  if (e != cudaSuccess) return e;
  return vitax::launch_layer_norm_bwd<bf16, float>(
      xb, static_cast<const float*>(gamma), dxnf, dob,
      static_cast<bf16*>(dx), static_cast<float*>(dgamma), static_cast<float*>(dbeta), wsf, n, d,
      eps, st);
}

}  // namespace

// Inputs x, dout bf16 [n, d], gamma, beta fp32 [d], b1 [m], w1 bf16 [d, m],
// w2 bf16 [m, d]. Outputs dx (bf16 [n, d]) and fp32 dgamma, dbeta [d], dw1
// [d, m], db1 [m], dw2 [m, d], db2 [d]. Scratch: w1r int8 [d, m], s1r [d],
// w2r int8 [m, d], s2r [m], w1c int8 [m, d], s1c [m], xn bf16 [n,d], xq int8
// [n,d], sx [n], a1 fp32 [n,m], h1 bf16 [n,m], doq int8 [n,d], sdo [n], dh1f
// fp32 [n,m], dh1 bf16 [n,m], dh1q int8 [n,m], sdh [n], dxn fp32 [n,d], ws
// fp32 vitax_ln_mlp_bwd_ws(n, d, m); with int8_dw (else null), kp = groups *
// round_up(group, 64): h1ct int8 [m, kp], sh fp32 [groups, m], doqt int8
// [d, kp], xnct int8 [d, kp], sxn fp32 [groups, d], dh1qt int8 [m, kp].
extern "C" int vitax_ln_mlp_int8_bwd(
    const void* x, const void* gamma, const void* beta, const void* b1, const void* w1,
    const void* w2, const void* dout, void* dx, void* dgamma, void* dbeta, void* dw1, void* db1,
    void* dw2, void* db2, void* w1r, void* s1r, void* w2r, void* s2r, void* w1c, void* s1c,
    void* xn, void* xq, void* sx, void* a1, void* h1, void* doq, void* sdo, void* dh1f,
    void* dh1, void* dh1q, void* sdh, void* dxn, void* ws, void* h1ct, void* sh, void* doqt,
    void* xnct, void* sxn, void* dh1qt, int n, int d, int m, int group, int int8_dw, float eps,
    void* stream) {
  return ln_mlp_quant_bwd<vitax::kQ8>(
      x, gamma, beta, b1, w1, w2, dout, dx, dgamma, dbeta, dw1, db1, dw2, db2, w1r, s1r, w2r, s2r,
      w1c, s1c, xn, xq, sx, a1, h1, doq, sdo, dh1f, dh1, dh1q, sdh, dxn, ws, h1ct, sh, doqt,
      nullptr, xnct, sxn, dh1qt, nullptr, n, d, m, group, int8_dw, eps, stream);
}

// K11-B: K4's arguments on the int4 grid; with int8_dw (else null) the
// fresh column packs of both operands of each weight grad: h1ct int8 [m,
// kp] and sh fp32 [groups, m], doqt int8 [d, kp] and sdoc [groups, d] (dW2);
// xnct int8 [d, kp] and sxn [groups, d], dh1qt int8 [m, kp] and sdhc
// [groups, m] (dW1). x and dout hold a whole number of groups of rows.
extern "C" int vitax_ln_mlp_int4_bwd(
    const void* x, const void* gamma, const void* beta, const void* b1, const void* w1,
    const void* w2, const void* dout, void* dx, void* dgamma, void* dbeta, void* dw1, void* db1,
    void* dw2, void* db2, void* w1r, void* s1r, void* w2r, void* s2r, void* w1c, void* s1c,
    void* xn, void* xq, void* sx, void* a1, void* h1, void* doq, void* sdo, void* dh1f,
    void* dh1, void* dh1q, void* sdh, void* dxn, void* ws, void* h1ct, void* sh, void* doqt,
    void* sdoc, void* xnct, void* sxn, void* dh1qt, void* sdhc, int n, int d, int m, int group,
    int int8_dw, float eps, void* stream) {
  return ln_mlp_quant_bwd<vitax::kQ4>(
      x, gamma, beta, b1, w1, w2, dout, dx, dgamma, dbeta, dw1, db1, dw2, db2, w1r, s1r, w2r, s2r,
      w1c, s1c, xn, xq, sx, a1, h1, doq, sdo, dh1f, dh1, dh1q, sdh, dxn, ws, h1ct, sh, doqt, sdoc,
      xnct, sxn, dh1qt, sdhc, n, d, m, group, int8_dw, eps, stream);
}
