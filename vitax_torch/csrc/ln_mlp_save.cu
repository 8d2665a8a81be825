// K12, the save-acts pair of the fused LN-MLP half (bf16): replaces
// _ln_mlp_fwd_save_kernel (vitax/ops/pallas_kernels.py:620, pallas_call at
// :1687) and _ln_mlp_bwd_fast_kernel (:1245, pallas_call at :1723), reached
// through fused_ln_mlp(save_acts=True) (:2123) -> _ln_mlp_2d_save (:1985).
//
// Forward, K2's three launches (ln_mlp.cu) with one epilogue changed: fc1's
// (kBiasGeluSave) writes h1 = bf16(gelu(a1)) and also g' = bf16(gelu'(a1)),
// the exact-erf derivative in fp32 (_gelu_grad :577-584), rounded to bf16 as
// the TPU kernel stores it (:649). out is K2's, bit for bit: the same
// launches compute it.
//
// Backward from the saved h1 and g' (:1253-1290): four products, 8·N·D·M
// flops, no fc1 recompute and no fp32 a1 in device memory (K2's backward,
// ln_mlp_bwd.cu, has both):
//
//   xn  = bf16(LN2(x))                      statistics recomputed only
//   dh1 = bf16(f32(do W2^T) * f32(g'))      (kGradSaved)
//   dW2 = h1^T do, db2 = Σ fp32(do)
//   dW1 = xn^T dh1, db1 = Σ fp32(dh1)       over the bf16 dh1
//   dxn = dh1 W1^T (fp32)
//   LN tail: dx = do + bf16(dx_ln), dγ = Σ dxn x̂, dβ = Σ dxn
//
// Bound on the H100: the products on the tensor cores, 4·N·D·M flops forward
// and 8·N·D·M backward (0.12 and 0.15 ms at b32 spq 200 and 989 TFLOP/s).
// The forward writes 2·N·M bf16 more than K2's (g'), the backward reads h1
// and g' (4·N·M bytes) in place of K2's recompute, its fp32 a1 round trip
// (8·N·M bytes each way) and its erf/exp. Weight grads are K2's ordered
// split-K kTN products and vector grads its two-pass column sums: no float
// atomics, the same bits each run.
//
// With residual == 0, the kernels' `residual=False` branches (:653, :1281):
// out = bf16(fc2(...) + b2) without x + (fc2's epilogue kBias in place of
// kBiasResidual), and dx = bf16(dx_ln) without do +.
#include "gemm.cuh"
#include "layernorm.cuh"

// Inputs x bf16 [n, d], gamma, beta fp32 [d], w1 bf16 [d, m], b1 [m], w2
// bf16 [m, d], b2 [d]. Outputs out bf16 [n, d], h1 and gp bf16 [n, m].
// Scratch: xn bf16 [n, d].
extern "C" int vitax_ln_mlp_save_fwd(const void* x, const void* gamma, const void* beta,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, void* xn, void* h1, void* gp, void* out,
                                     int n, int d, int m, float eps, int residual,
                                     void* stream) {
  using vitax::bf16;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  auto* xnb = static_cast<bf16*>(xn);
  auto* h1b = static_cast<bf16*>(h1);
  cudaError_t e = vitax::launch_layer_norm(xb, static_cast<const float*>(gamma),
                                           static_cast<const float*>(beta), xnb, n, d, eps, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm<vitax::kBiasGeluSave>(xnb, static_cast<const bf16*>(w1),
                                               static_cast<const float*>(b1), nullptr, h1b, n, m,
                                               d, st, nullptr, 0, static_cast<bf16*>(gp));
  if (e != cudaSuccess) return e;
  if (!residual)
    return vitax::launch_gemm<vitax::kBias>(h1b, static_cast<const bf16*>(w2),
                                            static_cast<const float*>(b2), nullptr,
                                            static_cast<bf16*>(out), n, d, m, st);
  return vitax::launch_gemm<vitax::kBiasResidual>(h1b, static_cast<const bf16*>(w2),
                                                  static_cast<const float*>(b2), xb,
                                                  static_cast<bf16*>(out), n, d, m, st);
}

// Inputs x, dout bf16 [n, d], gamma, beta fp32 [d], w1 bf16 [d, m], w2 bf16
// [m, d], h1 and gp bf16 [n, m] (the forward's). Outputs dx (bf16 [n, d]) and
// fp32 dgamma, dbeta [d], dw1 [d, m], db1 [m], dw2 [m, d], db2 [d]. Scratch:
// xn bf16 [n, d], dh1 bf16 [n, m], dxn fp32 [n, d], ws fp32
// vitax_ln_mlp_bwd_ws(n, d, m).
extern "C" int vitax_ln_mlp_bwd_fast(const void* x, const void* gamma, const void* beta,
                                     const void* w1, const void* w2, const void* h1,
                                     const void* gp, const void* dout, void* dx, void* dgamma,
                                     void* dbeta, void* dw1, void* db1, void* dw2, void* db2,
                                     void* xn, void* dh1, void* dxn, void* ws, int n, int d, int m,
                                     float eps, int residual, void* stream) {
  using vitax::bf16;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* dob = static_cast<const bf16*>(dout);
  auto* xnb = static_cast<bf16*>(xn);
  auto* dh1b = static_cast<bf16*>(dh1);
  auto* dxnf = static_cast<float*>(dxn);
  auto* wsf = static_cast<float*>(ws);

  cudaError_t e = vitax::launch_layer_norm(xb, static_cast<const float*>(gamma),
                                           static_cast<const float*>(beta), xnb, n, d, eps, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm_nt_saved(dob, static_cast<const bf16*>(w2), static_cast<const bf16*>(gp),
                                  dh1b, n, m, d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm_tn(static_cast<const bf16*>(h1), dob, static_cast<float*>(dw2), wsf, m,
                            d, n, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_colsum(dob, static_cast<float*>(db2), wsf, n, d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm_tn(xnb, dh1b, static_cast<float*>(dw1), wsf, d, m, n, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_colsum(static_cast<const bf16*>(dh1b), static_cast<float*>(db1), wsf, n, m,
                           st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm_nt<vitax::kStoreF32>(dh1b, static_cast<const bf16*>(w1), nullptr,
                                              nullptr, dxnf, n, d, m, st);
  if (e != cudaSuccess) return e;
  return vitax::launch_layer_norm_bwd<bf16, float>(
      xb, static_cast<const float*>(gamma), dxnf, residual ? dob : nullptr,
      static_cast<bf16*>(dx),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), wsf, n, d, eps, st);
}
