// K2 backward, fused LN-MLP: replaces _ln_mlp_bwd_kernel
// (vitax/ops/pallas_kernels.py:1308), reached through _ln_mlp_2d_bwd (:1662)
// -> _ln_mlp_bwd_call (:1477, pallas_call at :1486). In the order of the
// Pallas body (:1322-1372):
//
//   xn   = bf16(LN2(x))                       recompute
//   a1   = xn W1 + b1 (fp32), h1 = bf16(gelu(a1))
//   dh1f = do W2^T (fp32);  dh1 = bf16(dh1f gelu'(a1))         (:1338-1346)
//   dW2  = h1^T do,  db2 = Σ fp32(do)
//   dW1  = xn^T dh1, db1 = Σ fp32(dh1)   (over the bf16 dh1, :1354)
//   dxn  = dh1 W1^T (fp32)
//   LN tail: dx = do + bf16(dx_ln) (the add in bf16, :1367-1368), or
//            bf16(dx_ln) without the residual; dγ = Σ dxn x̂, dβ = Σ dxn
// Weight and vector grads come out in fp32, as the TPU kernel's outputs.
//
// Bound on the H100: the six products (12·N·D·M operations with the
// recompute of fc1's output: 1.81e11 at b32 spq 200), tensor-core
// bound at the ViT shapes. The TPU kernel keeps xn, a1, h1 and dh1 in VMEM
// and carries dW/db/dγ/dβ across its sequential grid. Here every product is
// gemm_sm90.cuh's wgmma GEMM, and fc1's recompute and dh1f = do·W2ᵀ are one
// dual-accumulator product (gemm_gelu_pair): each [128 rows, 128 of M] tile
// accumulates a1 = xn·W1 and dh1f side by side over K = D in registers, and
// its epilogue writes h1 = bf16(gelu(a1 + b1)) and dh1 = bf16(dh1f·gelu'(a1
// + b1)) in fp32 (erf + exp, as _gelu_grad :577-584), so the pre-activation
// a1 never reaches device memory, as in vitax's VMEM (stages 2–4,
// :1335-1350). xn, h1, dh1 (bf16) and dxn (fp32 [N, D]) go through device
// memory. Every weight grad is one kTN product over all N rows (split K,
// deterministic second pass) and every vector grad a two-pass column sum:
// no float atomics. The same entry point serves d > 1024 (the :1610 route,
// ViT-H/14's D 1280, M 5120).
#include "gemm.cuh"
#include "gemm_sm90.cuh"
#include "layernorm.cuh"

extern "C" long long vitax_ln_mlp_bwd_ws(int n, int d, int m) {
  using namespace vitax;
  const size_t sizes[] = {gemm_tn_workspace(m, d, n), gemm_tn_workspace(d, m, n),
                          colsum_workspace(n, d), colsum_workspace(n, m),
                          layer_norm_bwd_workspace(n, d)};
  size_t mx = 0;
  for (size_t s : sizes) mx = s > mx ? s : mx;
  return static_cast<long long>(mx);
}

// Outputs dx (bf16 [n, d]) and fp32 dgamma, dbeta [d], dw1 [d, m], db1 [m],
// dw2 [m, d], db2 [d]. Scratch: xn bf16 [n, d], h1 and dh1 bf16 [n, m], dxn
// fp32 [n, d], ws fp32 vitax_ln_mlp_bwd_ws(n, d, m).
extern "C" int vitax_ln_mlp_bwd(const void* x, const void* gamma, const void* beta, const void* w1,
                                const void* b1, const void* w2, const void* dout, void* dx,
                                void* dgamma, void* dbeta, void* dw1, void* db1, void* dw2,
                                void* db2, void* xn, void* h1, void* dh1, void* dxn, void* ws,
                                int n, int d, int m, float eps, int residual, void* stream) {
  using vitax::bf16;
  namespace sm90 = vitax::sm90;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* dob = static_cast<const bf16*>(dout);
  auto* xnb = static_cast<bf16*>(xn);
  auto* h1b = static_cast<bf16*>(h1);
  auto* dh1b = static_cast<bf16*>(dh1);
  auto* dxnf = static_cast<float*>(dxn);
  auto* wsf = static_cast<float*>(ws);

  cudaError_t e = vitax::launch_layer_norm(xb, static_cast<const float*>(gamma),
                                           static_cast<const float*>(beta), xnb, n, d, eps, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_gelu_pair(xnb, static_cast<const bf16*>(w1), static_cast<const float*>(b1), dob,
                           static_cast<const bf16*>(w2), h1b, dh1b, n, m, d, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_tn(h1b, dob, static_cast<float*>(dw2), wsf, m, d, n, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_colsum(dob, static_cast<float*>(db2), wsf, n, d, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_tn(xnb, dh1b, static_cast<float*>(dw1), wsf, d, m, n, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_colsum(static_cast<const bf16*>(dh1b), static_cast<float*>(db1), wsf, n, m,
                           st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_nt<sm90::kEpiF32>(dh1b, static_cast<const bf16*>(w1), nullptr, dxnf, n, d, m,
                                   st);
  if (e != cudaSuccess) return e;
  return vitax::launch_layer_norm_bwd<bf16, float>(
      xb, static_cast<const float*>(gamma), dxnf, residual ? dob : nullptr,
      static_cast<bf16*>(dx), static_cast<float*>(dgamma), static_cast<float*>(dbeta), wsf, n, d,
      eps, st);
}
