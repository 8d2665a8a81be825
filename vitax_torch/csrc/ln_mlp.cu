// K2, fused LN-MLP forward: replaces _ln_mlp_fwd_kernel
// (vitax/ops/pallas_kernels.py:587), reached through fused_ln_mlp (:2123) ->
// _ln_mlp_2d (:1653) -> _ln_mlp_fwd_call (:1456).
//
//   out = x + bf16(fc2(bf16(GELU_erf(fc1(bf16(LN(x)))))))
//
// Rounding points match the TPU kernel: xn is cast to bf16 before fc1
// (:608); a1 = fp32 acc + b1 and GELU in fp32, then the cast (:611);
// y = fp32 acc + b2, cast to bf16, and the residual add in bf16 (:615).
//
// Bound on the H100: the two GEMMs, 4*N*D*M flops against ~2*N*D + D*M*4
// bytes, well above the card's ridge point. Design of this first version:
// three launches on one stream -- the LN kernel, then the tiled GEMM of
// gemm.cuh with a bias+GELU epilogue writing h1 [N,M], then the same GEMM
// with a bias+residual epilogue. The TPU kernel keeps xn and h1 in VMEM; here
// they go through device memory (2*N*D + 2*N*M extra bytes written and read
// once each). Keeping h1 on chip is the first fusion of a later PR. Rows need
// no padding: each GEMM masks its ragged row edge.
#include "gemm.cuh"
#include "layernorm.cuh"

extern "C" int vitax_ln_mlp_fwd(const void* x, const void* gamma, const void* beta,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                void* xn, void* h1, void* out, int n, int d, int m, float eps,
                                void* stream) {
  using vitax::bf16;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  auto* xnb = static_cast<bf16*>(xn);
  auto* h1b = static_cast<bf16*>(h1);
  cudaError_t e = vitax::launch_layer_norm(xb, static_cast<const float*>(gamma),
                                           static_cast<const float*>(beta), xnb, n, d, eps, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm<vitax::kBiasGelu>(xnb, static_cast<const bf16*>(w1),
                                            static_cast<const float*>(b1), nullptr, h1b, n, m, d,
                                            st);
  if (e != cudaSuccess) return e;
  return vitax::launch_gemm<vitax::kBiasResidual>(h1b, static_cast<const bf16*>(w2),
                                                  static_cast<const float*>(b2), xb,
                                                  static_cast<bf16*>(out), n, d, m, st);
}
