// K2, fused LN-MLP forward: replaces _ln_mlp_fwd_kernel
// (vitax/ops/pallas_kernels.py:587), reached through fused_ln_mlp (:2123) ->
// _ln_mlp_2d (:1653) -> _ln_mlp_fwd_call (:1456).
//
//   out = x + bf16(fc2(bf16(GELU_erf(fc1(bf16(LN(x)))))))
//
// Rounding points match the TPU kernel: xn is cast to bf16 before fc1
// (:608); a1 = fp32 acc + b1 and GELU in fp32, then the cast (:611);
// y = fp32 acc + b2, cast to bf16, and the residual add in bf16 (:615).
// With residual == 0 it is the kernel's `residual=False` branch (:614), which
// vitax's tensor-parallel MLP half runs per model shard
// (vitax/parallel/tp_kernels.py:116-119): out = bf16(fc2(...) + b2), no x +,
// fc2's epilogue kEpiBias in place of kEpiBiasResidual.
//
// Bound on the H100: the two GEMMs, 4·N·D·M operations against ~2·N·D +
// D·M·4 bytes, well above the card's ridge point. The Hopper design, three
// launches on one stream: LN (layernorm.cuh), then fc1 on gemm_sm90.cuh's
// wgmma GEMM (a producer warp's TMA loads in flight on mbarriers, 128×128
// tiles in two consumer warpgroups) with the epilogue kEpiBiasGelu writing
// h1 [N, M], then fc2 on the same GEMM with kEpiBiasResidual (kEpiBias
// without the residual). Both epilogues compute in fp32 as gemm.cuh's of
// the same name, and both fc2 branches run the same product, so x + the
// partial is the full output to the bit. The TPU kernel keeps xn and h1 in
// VMEM; here they go through device memory (at M 3072 a 128-row block's h1
// is 768 KB, beyond shared memory). Rows need no padding: the TMA
// zero-fills the ragged row edge and the epilogue masks its stores.
#include "gemm_sm90.cuh"
#include "layernorm.cuh"

extern "C" int vitax_ln_mlp_fwd(const void* x, const void* gamma, const void* beta,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                void* xn, void* h1, void* out, int n, int d, int m, float eps,
                                int residual, void* stream) {
  using vitax::bf16;
  namespace sm90 = vitax::sm90;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  auto* xnb = static_cast<bf16*>(xn);
  auto* h1b = static_cast<bf16*>(h1);
  auto* outb = static_cast<bf16*>(out);
  cudaError_t e = vitax::launch_layer_norm(xb, static_cast<const float*>(gamma),
                                           static_cast<const float*>(beta), xnb, n, d, eps, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_nn<sm90::kEpiBiasGelu>(xnb, static_cast<const bf16*>(w1),
                                        static_cast<const float*>(b1), h1b, nullptr, n, m, d, st);
  if (e != cudaSuccess) return e;
  const auto* w2b = static_cast<const bf16*>(w2);
  const auto* b2f = static_cast<const float*>(b2);
  if (!residual) return sm90::gemm_nn<sm90::kEpiBias>(h1b, w2b, b2f, outb, nullptr, n, d, m, st);
  return sm90::gemm_nn<sm90::kEpiBiasResidual>(h1b, w2b, b2f, outb, nullptr, n, d, m, st, xb);
}
