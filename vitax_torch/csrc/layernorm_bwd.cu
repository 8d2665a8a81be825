// LN backward: replaces _ln_bwd_kernel (vitax/ops/pallas_kernels.py:278),
// reached through _ln_bwd_call (:338, pallas_call at :342) from the custom
// VJP of layer_norm (:365-383), which is the encoder's final norm.
//
//   dx = rstd * (dy γ - mean(dy γ) - x̂ mean(dy γ x̂)), statistics recomputed
//   in fp32; dγ = Σ dy x̂, dβ = Σ dy (fp32 [d]).
//
// Bound on the H100: device memory (read x and dy, write dx: 3·N·D values,
// ~20 flops a value). Design (layernorm.cuh): up to d 1280 one pass, a warp
// holding a row's x and dy in registers and writing dx; the TPU kernel's dγ/dβ
// accumulation across its sequential grid becomes each lane's running sums
// over its warp's rows, combined in shared memory into one partial row a
// block, and a second small launch that adds the partial rows in a fixed
// order (deterministic, no atomics). Wider rows take a row pass writing
// mean/rstd and colsum.cuh's two-pass column sums. The same CUDA body is the
// LN tail of every fused half's backward.
#include "layernorm.cuh"

extern "C" long long vitax_layer_norm_bwd_ws(int n, int d) {
  return static_cast<long long>(vitax::layer_norm_bwd_workspace(n, d));
}

// x, dy, dx [n, d] bf16 (is_bf16) or fp32; gamma, dgamma, dbeta fp32 [d];
// ws fp32 vitax_layer_norm_bwd_ws(n, d).
extern "C" int vitax_layer_norm_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                                    void* dgamma, void* dbeta, void* ws, int n, int d, float eps,
                                    int is_bf16, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(gamma);
  auto* dg = static_cast<float*>(dgamma);
  auto* db = static_cast<float*>(dbeta);
  auto* w = static_cast<float*>(ws);
  if (is_bf16) {
    using vitax::bf16;
    return vitax::launch_layer_norm_bwd<bf16, bf16>(
        static_cast<const bf16*>(x), g, static_cast<const bf16*>(dy), nullptr,
        static_cast<bf16*>(dx), dg, db, w, n, d, eps, st);
  }
  return vitax::launch_layer_norm_bwd<float, float>(static_cast<const float*>(x), g,
                                                    static_cast<const float*>(dy), nullptr,
                                                    static_cast<float*>(dx), dg, db, w, n, d,
                                                    eps, st);
}
