// K9 backward, fused QKVO attention: replaces _qkvo_attn_bwd_kernel
// (vitax/ops/pallas_kernels.py:2432), the backward of fused_qkvo_attention
// (VJP :2601-2628, pallas_call at :2593). It saves only (x̂, Wqkv, bqkv, Wo),
// as vitax's VJP, and recomputes the rest.
//
//   recompute: qkv = bf16(x̂ Wqkv + bqkv); per head P fp32 softmax and the
//              bf16 head outputs O; attn = heads side by side   (:2439-2463)
//   dattn = bf16(dY Wo^T), dWo = attn^T dY, dbo = Σ fp32(dY)      (:2466-2471)
//   per head: dp = dO V^T, dd = rowsum(fp32(dO) fp32(O)) (O the bf16 head
//             output, :2487-2491), ds = bf16(P (dp - dd)),
//             dq = bf16((ds K) scale), dk = bf16((ds^T Q) scale),
//             dv = bf16(bf16(P)^T dO)                               (:2474-2504)
//   dx = bf16(dqkv Wqkv^T), dWqkv = x̂^T dqkv, dbqkv = Σ fp32(dqkv) (:2512-2517)
// dWqkv, dbqkv, dWo and dbo come out in fp32, as the TPU kernel's outputs,
// each one sum over all B·spq rows; the VJP casts dW and dWo to their
// weights' dtype and returns dbo as it is (the autograd Function does).
//
// Bound on the H100: at b32 spq 200, 6·N·D·3HHd + 4·N·HHd·D + 12·B·H·spq²·hd
// (the core's recompute and its four backward products) ≈ 95 GFLOP,
// tensor-core bound (≈ 0.096 ms at 989 TFLOP/s bf16), as K1's. Design:
// K1's backward (ln_qkvo_attention_bwd.cu) without the LN recompute and the LN
// tail: the recompute is gemm.cuh's bias GEMM and K1's core with bf16 head
// outputs (so the core backward takes dd from them, as K1's does and K10's
// does not: AttnBwdGeom::o32 stays null); the out-projection's grads are K1's
// three launches (an NT product, a split-K TN product, a two-pass column sum);
// the core's gradients are attention_bwd.cuh's query-tile and key-tile passes
// with bf16 P and ds in device memory; the QKV projection's grads are K10's
// (dx in bf16 from an NT product). The TPU kernel carries the four weight and
// bias grads across its sequential grid in VMEM; here each is one product or
// column sum over all rows with a deterministic second pass. Nothing uses
// float atomics, so every run gives the same bits.
#include "attention_bwd.cuh"
#include "colsum.cuh"
#include "gemm.cuh"

// fp32 workspace of the backward over n rows, d inputs, hhd head columns and
// qkv width w (3·hhd).
extern "C" long long vitax_qkvo_attention_bwd_ws(int n, int d, int hhd, int w) {
  using namespace vitax;
  const size_t sizes[] = {colsum_workspace(n, d), colsum_workspace(n, w),
                          gemm_tn_workspace(hhd, d, n), gemm_tn_workspace(d, w, n)};
  size_t m = 0;
  for (size_t s : sizes) m = s > m ? s : m;
  return static_cast<long long>(m);
}

// Outputs dx (bf16 [n, d]) and fp32 dwqkv [d, w], dbqkv [w], dwo [hhd, d],
// dbo [d], w = 3·heads·hd, hhd = heads·hd. Scratch (bf16): qkv [n, w], attn
// and dattn [n, hhd], p and ds [b, heads, L, L] with L = round_up(spq, 16),
// dqkv [n, w]; ws fp32 vitax_qkvo_attention_bwd_ws(n, d, hhd, w).
extern "C" int vitax_qkvo_attention_bwd(const void* x, const void* wqkv, const void* bqkv,
                                        const void* wo, const void* dout, void* dx, void* dwqkv,
                                        void* dbqkv, void* dwo, void* dbo, void* qkv, void* attn,
                                        void* dattn, void* p, void* ds, void* dqkv, void* ws,
                                        int b, int spq, int d, int seq_len, int heads,
                                        int head_dim, float scale, void* stream) {
  using vitax::bf16;
  const auto st = static_cast<cudaStream_t>(stream);
  const int n = b * spq;
  const int hhd = heads * head_dim;
  const int w = 3 * hhd;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wqkvb = static_cast<const bf16*>(wqkv);
  const auto* dob = static_cast<const bf16*>(dout);
  auto* qkvb = static_cast<bf16*>(qkv);
  auto* attnb = static_cast<bf16*>(attn);
  auto* dattnb = static_cast<bf16*>(dattn);
  auto* dqkvb = static_cast<bf16*>(dqkv);
  auto* wsf = static_cast<float*>(ws);
  if (n == 0) return cudaErrorInvalidValue;

  // recompute qkv and the core's bf16 head outputs
  cudaError_t e = vitax::launch_gemm<vitax::kBias>(xb, wqkvb, static_cast<const float*>(bqkv),
                                                   qkvb, n, w, d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_attention_core_geom(
      vitax::attn_geom_square(qkvb, b, spq, seq_len, heads, head_dim, scale), head_dim, attnb,
      st);
  if (e != cudaSuccess) return e;

  // out-projection grads
  e = vitax::launch_gemm_nt<vitax::kStore>(dob, static_cast<const bf16*>(wo), dattnb,
                                           nullptr, n, hhd, d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm_tn(attnb, dob, static_cast<float*>(dwo), wsf, hhd, d, n, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_colsum(dob, static_cast<float*>(dbo), wsf, n, d, st);
  if (e != cudaSuccess) return e;

  // attention-core grads -> dqkv, dd from the bf16 head outputs
  e = vitax::launch_attention_bwd_packed(qkvb, attnb, dattnb, static_cast<bf16*>(p),
                                         static_cast<bf16*>(ds), dqkvb, b, spq, seq_len, heads,
                                         heads, head_dim, scale, st);
  if (e != cudaSuccess) return e;

  // QKV projection grads
  e = vitax::launch_gemm_nt<vitax::kStore>(dqkvb, wqkvb, static_cast<bf16*>(dx),
                                           nullptr, n, d, w, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm_tn(xb, dqkvb, static_cast<float*>(dwqkv), wsf, d, w, n, st);
  if (e != cudaSuccess) return e;
  return vitax::launch_colsum(static_cast<const bf16*>(dqkvb), static_cast<float*>(dbqkv), wsf,
                              n, w, st);
}
