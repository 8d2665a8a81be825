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
//   dx = bf16(dqkv Wqkv^T), dWqkv = x̂^T dqkv, dbqkv = Σ fp32(dqkv) (:2510-2517)
// dWqkv, dbqkv, dWo and dbo come out in fp32, as the TPU kernel's outputs,
// each one sum over all B·spq rows; the VJP casts dW and dWo to their
// weights' dtype and returns dbo as it is (the autograd Function does).
//
// Bound on the H100: at b32 spq 200, 6·N·D·3HHd + 4·N·HHd·D + 12·B·H·spq²·hd
// (the core's recompute and its four backward products) ≈ 95 GFLOP,
// tensor-core bound (≈ 0.096 ms at 989 TFLOP/s bf16), as K1's. Design: K1's
// backward without the LN recompute and the LN tail, qkvo_sm90.cuh's
// backward on x̂: the forward's qkv product and K13's core for the
// recompute; the out-projection's grads (an NT product, a split-K TN
// product, a two-pass column sum); K13's three passes into dqkv's packed
// columns (the row pass takes dd from the bf16 head outputs, as vitax's
// kernel and K1's do; its m, 1/l and dd in `stats`, 12 bytes a row, so
// neither P nor ds reaches device memory); dx = bf16(dqkv·Wqkvᵀ), one
// rounding of the fp32 product (kEpiStore: K9 has no LN tail), dWqkv on the
// TN product, dbqkv a column sum. The TPU kernel carries the four weight
// and bias grads across its sequential grid in VMEM; here each is one
// product or column sum over all rows with a deterministic second pass.
// Nothing uses float atomics, so every run gives the same bits.
#include "qkvo_sm90.cuh"

// fp32 workspace of the backward over n rows, d inputs, hhd head columns and
// qkv width w (3·hhd).
extern "C" long long vitax_qkvo_attention_bwd_ws(int n, int d, int hhd, int w) {
  return static_cast<long long>(vitax::qkvo::bwd_workspace(n, d, hhd, w));
}

// Outputs dx (bf16 [n, d]) and fp32 dwqkv [d, w], dbqkv [w], dwo [hhd, d],
// dbo [d], w = 3·heads·hd, hhd = heads·hd. Scratch (bf16 unless noted): qkv
// [n, w], attn and dattn [n, hhd], stats fp32
// vitax_attention_core_bwd_ws(b, spq, heads), dqkv [n, w]; ws fp32
// vitax_qkvo_attention_bwd_ws(n, d, hhd, w).
extern "C" int vitax_qkvo_attention_bwd(const void* x, const void* wqkv, const void* bqkv,
                                        const void* wo, const void* dout, void* dx, void* dwqkv,
                                        void* dbqkv, void* dwo, void* dbo, void* qkv, void* attn,
                                        void* dattn, void* stats, void* dqkv, void* ws, int b,
                                        int spq, int d, int seq_len, int heads, int head_dim,
                                        float scale, void* stream) {
  using vitax::bf16;
  return vitax::qkvo::bwd(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const bf16*>(wo),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dx), nullptr,
      static_cast<float*>(dwqkv), static_cast<float*>(dbqkv), static_cast<float*>(dwo),
      static_cast<float*>(dbo), static_cast<bf16*>(qkv), static_cast<bf16*>(attn),
      static_cast<bf16*>(dattn), static_cast<float*>(stats), static_cast<bf16*>(dqkv),
      static_cast<float*>(ws), b, spq, d, seq_len, heads, head_dim, scale,
      static_cast<cudaStream_t>(stream));
}
