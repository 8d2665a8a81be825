// K10 backward, fused QKV attention: replaces _qkv_attn_bwd_kernel
// (vitax/ops/pallas_kernels.py:2239), the backward of fused_qkv_attention
// (VJP :2369-2391, pallas_call at :2334). It saves only (x̂, W, b), as vitax's
// VJP, and recomputes the rest.
//
//   recompute: qkv = bf16(x̂ Wqkv + bqkv); per head P fp32 softmax and
//              o32 = fp32(bf16(P) V), the head output before its cast
//                                                                  (:2243-2266)
//   per head: dp = dO V^T, dd = rowsum(fp32(dO) o32), ds = bf16(P (dp - dd))
//             dq = bf16((ds K) scale), dk = bf16((ds^T Q) scale),
//             dv = bf16(bf16(P)^T dO)                              (:2267-2280)
//   dx = bf16(dqkv Wqkv^T), dWqkv = x̂^T dqkv (fp32), dbqkv = Σ fp32(dqkv)
//                                                                  (:2287-2303)
// dW and db come out in fp32, as the TPU kernel's outputs; the VJP casts dW to
// W's dtype (the autograd Function does).
//
// Bound on the H100: at b32 spq 200, 6·N·D·3HHd + 10·B·H·spq²·hd ≈ 78 GFLOP
// (vitax's CostEstimate, :2359), tensor-core bound (≈ 0.079 ms at 989 TFLOP/s
// bf16). Design: K1's backward (ln_qkvo_attention_bwd.cu) without the LN
// recompute and tail and without the out-projection's grads. The recompute is
// gemm.cuh's bias GEMM and K1's core with fp32 head outputs (OutT = float),
// which feed dd where K1's backward reads its bf16 attn (vitax's K10 takes dd
// from the fp32 P·V, :2264-2268; its K1 from the cast one). The core's
// gradients are the two-pass backward of attention_bwd.cuh: a query-tile pass
// (P, ds and dq; bf16 P and ds staged in device memory, 2·B·H·L² bf16) and a
// key-tile pass (dk, dv in fp32 WMMA fragments, one cast). The TPU kernel
// carries dW and db across its sequential grid in VMEM; here dW is one kTN
// product over all B·spq rows (split K, a deterministic second pass) and db a
// two-pass column sum (colsum.cuh). Nothing uses float atomics, so every run
// gives the same bits.
#include "attention_bwd.cuh"
#include "colsum.cuh"
#include "gemm.cuh"

// fp32 workspace of the backward over n rows, d inputs, qkv width w.
extern "C" long long vitax_qkv_attention_bwd_ws(int n, int d, int w) {
  using namespace vitax;
  const size_t a = colsum_workspace(n, w);
  const size_t c = gemm_tn_workspace(d, w, n);
  return static_cast<long long>(a > c ? a : c);
}

// Outputs dx (bf16 [n, d]) and fp32 dwqkv [d, w], dbqkv [w], w = 3 heads hd.
// Scratch: qkv bf16 [n, w], o32 fp32 [n, heads·hd], p and ds bf16
// [b, heads, L, L] with L = round_up(spq, 16), dqkv bf16 [n, w], ws fp32
// vitax_qkv_attention_bwd_ws(n, d, w).
extern "C" int vitax_qkv_attention_bwd(const void* x, const void* wqkv, const void* bqkv,
                                       const void* dout, void* dx, void* dwqkv, void* dbqkv,
                                       void* qkv, void* o32, void* p, void* ds, void* dqkv,
                                       void* ws, int b, int spq, int d, int seq_len, int heads,
                                       int head_dim, float scale, void* stream) {
  using vitax::bf16;
  const auto st = static_cast<cudaStream_t>(stream);
  const int n = b * spq;
  const int w = 3 * heads * head_dim;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wqkvb = static_cast<const bf16*>(wqkv);
  auto* qkvb = static_cast<bf16*>(qkv);
  auto* o32f = static_cast<float*>(o32);
  auto* dqkvb = static_cast<bf16*>(dqkv);
  auto* wsf = static_cast<float*>(ws);
  if (n == 0) return cudaErrorInvalidValue;

  // recompute qkv and the core's fp32 head outputs
  cudaError_t e = vitax::launch_gemm<vitax::kBias>(xb, wqkvb, static_cast<const float*>(bqkv),
                                                   qkvb, n, w, d, st);
  if (e != cudaSuccess) return e;
  const vitax::AttnGeom f =
      vitax::attn_geom_square(qkvb, b, spq, seq_len, heads, head_dim, scale);
  e = vitax::launch_attention_core_geom(f, head_dim, o32f, st);
  if (e != cudaSuccess) return e;

  // attention-core grads -> dqkv, dd from the fp32 head outputs
  vitax::AttnBwdGeom g{f,        nullptr,  static_cast<const bf16*>(dout),
                       dqkvb,    f.q_ld,   dqkvb,
                       f.q_ld,   f.k_off,  f.v_off,
                       static_cast<bf16*>(p), static_cast<bf16*>(ds)};
  g.o32 = o32f;
  e = vitax::launch_attention_bwd_geom(g, head_dim, st);
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
