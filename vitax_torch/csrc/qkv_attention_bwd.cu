// K10 backward, fused QKV attention: replaces _qkv_attn_bwd_kernel
// (vitax/ops/pallas_kernels.py:2239), the backward of fused_qkv_attention
// (VJP :2369-2391, pallas_call at :2334). It saves only (x̂, W, b), as vitax's
// VJP, and recomputes the rest.
//
//   recompute: qkv = bf16(x̂ Wqkv + bqkv); per head P fp32 softmax and
//              out_h = fp32(bf16(P) V), the head output before its cast
//                                                                  (:2243-2266)
//   per head: dp = dO V^T, dd = rowsum(fp32(dO) out_h), ds = bf16(P (dp - dd))
//             dq = bf16((ds K) scale), dk = bf16((ds^T Q) scale),
//             dv = bf16(bf16(P)^T dO)                              (:2267-2280)
//   dx = bf16(dqkv Wqkv^T), dWqkv = x̂^T dqkv (fp32), dbqkv = Σ fp32(dqkv)
//                                                                  (:2287-2303)
// dW and db come out in fp32, as the TPU kernel's outputs; the VJP casts dW to
// W's dtype (the autograd Function does).
//
// Bound on the H100: at b32 spq 200, 6·N·D·3HHd + 10·B·H·spq²·hd ≈ 78 GFLOP
// (vitax's CostEstimate, :2359), tensor-core bound (≈ 0.079 ms at 989 TFLOP/s
// bf16). Design: K6's backward order (ln_qkvo_attention_flash_bwd.cu) on
// K9's pieces, without an LN or an out-projection. The recompute is the
// forward's qkv product (gemm_sm90.cuh, kEpiBias: the forward's qkv bits).
// Then one row pass of K13's core (attention_core.cuh, kRowsFwdStats):
// kRowsFwd's two passes over the key tiles, p normalised in fp32 and
// rounded to bf16 once, P·V summed in fp32 registers, and in place of the
// head outputs, to the [b, heads, 3, seq_pad] `stats` scratch, m·scale·log2e
// and 1/l of every query row and dd = Σ fp32(dO)·out_h from the fp32 head
// output in those registers: vitax's K10 takes dd from the fp32 P·V, where
// its K1 and K9 take it from the cast one (K13's own row pass, kRowsStats,
// reads the bf16 out). K13's key pass (dk, dv) and query pass (dq) read
// those statistics (launch_core_bwd_passes) and write into dqkv's packed
// columns, so neither P nor ds reaches device memory. Last, the QKV
// projection's grads as K9's (qkvo_sm90.cuh's `proj_bwd`): dx =
// bf16(dqkv·Wqkvᵀ) on kEpiStore, dWqkv on the split-K kTN product with its
// ordered second pass, dbqkv a two-pass column sum. The TPU kernel carries
// dW and db across its sequential grid in VMEM; here each is one sum over
// all B·spq rows. Nothing uses float atomics, so every run gives the same
// bits.
#include "qkvo_sm90.cuh"

// fp32 workspace of the backward over n rows, d inputs, qkv width w.
extern "C" long long vitax_qkv_attention_bwd_ws(int n, int d, int w) {
  return static_cast<long long>(vitax::qkvo::proj_bwd_workspace(n, d, w));
}

// Outputs dx (bf16 [n, d]) and fp32 dwqkv [d, w], dbqkv [w], w = 3·heads·hd.
// Scratch: qkv bf16 [n, w], stats fp32 vitax_attention_core_bwd_ws(b, spq,
// heads), dqkv bf16 [n, w], ws fp32 vitax_qkv_attention_bwd_ws(n, d, w).
extern "C" int vitax_qkv_attention_bwd(const void* x, const void* wqkv, const void* bqkv,
                                       const void* dout, void* dx, void* dwqkv, void* dbqkv,
                                       void* qkv, void* stats, void* dqkv, void* ws, int b,
                                       int spq, int d, int seq_len, int heads, int head_dim,
                                       float scale, void* stream) {
  using vitax::bf16;
  namespace sm90 = vitax::sm90;
  namespace k13 = vitax::k13;
  const auto st = static_cast<cudaStream_t>(stream);
  const int n = b * spq;
  const int hhd = heads * head_dim;
  const int w = 3 * hhd;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wqkvb = static_cast<const bf16*>(wqkv);
  auto* qkvb = static_cast<bf16*>(qkv);
  auto* dqkvb = static_cast<bf16*>(dqkv);
  if (n == 0 || !vitax::qkvo::shapes_ok(b, spq, seq_len)) return cudaErrorInvalidValue;

  // the recompute: the forward's qkv product
  cudaError_t e = sm90::gemm_nn<sm90::kEpiBias>(xb, wqkvb, static_cast<const float*>(bqkv), qkvb,
                                                nullptr, n, w, d, st);
  if (e != cudaSuccess) return e;

  // the row pass: m, 1/l and dd from the fp32 head outputs to stats
  k13::CoreArgs a = vitax::qkvo::packed_args(qkvb, nullptr, spq, seq_len, heads, head_dim, scale);
  a.dout = static_cast<const bf16*>(dout);
  a.ld_do = hhd;
  a.dq = dqkvb, a.dk = dqkvb + hhd, a.dv = dqkvb + 2 * hhd;
  a.ld_dq = a.ld_dk = a.ld_dv = w;
  a.stats = static_cast<float*>(stats);
  a.seq_pad = (spq + k13::kRows - 1) / k13::kRows * k13::kRows;
  e = k13::launch_core_rows<k13::kRowsFwdStats>(a, head_dim, b, st);
  if (e != cudaSuccess) return e;

  // attention-core grads -> dqkv (K13's key and query passes)
  e = k13::launch_core_bwd_passes(a, head_dim, b, st);
  if (e != cudaSuccess) return e;

  // QKV projection grads
  return vitax::qkvo::proj_bwd(xb, wqkvb, dqkvb, static_cast<bf16*>(dx), nullptr,
                               static_cast<float*>(dwqkv), static_cast<float*>(dbqkv),
                               static_cast<float*>(ws), n, d, w, st);
}
