// K6 backward, the KV-chunked fused LN-QKVO attention: replaces
// _ln_qkvo_bwd_flash_kernel (vitax/ops/pallas_kernels.py:3446), the body of
// _fused_flash_bwd (:3585, pallas_call at :3605).
//
//   recompute: xn = bf16(LN1(x)), qkv = bf16(xn Wqkv + bqkv)     (:3453-3463)
//   dattn = bf16(do Wo^T)                                        (:3466-3468)
//   per (image, head): (m, l) and the fp32 out recomputed by the forward's
//     recurrence, dd = Σ fp32(dO) out, then per key tile p = exp(s − m) / l,
//     ds = bf16(p (dO v^T − dd)), dq = bf16(Σ (ds k) scale),
//     dk = bf16((ds^T q) scale), dv = bf16(bf16(p)^T dO)         (:3470-3510)
//   dWo = attn^T do, dbo = Σ do; dxn = dqkv Wqkv^T (fp32), dWqkv = xn^T dqkv,
//   dbqkv = Σ fp32(dqkv); LN tail dx, dγ = Σ dxn x̂, dβ = Σ dxn   (:3514-3531)
// Weight and vector grads come out in fp32, as the TPU kernel's outputs.
//
// Bound on the H100: the projections' six products and the core's (the
// recompute's q·kᵀ and P·V, dO·vᵀ, ds·k, dsᵀ·q, pᵀ·dO), all tensor-core
// bound. K1's backward sequence (ln_qkvo_attention_bwd.cu) with one change
// in the core: where K1 recomputes attn with K13's forward and then runs
// K13's row pass, K6 runs one row pass, the online forward's
// (attention_core.cuh, kRowsOnlineStats): it writes the recomputed bf16
// head outputs into attn (the out-projection's weight-grad operand) and, to
// the [b, heads, 3, seq_pad] `stats` scratch, m·scale·log2e, 1/l and dd =
// Σ fp32(dO)·out from the fp32 out in its registers (vitax's :3479), so it
// runs after dattn = do·Woᵀ. K13's key pass (dk, dv) and query pass (dq)
// then read those statistics, p = exp2(s·scale·log2e − m)·(1/l) as vitax's
// exp(s − m)/l (:3494), and write into dqkv's packed columns. Neither P
// nor ds reaches device memory. Products on gemm_sm90.cuh (wgmma
// m64n128k16 on a producer warp's TMA loads): the qkv recompute (the
// forward's very call, so the same qkv bits), dattn (kNT into bf16), dWo
// and dWqkv (kTN over all rows, split K with an ordered second pass), dxn
// (kNT into fp32); every vector grad a two-pass column sum (colsum.cuh).
// No float atomics: two runs give the same bits.
#include "attention_core.cuh"
#include "gemm_sm90.cuh"
#include "layernorm.cuh"

// Outputs dx (bf16 [n, d]) and fp32 dgamma, dbeta [d], dwqkv [d, 3 hhd],
// dbqkv [3 hhd], dwo [hhd, d], dbo [d]. Scratch (bf16 unless noted): xn
// [n,d], qkv [n,3 hhd], attn and dattn [n,hhd], stats fp32
// vitax_attention_core_bwd_ws(b, spq, heads), dqkv [n,3 hhd], dxn fp32
// [n,d], ws fp32 vitax_ln_qkvo_attention_bwd_ws(n, d, hhd, 3 hhd).
extern "C" int vitax_ln_qkvo_attention_flash_bwd(
    const void* x, const void* gamma, const void* beta, const void* wqkv, const void* bqkv,
    const void* wo, const void* dout, void* dx, void* dgamma, void* dbeta, void* dwqkv,
    void* dbqkv, void* dwo, void* dbo, void* xn, void* qkv, void* attn, void* dattn, void* stats,
    void* dqkv, void* dxn, void* ws, int b, int spq, int d, int seq_len, int heads, int head_dim,
    float eps, float scale, void* stream) {
  using vitax::bf16;
  namespace sm90 = vitax::sm90;
  namespace k13 = vitax::k13;
  const auto st = static_cast<cudaStream_t>(stream);
  const int n = b * spq;
  const int hhd = heads * head_dim;
  const int w = 3 * hhd;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wqkvb = static_cast<const bf16*>(wqkv);
  const auto* dob = static_cast<const bf16*>(dout);
  auto* xnb = static_cast<bf16*>(xn);
  auto* qkvb = static_cast<bf16*>(qkv);
  auto* attnb = static_cast<bf16*>(attn);
  auto* dattnb = static_cast<bf16*>(dattn);
  auto* dqkvb = static_cast<bf16*>(dqkv);
  auto* dxnf = static_cast<float*>(dxn);
  auto* wsf = static_cast<float*>(ws);
  if (n == 0 || b > 65535 || seq_len <= 0 || seq_len > spq) return cudaErrorInvalidValue;

  // recompute LN1 and qkv; dattn
  cudaError_t e = vitax::launch_layer_norm(xb, static_cast<const float*>(gamma),
                                           static_cast<const float*>(beta), xnb, n, d, eps, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_nn<sm90::kEpiBias>(xnb, wqkvb, static_cast<const float*>(bqkv), qkvb, nullptr,
                                    n, w, d, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_nt<sm90::kEpiStore>(dob, static_cast<const bf16*>(wo), dattnb, nullptr, n, hhd,
                                     d, st);
  if (e != cudaSuccess) return e;

  // the online row pass: attn and the row statistics
  k13::CoreArgs a{};
  a.q = qkvb, a.k = qkvb + hhd, a.v = qkvb + 2 * hhd;
  a.o = attnb, a.dout = dattnb;
  a.dq = dqkvb, a.dk = dqkvb + hhd, a.dv = dqkvb + 2 * hhd;
  a.stats = static_cast<float*>(stats);
  a.seq = seq_len, a.rows = a.kv_rows = spq, a.img_rows = a.kv_img_rows = spq, a.heads = heads;
  a.kv_heads = heads;
  a.seq_pad = (spq + k13::kRows - 1) / k13::kRows * k13::kRows;
  a.scale = scale;
  a.ld_q = a.ld_k = a.ld_v = a.ld_dq = a.ld_dk = a.ld_dv = w;
  a.ld_o = a.ld_do = hhd;
  e = k13::launch_core_online<k13::kRowsOnlineStats>(a, head_dim, b, st);
  if (e != cudaSuccess) return e;

  // out-projection grads
  e = sm90::gemm_tn(attnb, dob, static_cast<float*>(dwo), wsf, hhd, d, n, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_colsum(dob, static_cast<float*>(dbo), wsf, n, d, st);
  if (e != cudaSuccess) return e;

  // attention-core grads -> dqkv (K13's key and query passes)
  e = k13::launch_core_bwd_passes(a, head_dim, b, st);
  if (e != cudaSuccess) return e;

  // QKV projection grads and the LN tail
  e = sm90::gemm_nt<sm90::kEpiF32>(dqkvb, wqkvb, nullptr, dxnf, n, d, w, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_tn(xnb, dqkvb, static_cast<float*>(dwqkv), wsf, d, w, n, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_colsum(static_cast<const bf16*>(dqkvb), static_cast<float*>(dbqkv), wsf, n, w,
                           st);
  if (e != cudaSuccess) return e;
  return vitax::launch_layer_norm_bwd<bf16, float>(
      xb, static_cast<const float*>(gamma), dxnf, nullptr, static_cast<bf16*>(dx),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), wsf, n, d, eps, st);
}
