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
// Bound on the H100: the projections' six products and the core's five
// (the recompute's two, dp, dq, and the key-tile pass's dk and dv), all
// tensor-core bound. The TPU kernel carries dW, db, dγ, dβ across its
// sequential grid in VMEM; here, as in K1's backward, every weight grad is
// one kTN product over all rows (ordered split K) and every vector grad a
// two-pass column sum: no float atomics, the same bits each run. The core
// backward keeps shared memory independent of spq: the query-tile pass
// (attention_flash.cuh) recomputes (m, l) itself, writes the bf16 P and ds
// rows of each (image, head) to device memory ([b, H, L, L], L = spq rounded
// up to 16: 76 MB each at b32 spq 264) and dq; the key-tile pass of K1's
// backward (attention_bwd.cuh) then sums dk and dv over the query tiles in
// fp32 fragments, one owner per row. The query-tile pass also writes the
// recomputed bf16 head outputs, the out-projection's weight-grad operand,
// so the forward's core does not run a second time.
#include "attention_flash.cuh"
#include "gemm.cuh"
#include "layernorm.cuh"

// Outputs dx (bf16 [n, d]) and fp32 dgamma, dbeta [d], dwqkv [d, 3 hhd],
// dbqkv [3 hhd], dwo [hhd, d], dbo [d]. Scratch (bf16 unless noted): xn
// [n,d], qkv [n,3 hhd], attn and dattn [n,hhd], p and ds [b,heads,L,L] with
// L = round_up(spq, 16), dqkv [n,3 hhd], dxn fp32 [n,d], ws fp32
// vitax_ln_qkvo_attention_bwd_ws(n, d, hhd, 3 hhd).
extern "C" int vitax_ln_qkvo_attention_flash_bwd(
    const void* x, const void* gamma, const void* beta, const void* wqkv, const void* bqkv,
    const void* wo, const void* dout, void* dx, void* dgamma, void* dbeta, void* dwqkv,
    void* dbqkv, void* dwo, void* dbo, void* xn, void* qkv, void* attn, void* dattn, void* p,
    void* ds, void* dqkv, void* dxn, void* ws, int b, int spq, int d, int seq_len, int heads,
    int head_dim, float eps, float scale, void* stream) {
  using vitax::bf16;
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
  if (n == 0) return cudaErrorInvalidValue;

  // recompute LN1 and qkv; dattn
  cudaError_t e = vitax::launch_layer_norm(xb, static_cast<const float*>(gamma),
                                           static_cast<const float*>(beta), xnb, n, d, eps, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm<vitax::kBias>(xnb, wqkvb, static_cast<const float*>(bqkv),
                                       qkvb, n, w, d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm_nt<vitax::kStore>(dob, static_cast<const bf16*>(wo), dattnb,
                                           nullptr, n, hhd, d, st);
  if (e != cudaSuccess) return e;

  // the core's grads -> dqkv, and the recomputed attn
  const vitax::AttnGeom f =
      vitax::attn_geom_square(qkvb, b, spq, seq_len, heads, head_dim, scale);
  const vitax::AttnBwdGeom g{f,     attnb, dattnb, dqkvb,          f.q_ld, dqkvb,
                             f.q_ld, f.k_off, f.v_off, static_cast<bf16*>(p),
                             static_cast<bf16*>(ds)};
  e = vitax::launch_flash_bwd_hd(g, head_dim, attnb, st);
  if (e != cudaSuccess) return e;

  // out-projection grads
  e = vitax::launch_gemm_tn(attnb, dob, static_cast<float*>(dwo), wsf, hhd, d, n, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_colsum(dob, static_cast<float*>(dbo), wsf, n, d, st);
  if (e != cudaSuccess) return e;

  // QKV projection grads and the LN tail
  e = vitax::launch_gemm_nt<vitax::kStoreF32>(dqkvb, wqkvb, nullptr, dxnf, n, d, w, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm_tn(xnb, dqkvb, static_cast<float*>(dwqkv), wsf, d, w, n, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_colsum(static_cast<const bf16*>(dqkvb), static_cast<float*>(dbqkv), wsf, n, w,
                           st);
  if (e != cudaSuccess) return e;
  return vitax::launch_layer_norm_bwd<bf16, float>(
      xb, static_cast<const float*>(gamma), dxnf, nullptr, static_cast<bf16*>(dx),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), wsf, n, d, eps, st);
}
