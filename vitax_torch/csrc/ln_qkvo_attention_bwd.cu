// K1 backward, fused LN-QKVO attention: replaces _ln_qkvo_bwd_kernel
// (vitax/ops/pallas_kernels.py:2898), the bf16 branch of _fused_ln_qkvo_bwd
// (:3232, pallas_call at :3300), with _attn_core_recompute (:2814) and
// _attn_core_grads (:2846); with kv_heads < heads its `kv_heads` branch (K7's
// backward, GQA: the packed [q | k | v] row of (H + 2·Hkv)·hd columns).
//
//   recompute: xn = bf16(LN1(x)), qkv = bf16(xn Wqkv + bqkv), attn (K1's core)
//   dattn = bf16(do Wo^T), dWo = attn^T do, dbo = Σ do          (:2933-2938)
//   per (image, head), O the bf16 head output, P fp32 softmax:
//     dp = dO V^T, dd = rowsum(fp32(dO) fp32(O)), ds = bf16(P (dp - dd))
//     dq = bf16((ds K) scale), dk = bf16((ds^T Q) scale), dv = bf16(bf16(P)^T dO)
//                                                                  (:2856-2892)
//   dxn = dqkv Wqkv^T (fp32), dWqkv = xn^T dqkv, dbqkv = Σ fp32(dqkv)
//   LN tail: dx = bf16(rstd (dxn γ - mean(dxn γ) - x̂ mean(dxn γ x̂))), dγ, dβ
//                                                                  (:2943-2956)
// Weight and vector grads come out in fp32, as the TPU kernel's outputs.
//
// Bound on the H100: the operations of the products at the ViT shapes
// (qkv recompute, do·Woᵀ, attnᵀ·do, dqkv·Wqkvᵀ, xnᵀ·dqkv: 8.3e10 at b32 spq
// 200; the core's products add about a tenth). The TPU
// kernel carries dW, db, dγ, dβ across its sequential grid in VMEM; here
// every weight grad is one kTN product over all N rows (split K,
// deterministic second pass) and every vector grad a two-pass column sum
// (colsum.cuh). Nothing uses float atomics.
//
// kv_heads == heads (vitax_ln_qkvo_attention_bwd), the Hopper design: the
// LN recompute, qkvo_sm90.cuh's backward on xn (the sequence K9's backward
// runs on its x̂, with dxn in fp32 here for the LN tail), the LN tail. Its
// five products are on gemm_sm90.cuh (wgmma m64n128k16 fed by a producer
// warp's TMA loads, 128×128 tiles in two warpgroups), and the attention
// core on K13's (attention_core.cuh) with strided operands: its forward
// recomputes attn from the packed qkv rows (query rows to spq, keys masked
// at seq_len), and its three backward passes (a row pass writing
// m·scale·log2e, 1/l and dd, 12 bytes a row, to `stats`; a key pass for dk,
// dv; a query pass for dq) write straight into dqkv's packed columns.
// Neither P nor ds reaches device memory; the query rows seq_len..spq are
// computed as vitax computes them, and their dk, dv rows are 0.
//
// kv_heads < heads (vitax_ln_qkvo_attention_gqa_bwd, K7's backward) keeps
// the first design: gemm.cuh's WMMA products and the whole-row core, whose
// backward keeps the TPU's rounding points exactly and fits shared memory
// by splitting by query tiles and then by key tiles, with bf16 P and ds of
// each (image, head) in device memory between the two (2·B·H·L² bf16, 66 MB
// at b32 spq 200):
//   pass 1 (query tiles, like the forward core): K and V of the head in
//     shared memory; each warp owns 16 query rows, recomputes their whole
//     fp32 score rows and softmax, forms dp one 16x16 key tile at a time and
//     ds from it, writes bf16 P and ds rows, and dq = ds K;
//   pass 2 (key tiles): each warp owns 16 key rows and walks all query
//     chunks, accumulating dk = ds^T Q and dv = P^T dO in WMMA fragments.
// K/V columns >= seq_len are masked, so their P and ds are exactly 0, and the
// pad query rows >= spq write zeros. Its gate is its own shared memory
// (attn_bwd_smem_bytes, mirrored by cuda_kernels.attention_bwd_smem_bytes):
// 4 warps a block at spq 200, 1 at spq 584.
//
// GQA (K7): the recompute and the query-tile pass read K and V of group
// h·Hkv/H for query head h, as K7's forward; the key-tile pass runs one block
// per (key tiles, kv group) and walks the group's H/Hkv query heads in head
// order inside one set of fp32 accumulators, so dK and dV of a group are one
// fp32 sum over its heads, cast once (vitax's :2884-2894), with one owner per
// row: no atomics, the same bits each run. The projections shrink with the K
// and V columns; the core's work does not.
#include "attention_bwd.cuh"
#include "gemm.cuh"
#include "layernorm.cuh"
#include "qkvo_sm90.cuh"

// fp32 workspace of either backward over n rows, qkv width w ((H + 2·Hkv)·hd)
// (also K6's backward's).
extern "C" long long vitax_ln_qkvo_attention_bwd_ws(int n, int d, int hhd, int w) {
  using namespace vitax;
  const size_t ln = layer_norm_bwd_workspace(n, d);
  const size_t rest = qkvo::bwd_workspace(n, d, hhd, w);
  return static_cast<long long>(ln > rest ? ln : rest);
}

// kv_heads == heads. Outputs dx (bf16 [n, d]) and fp32 dgamma, dbeta [d],
// dwqkv [d, w], dbqkv [w], dwo [hhd, d], dbo [d], w = 3·heads·head_dim.
// Scratch (bf16 unless noted): xn [n,d], qkv [n,w], attn and dattn [n,hhd],
// stats fp32 vitax_attention_core_bwd_ws(b, spq, heads), dqkv [n,w], dxn
// fp32 [n,d], ws fp32 vitax_ln_qkvo_attention_bwd_ws(n, d, hhd, w).
extern "C" int vitax_ln_qkvo_attention_bwd(
    const void* x, const void* gamma, const void* beta, const void* wqkv, const void* bqkv,
    const void* wo, const void* dout, void* dx, void* dgamma, void* dbeta, void* dwqkv,
    void* dbqkv, void* dwo, void* dbo, void* xn, void* qkv, void* attn, void* dattn, void* stats,
    void* dqkv, void* dxn, void* ws, int b, int spq, int d, int seq_len, int heads, int head_dim,
    float eps, float scale, void* stream) {
  using vitax::bf16;
  const auto st = static_cast<cudaStream_t>(stream);
  const int n = b * spq;
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
  if (n == 0 || !vitax::qkvo::shapes_ok(b, spq, seq_len)) return cudaErrorInvalidValue;

  // recompute LN1, then qkvo_sm90.cuh's backward on xn (the recompute of
  // qkv and attn, the out-projection's grads, K13's three passes, dxn in
  // fp32, dWqkv, dbqkv), then the LN tail
  cudaError_t e = vitax::launch_layer_norm(xb, static_cast<const float*>(gamma),
                                           static_cast<const float*>(beta), xnb, n, d, eps, st);
  if (e != cudaSuccess) return e;
  e = vitax::qkvo::bwd(xnb, wqkvb, static_cast<const float*>(bqkv), static_cast<const bf16*>(wo),
                       dob, nullptr, dxnf, static_cast<float*>(dwqkv),
                       static_cast<float*>(dbqkv), static_cast<float*>(dwo),
                       static_cast<float*>(dbo), qkvb, attnb, dattnb, static_cast<float*>(stats),
                       dqkvb, wsf, b, spq, d, seq_len, heads, head_dim, scale, st);
  if (e != cudaSuccess) return e;
  return vitax::launch_layer_norm_bwd<bf16, float>(
      xb, static_cast<const float*>(gamma), dxnf, nullptr, static_cast<bf16*>(dx),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), wsf, n, d, eps, st);
}

// kv_heads < heads (K7's backward; any kv_heads dividing heads). Outputs as
// vitax_ln_qkvo_attention_bwd's, w = (heads + 2 kv_heads) head_dim. Scratch
// (bf16 unless noted): xn [n,d], qkv [n,w], attn and dattn [n,hhd], p and ds
// [b,heads,L,L] with L = round_up(spq, 16), dqkv [n,w], dxn fp32 [n,d], ws fp32
// vitax_ln_qkvo_attention_bwd_ws(n, d, hhd, w).
extern "C" int vitax_ln_qkvo_attention_gqa_bwd(
    const void* x, const void* gamma, const void* beta, const void* wqkv, const void* bqkv,
    const void* wo, const void* dout, void* dx, void* dgamma, void* dbeta, void* dwqkv,
    void* dbqkv, void* dwo, void* dbo, void* xn, void* qkv, void* attn, void* dattn, void* p,
    void* ds, void* dqkv, void* dxn, void* ws, int b, int spq, int d, int seq_len, int heads,
    int kv_heads, int head_dim, float eps, float scale, void* stream) {
  using vitax::bf16;
  const auto st = static_cast<cudaStream_t>(stream);
  const int n = b * spq;
  const int hhd = heads * head_dim;
  const int w = (heads + 2 * kv_heads) * head_dim;
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
  if (n == 0 || kv_heads <= 0 || heads % kv_heads) return cudaErrorInvalidValue;

  // recompute LN1, qkv and the attention core
  cudaError_t e = vitax::launch_layer_norm(xb, static_cast<const float*>(gamma),
                                           static_cast<const float*>(beta), xnb, n, d, eps, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm<vitax::kBias>(xnb, wqkvb, static_cast<const float*>(bqkv),
                                       qkvb, n, w, d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_attention_core_geom(
      vitax::attn_geom_packed(qkvb, b, spq, seq_len, heads, kv_heads, head_dim, scale), head_dim,
      attnb, st);
  if (e != cudaSuccess) return e;

  // out-projection grads
  e = vitax::launch_gemm_nt<vitax::kStore>(dob, static_cast<const bf16*>(wo), dattnb,
                                           nullptr, n, hhd, d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm_tn(attnb, dob, static_cast<float*>(dwo), wsf, hhd, d, n, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_colsum(dob, static_cast<float*>(dbo), wsf, n, d, st);
  if (e != cudaSuccess) return e;

  // attention-core grads -> dqkv
  e = vitax::launch_attention_bwd_packed(qkvb, attnb, dattnb, static_cast<bf16*>(p),
                                         static_cast<bf16*>(ds), dqkvb, b, spq, seq_len, heads,
                                         kv_heads, head_dim, scale, st);
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
