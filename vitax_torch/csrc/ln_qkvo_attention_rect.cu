// K8, the rect (compacted-Q) fused attention half, forward: replaces
// _ln_qkvo_rect_fwd_kernel (vitax/ops/pallas_kernels.py:4033), the bf16
// branch of fused_ln_qkvo_attention_rect (:4410, pallas_call at :4463). Res-ViT's
// token compaction (models/resvit.py: compact_routed_block) keeps cap tokens a
// layer; a dropped token's attention output is discarded, only its K and V
// count. So Q, the core's query rows and the out-projection run on the cpq
// gathered rows xc, while K and V come from all spq rows x:
//
//   xnc = bf16(LN(xc)), xn = bf16(LN(x))                  (:4045-4052)
//   q   = bf16(xnc @ Wqkv[:, :H·hd] + bq)                  (:4054-4055)
//   kv  = bf16(xn  @ Wqkv[:, H·hd:] + bkv)                 (:4056-4057)
//   per head: s = (q k^T) / sqrt(hd) over the spq keys, cols >= seq_len
//             masked, p = bf16(softmax_fp32(s)), o = bf16(p @ v)
//   out = bf16(attn @ Wo + bo)   [B, cpq, D], no residual  (:4063-4065)
//
// xc's pad rows (cpq - cap) are zero-filled by the caller: LN of a zero row is
// β, finite, and the caller cuts those rows off. Every row's result depends
// only on its own row and the image's K and V, so the output rows equal K1's
// for the same tokens, bit for bit (the TPU kernel states it, :3944-3946).
//
// Bound on the H100: at b64, cpq 128 of spq 200, the work is ~0.8 of K1's
// (the KV projection over all rows does not shrink): the projections on the
// tensor cores and the core as K1's. Design: K1's launches with two changes.
// The TPU splits Wqkv into Wq and Wkv outside its kernel only because Mosaic
// could not slice lanes (:4036-4038); here the Q and KV GEMMs read column
// slices of the one merged Wqkv by offset and row stride (gemm.cuh's ldb),
// with no copy. The core is attention.cuh's, in its rect geometry: query rows
// from q [b·cpq, H·hd], K and V staged from kv [b·spq, 2·H·hd], the shared
// memory of the spq keys, so it takes the shapes K1's gate takes at spq. Six
// launches on one stream: two LNs, two projections, the core, the out GEMM;
// xnc, xn, q, kv and attn go through device memory.
#include "attention.cuh"
#include "gemm.cuh"
#include "layernorm.cuh"

// Inputs xc bf16 [b·cpq, d], x bf16 [b·spq, d], gamma, beta fp32 [d], wqkv bf16
// [d, 3hhd], bqkv fp32 [3hhd], wo bf16 [hhd, d], bo fp32 [d]; output out bf16
// [b·cpq, d]. Scratch: xnc bf16 [b·cpq, d], xn bf16 [b·spq, d], q bf16
// [b·cpq, hhd], kv bf16 [b·spq, 2hhd], attn bf16 [b·cpq, hhd].
extern "C" int vitax_ln_qkvo_attention_rect_fwd(
    const void* xc, const void* x, const void* gamma, const void* beta, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, void* xnc, void* xn, void* q, void* kv,
    void* attn, void* out, int b, int cpq, int spq, int d, int seq_len, int heads, int head_dim,
    float eps, float scale, void* stream) {
  using vitax::bf16;
  const auto st = static_cast<cudaStream_t>(stream);
  const int nc = b * cpq;
  const int n = b * spq;
  const int hhd = heads * head_dim;
  const auto* g = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  const auto* w = static_cast<const bf16*>(wqkv);
  const auto* bias = static_cast<const float*>(bqkv);
  auto* xncb = static_cast<bf16*>(xnc);
  auto* xnb = static_cast<bf16*>(xn);
  auto* qb = static_cast<bf16*>(q);
  auto* kvb = static_cast<bf16*>(kv);
  auto* attnb = static_cast<bf16*>(attn);
  cudaError_t e =
      vitax::launch_layer_norm(static_cast<const bf16*>(xc), g, be, xncb, nc, d, eps, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_layer_norm(static_cast<const bf16*>(x), g, be, xnb, n, d, eps, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm<vitax::kBias>(xncb, w, bias, qb, nc, hhd, d, st, 3 * hhd);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm<vitax::kBias>(xnb, w + hhd, bias + hhd, kvb, n, 2 * hhd, d, st, 3 * hhd);
  if (e != cudaSuccess) return e;
  const vitax::AttnGeom geom{qb,  static_cast<size_t>(hhd), cpq,   kvb, 2 * static_cast<size_t>(hhd),
                             spq, 0,                         hhd,   heads, heads,
                             b,   seq_len,                   scale};
  e = vitax::launch_attention_core_geom(geom, head_dim, attnb, st);
  if (e != cudaSuccess) return e;
  return vitax::launch_gemm<vitax::kBias>(attnb, static_cast<const bf16*>(wo),
                                          static_cast<const float*>(bo),
                                          static_cast<bf16*>(out), nc, d, hhd, st);
}
