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
// Bound on the H100: at b64, cpq 128 of spq 200, the tensor cores (0.055
// ms): ~0.8 of K1's work, since the KV projection over all rows does not
// shrink; the core is 4·cpq·spq·hd a head.
//
// The Hopper design: K1's forward sequence (ln_qkvo_attention.cu,
// kv_heads == heads) on K8's two row sets, six launches on one stream:
//   1-2. LN of xc and of x (layernorm.cuh), bf16 xnc and xn;
//   3. q = bf16(xnc·Wq + bq) on gemm_sm90.cuh (kEpiBias), Wq the first hhd
//      columns of Wqkv read in place by row stride 3·hhd;
//   4. kv = bf16(xn·Wkv + bkv) likewise over the columns [hhd, 3·hhd): the
//      TPU splits Wqkv outside its kernel only because Mosaic could not
//      slice lanes (:4036-4038); no weight is copied here;
//   5. K13's forward core (attention_core.cuh, launch_core_fwd) in its rect
//      geometry: the cpq query rows of q (row stride hhd) against the spq
//      key rows of kv (K columns, then V; row stride 2·hhd), keys masked at
//      seq_len, p normalised in fp32 and rounded to bf16 once before p·v,
//      the head outputs into attn in bf16;
//   6. out = bf16(attn·Wo + bo) on gemm_sm90.cuh (kEpiBias).
// Every launch is per row (LN, the products' epilogues over the same K
// order and column tiles, K13's row statistics and p·v), and each is K1's
// own call, so a kept row's out equals K1's forward on x followed by the
// row gather, bit for bit. xnc, xn, q, kv and attn go through device
// memory (scratch); the scores never do.
#include "gemm_sm90.cuh"
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
  namespace sm90 = vitax::sm90;
  const auto st = static_cast<cudaStream_t>(stream);
  const int nc = b * cpq;
  const int n = b * spq;
  const int hhd = heads * head_dim;
  if (nc == 0) return cudaSuccess;
  if (b > 65535 || seq_len <= 0 || seq_len > spq) return cudaErrorInvalidValue;
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
  e = sm90::gemm_nn<sm90::kEpiBias>(xncb, w, bias, qb, nullptr, nc, hhd, d, st, nullptr, nullptr,
                                    3 * hhd);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_nn<sm90::kEpiBias>(xnb, w + hhd, bias + hhd, kvb, nullptr, n, 2 * hhd, d, st,
                                    nullptr, nullptr, 3 * hhd);
  if (e != cudaSuccess) return e;
  vitax::k13::CoreArgs a{};
  a.q = qb, a.k = kvb, a.v = kvb + hhd, a.o = attnb;
  a.seq = seq_len, a.rows = a.img_rows = cpq, a.kv_rows = a.kv_img_rows = spq, a.heads = heads;
  a.kv_heads = heads;
  a.scale = scale;
  a.ld_q = a.ld_o = hhd;
  a.ld_k = a.ld_v = 2 * hhd;
  e = vitax::k13::launch_core_fwd(a, head_dim, b, st);
  if (e != cudaSuccess) return e;
  return sm90::gemm_nn<sm90::kEpiBias>(attnb, static_cast<const bf16*>(wo),
                                       static_cast<const float*>(bo), static_cast<bf16*>(out),
                                       nullptr, nc, d, hhd, st);
}
