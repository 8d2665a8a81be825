// K1, fused LN-QKVO attention forward: replaces _ln_qkvo_fwd_kernel
// (vitax/ops/pallas_kernels.py:2640), the bf16 branch of
// fused_ln_qkvo_attention (:3111, pallas_call at :3186).
//
//   xn   = bf16(LN1(x))                                   (:2646-2652)
//   qkv  = bf16(xn @ Wqkv + bqkv)                         (:2653-2654)
//   per head: s = (q k^T) * 1/sqrt(hd), cols >= seq_len -> -1e30,
//             p = bf16(softmax_fp32(s)), o = bf16(p @ v)  (:2662-2681)
//   attn = heads side by side, head-major columns         (:2682-2684)
//   out  = bf16(attn @ Wo + bo)                            (:2685-2686)
//
// x is [B, spq, D] with the padded-stream pad rows; the residual is not
// added (the caller adds it in bf16).
//
// Bound on the H100: the two projections are tensor-core bound (6·N·D·hhd
// and 2·N·hhd·D operations, N = B·spq rows); the attention core is small in
// flops (4·spq²·hd a head) and, at spq 200, bound by its bytes.
//
// kv_heads == heads (K1), the Hopper design, four launches:
//   1. LN1 (layernorm.cuh), bf16 xn;
//   2.-4. qkvo_sm90.cuh's forward on xn, the sequence K9 runs on its x̂:
//      qkv = bf16(xn·Wqkv + bqkv) on gemm_sm90.cuh (wgmma m64n128k16 fed by
//      a producer warp's TMA loads, kEpiBias), the very call K1's backward
//      makes for its recompute, so the two give the same qkv bits; the core
//      on K13's (attention_core.cuh, launch_core_fwd) with strided
//      operands: q, k, v the column blocks 0, hhd, 2·hhd of the packed rows
//      (row stride 3·hhd), the head outputs into attn (row stride hhd),
//      query rows to spq (the pad rows computed as vitax computes them,
//      :2670-2671) and keys masked at seq_len; p normalised in fp32 and
//      rounded to bf16 once before p·v, as _softmax_rows (:75-80);
//      out = bf16(attn·Wo + bo) on gemm_sm90.cuh (kEpiBias).
// The scores never reach device memory; xn, qkv and attn do (scratch). The
// TMA's zero fill masks the ragged edges on the way in and the epilogues
// mask their stores.
//
// kv_heads < heads (K7, GQA; the kv_heads branch of the same TPU kernel, its
// column offsets from _kv_off :2803) keeps the first design in a branch of
// its own, since K13's core has no walk over a kv group: gemm.cuh's WMMA
// products and attention.cuh's whole-row core. The packed row is [q (H·hd)
// | k (Hkv·hd) | v (Hkv·hd)], so the QKV GEMM writes (H + 2·Hkv)·hd columns
// and query head h reads K and V of group h·Hkv/H. Nothing is repeated in
// device memory: a block of the core (one per image, head and group of
// 16-row query tiles, each warp a tile) stages its group's K and V once
// into shared memory, zero-filled past spq, and keeps its tiles' whole fp32
// score rows there, so the softmax is exact over the full row (no online
// rescaling); scores and P·V on WMMA bf16 tiles; the host picks the warps a
// block holds from the shared memory it needs (4 at spq 200, 1 at spq 584).
#include "attention.cuh"
#include "layernorm.cuh"
#include "qkvo_sm90.cuh"

extern "C" int vitax_ln_qkvo_attention_fwd(const void* x, const void* gamma, const void* beta,
                                           const void* wqkv, const void* bqkv, const void* wo,
                                           const void* bo, void* xn, void* qkv, void* attn,
                                           void* out, int b, int spq, int d, int seq_len,
                                           int heads, int kv_heads, int head_dim, float eps,
                                           float scale, void* stream) {
  using vitax::bf16;
  const auto st = static_cast<cudaStream_t>(stream);
  const int n = b * spq;
  const int hhd = heads * head_dim;
  const int width = (heads + 2 * kv_heads) * head_dim;  // the packed qkv row
  const auto* wqkvb = static_cast<const bf16*>(wqkv);
  const auto* wob = static_cast<const bf16*>(wo);
  const auto* bqkvf = static_cast<const float*>(bqkv);
  const auto* bof = static_cast<const float*>(bo);
  auto* xnb = static_cast<bf16*>(xn);
  auto* qkvb = static_cast<bf16*>(qkv);
  auto* attnb = static_cast<bf16*>(attn);
  auto* outb = static_cast<bf16*>(out);
  const bool mha = kv_heads == heads;
  if (mha && !vitax::qkvo::shapes_ok(b, spq, seq_len)) return cudaErrorInvalidValue;
  cudaError_t e = vitax::launch_layer_norm(static_cast<const bf16*>(x),
                                           static_cast<const float*>(gamma),
                                           static_cast<const float*>(beta), xnb, n, d, eps, st);
  if (e != cudaSuccess) return e;
  if (mha)
    return vitax::qkvo::fwd(xnb, wqkvb, bqkvf, wob, bof, qkvb, attnb, outb, b, spq, d, seq_len,
                            heads, head_dim, scale, st);
  e = vitax::launch_gemm<vitax::kBias>(xnb, wqkvb, bqkvf, qkvb, n, width, d, st);
  if (e != cudaSuccess) return e;
  const vitax::AttnGeom g{qkvb, static_cast<size_t>(width), spq, qkvb,
                          static_cast<size_t>(width), spq, hhd, hhd + kv_heads * head_dim,
                          heads, kv_heads, b, seq_len, scale};
  e = vitax::launch_attention_core_geom(g, head_dim, attnb, st);
  if (e != cudaSuccess) return e;
  return vitax::launch_gemm<vitax::kBias>(attnb, wob, bof, outb, n, d, hhd, st);
}
