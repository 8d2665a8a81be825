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
// Bound on the H100: the two projections are tensor-core bound (gemm.cuh).
// The attention core is small in flops (4*spq^2*hd per head) but, done
// naively, bound by re-reading K and V and by the [spq, spq] score matrix.
// Design of the core: one block per (image, head, group of query tiles); K
// and V of that head are staged once into shared memory, zero-filled past
// spq; each warp owns a 16-row query tile and keeps its whole fp32 score rows
// in shared memory, so the softmax is exact over the full row (no online
// rescaling) and matches the TPU's rounding points. Scores and P @ V run on
// the tensor cores (WMMA bf16, fp32 accumulate). At spq 584 a 64-row tile's
// scores plus K and V exceed the 227 KB a block may use, so the host picks the
// number of warps (query tiles) a block holds from the shared memory it needs:
// 4 at spq 200, 1 at spq 584. The scores never reach device memory; xn, qkv
// and attn do (the multi-launch form of this first version).
//
// K7, GQA (kv_heads < heads; the kv_heads branch of the same TPU kernel, its
// column offsets from _kv_off :2803): the packed row is [q (H·hd) | k (Hkv·hd)
// | v (Hkv·hd)], so the QKV GEMM writes (H + 2·Hkv)·hd columns and query head
// h reads K and V of group h·Hkv/H. Nothing is repeated in device memory: a
// block stages its group's K and V as the MHA core stages its head's, so the
// core's work and shared memory do not change; the QKV GEMM shrinks with the
// K and V columns (by a third at Hkv = H/4). kv_heads == heads is K1.
#include "attention.cuh"
#include "gemm.cuh"
#include "layernorm.cuh"

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
  auto* xnb = static_cast<bf16*>(xn);
  auto* qkvb = static_cast<bf16*>(qkv);
  auto* attnb = static_cast<bf16*>(attn);
  cudaError_t e = vitax::launch_layer_norm(static_cast<const bf16*>(x),
                                           static_cast<const float*>(gamma),
                                           static_cast<const float*>(beta), xnb, n, d, eps, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm<vitax::kBias>(xnb, static_cast<const bf16*>(wqkv),
                                       static_cast<const float*>(bqkv), nullptr, qkvb, n,
                                       width, d, st);
  if (e != cudaSuccess) return e;
  const vitax::AttnGeom g{qkvb, static_cast<size_t>(width), spq, qkvb,
                          static_cast<size_t>(width), spq, hhd, hhd + kv_heads * head_dim,
                          heads, kv_heads, b, seq_len, scale};
  e = vitax::launch_attention_core_geom(g, head_dim, attnb, st);
  if (e != cudaSuccess) return e;
  return vitax::launch_gemm<vitax::kBias>(attnb, static_cast<const bf16*>(wo),
                                          static_cast<const float*>(bo), nullptr,
                                          static_cast<bf16*>(out), n, d, hhd, st);
}
