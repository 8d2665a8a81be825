// K6, the KV-chunked fused LN-QKVO attention forward: replaces
// _ln_qkvo_fwd_flash_kernel (vitax/ops/pallas_kernels.py:3419), the body of
// fused_ln_qkvo_attention_flash (:3549, pallas_call at :3570), which vitax's
// model takes where K1's gate rejects (d > 1024: ViT-H/14).
//
//   xn   = bf16(LN1(x))                                   (:3426-3432)
//   qkv  = bf16(xn @ Wqkv + bqkv)                         (:3433-3434)
//   per head: the online softmax over key tiles, out = acc / l, bf16
//             (_flash_head_fwd :3391-3416; attention_flash.cuh)
//   out  = bf16(attn @ Wo + bo)                            (:3442-3443)
//
// x is [B, spq, D] with the padded-stream pad rows; the residual is not
// added (the caller adds it in bf16).
//
// Bound on the H100: the two projections are tensor-core bound (gemm.cuh,
// 8·N·D·H·Hd flops); the core adds 4·spq²·Hd a head. The TPU kernel needed
// the KV chunks because its whole-row probabilities overflowed VMEM; on
// Hopper the whole-row core of K1 (attention.cuh) overflows a block's shared
// memory too: at h14@384 (spq 736, hd 80) K and V alone are 235,520 B
// against the 232,448 B a block may use. So the core walks 64-key tiles with
// the online softmax and keeps only a tile of K and V, and each warp's
// [16, 64] scores, in shared memory: 76 KB a block at hd 80, whatever spq
// is. xn, qkv and attn go through device memory (the multi-launch form of
// this first version, as K1's).
#include "attention_flash.cuh"
#include "gemm.cuh"
#include "layernorm.cuh"

extern "C" int vitax_ln_qkvo_attention_flash_fwd(const void* x, const void* gamma,
                                                 const void* beta, const void* wqkv,
                                                 const void* bqkv, const void* wo, const void* bo,
                                                 void* xn, void* qkv, void* attn, void* out, int b,
                                                 int spq, int d, int seq_len, int heads,
                                                 int head_dim, float eps, float scale,
                                                 void* stream) {
  using vitax::bf16;
  const auto st = static_cast<cudaStream_t>(stream);
  const int n = b * spq;
  const int hhd = heads * head_dim;
  auto* xnb = static_cast<bf16*>(xn);
  auto* qkvb = static_cast<bf16*>(qkv);
  auto* attnb = static_cast<bf16*>(attn);
  cudaError_t e = vitax::launch_layer_norm(static_cast<const bf16*>(x),
                                           static_cast<const float*>(gamma),
                                           static_cast<const float*>(beta), xnb, n, d, eps, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm<vitax::kBias>(xnb, static_cast<const bf16*>(wqkv),
                                       static_cast<const float*>(bqkv), qkvb, n,
                                       3 * hhd, d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_flash_fwd_hd(
      vitax::attn_geom_square(qkvb, b, spq, seq_len, heads, head_dim, scale), head_dim, attnb,
      st);
  if (e != cudaSuccess) return e;
  return vitax::launch_gemm<vitax::kBias>(attnb, static_cast<const bf16*>(wo),
                                          static_cast<const float*>(bo),
                                          static_cast<bf16*>(out), n, d, hhd, st);
}
