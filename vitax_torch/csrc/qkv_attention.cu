// K10, fused QKV attention forward: replaces _qkv_attn_fwd_kernel
// (vitax/ops/pallas_kernels.py:2216), the forward of fused_qkv_attention
// (:2369, pallas_call at :2307), which vitax's Res-ViT `attention` runs for
// fused_qkv without fused_qkvo (vitax/models/resvit.py:278).
//
//   qkv = bf16(x̂ @ Wqkv + bqkv)                          (:2220-2221)
//   per head: s = (q k^T) * 1/sqrt(hd), cols >= seq_len -> -1e30,
//             p = softmax_fp32(s), o = bf16(bf16(p) @ v)   (:2224-2237)
//   out = heads side by side, [B, spq, H·hd]
//
// x̂ is the LN output, [B, spq, D] with the padded-stream pad rows (zeros);
// there is no LN and no out-projection (the model applies Wo as a plain
// product). It is K1's first-design forward (which K7's branch of
// ln_qkvo_attention.cu still runs) without its first and last launches.
//
// Bound on the H100: at b64 spq 200 it does 2·N·D·3HHd + 4·B·H·spq²·hd ≈ 53
// GFLOP on 26 MB, so the tensor cores bound it (≈ 0.054 ms at 989 TFLOP/s
// bf16). Design: the QKV product is gemm.cuh's bf16 tensor-core GEMM with the
// fp32 bias added in its epilogue before the one rounding to bf16; the core is
// K1's whole-row attention core (attention.cuh): one block per (image, head,
// group of 16-row query tiles), K and V of the head in shared memory, each
// warp's whole fp32 score rows in shared memory, so the softmax is exact over
// the row and rounds where the TPU kernel rounds; the scores never reach
// device memory. qkv does (one bf16 [N, 3HHd] round trip): the TPU kernel
// keeps an image's qkv in VMEM, which a Hopper block cannot hold beside the
// scores. The core writes the kernel's output directly.
#include "attention.cuh"
#include "gemm.cuh"

// x̂ [b·spq, d] bf16, wqkv [d, 3·heads·hd] bf16, bqkv [3·heads·hd] fp32 ->
// out [b·spq, heads·hd] bf16; qkv [b·spq, 3·heads·hd] bf16 scratch.
extern "C" int vitax_qkv_attention_fwd(const void* x, const void* wqkv, const void* bqkv,
                                       void* qkv, void* out, int b, int spq, int d, int seq_len,
                                       int heads, int head_dim, float scale, void* stream) {
  using vitax::bf16;
  const auto st = static_cast<cudaStream_t>(stream);
  const int n = b * spq;
  auto* qkvb = static_cast<bf16*>(qkv);
  cudaError_t e = vitax::launch_gemm<vitax::kBias>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), qkvb, n, 3 * heads * head_dim, d, st);
  if (e != cudaSuccess) return e;
  return vitax::launch_attention_core_geom(
      vitax::attn_geom_square(qkvb, b, spq, seq_len, heads, head_dim, scale), head_dim,
      static_cast<bf16*>(out), st);
}
