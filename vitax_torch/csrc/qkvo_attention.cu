// K9, fused QKVO attention forward: replaces _qkvo_attn_fwd_kernel
// (vitax/ops/pallas_kernels.py:2396), the forward of fused_qkvo_attention
// (:2551, pallas_call at :2559), which vitax's Res-ViT `attention` runs under
// any mesh with fused_qkv and fused_qkvo (vitax/models/resvit.py:266-277: its
// _fused_attention_half declines for every mesh, :330-331), and per model
// shard under tensor parallelism (vitax/parallel/tp_kernels.py:75-103).
//
//   qkv = bf16(x̂ @ Wqkv + bqkv)                          (:2404-2405)
//   per head: s = (q k^T) * 1/sqrt(hd), cols >= seq_len -> -1e30,
//             p = softmax_fp32(s), o = bf16(bf16(p) @ v)   (:2408-2423)
//   attn = heads side by side, [B·spq, H·hd]              (:2424-2426)
//   out  = bf16(attn @ Wo + bo), bo added in fp32          (:2427-2428)
//
// x̂ is the LN output, [B, spq, D] with the padded pad rows (zeros); there is
// no LN and no residual. It is K10's forward (qkv_attention.cu) followed by
// an out-projection, so it is K1's first-design forward (which K7's branch of
// ln_qkvo_attention.cu still runs) without its first launch.
//
// Bound on the H100: at b64 spq 200 it does 2·N·D·3HHd + 4·B·H·spq²·hd +
// 2·N·HHd·D ≈ 68 GFLOP on 26 MB, so the tensor cores bound it (≈ 0.069 ms at
// 989 TFLOP/s bf16). Design: both projections are gemm.cuh's bf16
// tensor-core GEMM with the fp32 bias added in its epilogue before the one
// rounding to bf16; the core is K1's whole-row attention core (attention.cuh)
// with bf16 head outputs. qkv and attn make one bf16 round trip each through
// device memory (the TPU kernel keeps an image's in VMEM, which a Hopper block
// cannot hold beside the scores); the scores never leave the chip.
#include "attention.cuh"
#include "gemm.cuh"

// x̂ [b·spq, d] bf16, wqkv [d, 3·heads·hd] bf16, bqkv [3·heads·hd] fp32, wo
// [heads·hd, d] bf16, bo [d] fp32 -> out [b·spq, d] bf16; qkv [b·spq,
// 3·heads·hd] and attn [b·spq, heads·hd] bf16 scratch.
extern "C" int vitax_qkvo_attention_fwd(const void* x, const void* wqkv, const void* bqkv,
                                        const void* wo, const void* bo, void* qkv, void* attn,
                                        void* out, int b, int spq, int d, int seq_len, int heads,
                                        int head_dim, float scale, void* stream) {
  using vitax::bf16;
  const auto st = static_cast<cudaStream_t>(stream);
  const int n = b * spq;
  const int hhd = heads * head_dim;
  auto* qkvb = static_cast<bf16*>(qkv);
  auto* attnb = static_cast<bf16*>(attn);
  cudaError_t e = vitax::launch_gemm<vitax::kBias>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), qkvb, n, 3 * hhd, d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_attention_core_geom(
      vitax::attn_geom_square(qkvb, b, spq, seq_len, heads, head_dim, scale), head_dim, attnb,
      st);
  if (e != cudaSuccess) return e;
  return vitax::launch_gemm<vitax::kBias>(attnb, static_cast<const bf16*>(wo),
                                          static_cast<const float*>(bo),
                                          static_cast<bf16*>(out), n, d, hhd, st);
}
