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
// no LN and no residual. It is K1's forward without its first launch: the
// three launches of qkvo_sm90.cuh's forward, which K1 runs after its LN, so
// K9 on x̂ = LN(x) gives K1's output to the bit.
//
// Bound on the H100: at b64 spq 200 it does 2·N·D·3HHd + 4·B·H·spq²·hd +
// 2·N·HHd·D ≈ 68 GFLOP on 26 MB, so the tensor cores bound it (≈ 0.069 ms at
// 989 TFLOP/s bf16). Design (qkvo_sm90.cuh): qkv = bf16(x̂·Wqkv + bqkv) on
// gemm_sm90.cuh's TMA-fed wgmma product (kEpiBias: the fp32 bias added
// before the one rounding); K13's core (attention_core.cuh) on the packed
// rows with strided operands, query rows to spq and keys masked at seq_len,
// p normalised in fp32 and rounded to bf16 once before p·v; out =
// bf16(attn·Wo + bo) on kEpiBias. qkv and attn make one bf16 round trip
// each through device memory (the TPU kernel keeps a grid step's images in
// VMEM, its `tile` of 2 or 4, which is TPU geometry and not copied); the
// scores never leave the chip.
#include "qkvo_sm90.cuh"

// x̂ [b·spq, d] bf16, wqkv [d, 3·heads·hd] bf16, bqkv [3·heads·hd] fp32, wo
// [heads·hd, d] bf16, bo [d] fp32 -> out [b·spq, d] bf16; qkv [b·spq,
// 3·heads·hd] and attn [b·spq, heads·hd] bf16 scratch.
extern "C" int vitax_qkvo_attention_fwd(const void* x, const void* wqkv, const void* bqkv,
                                        const void* wo, const void* bo, void* qkv, void* attn,
                                        void* out, int b, int spq, int d, int seq_len, int heads,
                                        int head_dim, float scale, void* stream) {
  using vitax::bf16;
  return vitax::qkvo::fwd(static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
                          static_cast<const float*>(bqkv), static_cast<const bf16*>(wo),
                          static_cast<const float*>(bo), static_cast<bf16*>(qkv),
                          static_cast<bf16*>(attn), static_cast<bf16*>(out), b, spq, d, seq_len,
                          heads, head_dim, scale, static_cast<cudaStream_t>(stream));
}
