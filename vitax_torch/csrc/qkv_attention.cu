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
// product). It is K9's forward without its last launch: the first two
// launches of qkvo_sm90.cuh's sequence (`qkv_core`), so on the same x̂ its
// head outputs are the ones K9 projects, to the bit.
//
// Bound on the H100: at b64 spq 200 it does 2·N·D·3HHd + 4·B·H·spq²·hd ≈ 53
// GFLOP on 26 MB, so the tensor cores bound it (≈ 0.054 ms at 989 TFLOP/s
// bf16). Design: qkv = bf16(x̂·Wqkv + bqkv) on gemm_sm90.cuh's TMA-fed wgmma
// product (kEpiBias: the fp32 bias added before the one rounding); K13's
// core (attention_core.cuh, kRowsFwd) on the packed rows with strided
// operands, query rows to spq (the pad rows computed as vitax computes
// them) and keys masked at seq_len: the row statistics m and l by exp2 in a
// first pass over the key tiles, then p = exp2(s·scale·log2e − m)·(1/l)
// rounded to bf16 once and P·V summed in fp32 registers, the head outputs
// rounded once and written straight into the kernel's output. qkv makes one
// bf16 round trip through device memory (the TPU kernel keeps an image's
// qkv in VMEM); the scores never leave the chip.
#include "qkvo_sm90.cuh"

// x̂ [b·spq, d] bf16, wqkv [d, 3·heads·hd] bf16, bqkv [3·heads·hd] fp32 ->
// out [b·spq, heads·hd] bf16; qkv [b·spq, 3·heads·hd] bf16 scratch.
extern "C" int vitax_qkv_attention_fwd(const void* x, const void* wqkv, const void* bqkv,
                                       void* qkv, void* out, int b, int spq, int d, int seq_len,
                                       int heads, int head_dim, float scale, void* stream) {
  using vitax::bf16;
  if (b * spq == 0 || !vitax::qkvo::shapes_ok(b, spq, seq_len)) return cudaErrorInvalidValue;
  return vitax::qkvo::qkv_core(static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
                               static_cast<const float*>(bqkv), static_cast<bf16*>(qkv),
                               static_cast<bf16*>(out), b, spq, d, seq_len, heads, head_dim,
                               scale, static_cast<cudaStream_t>(stream));
}
