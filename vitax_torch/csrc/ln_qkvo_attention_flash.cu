// K6, the KV-chunked fused LN-QKVO attention forward: replaces
// _ln_qkvo_fwd_flash_kernel (vitax/ops/pallas_kernels.py:3419), the body of
// fused_ln_qkvo_attention_flash (:3549, pallas_call at :3570), which vitax's
// model takes where K1's gate rejects (d > 1024: ViT-H/14, and ViT-L/16 at
// 384 px).
//
//   xn   = bf16(LN1(x))                                   (:3426-3432)
//   qkv  = bf16(xn @ Wqkv + bqkv)                         (:3433-3434)
//   per head: the online softmax over key chunks, p = exp(s − m_new)
//             rounded to bf16 unnormalised, acc = acc·α + bf16(p)·v,
//             out = bf16(acc / l)                (_flash_head_fwd :3391-3416)
//   out  = bf16(attn @ Wo + bo)                            (:3442-3443)
//
// x is [B, spq, D] with the padded-stream pad rows; the residual is not
// added (the caller adds it in bf16).
//
// Bound on the H100: the two projections are tensor-core bound
// (8·N·D·H·Hd operations, N = B·spq rows); the core adds 4·spq²·Hd a head
// (at ViT-H/14 @384, spq 736, a sixth of the projections'). The TPU kernel
// chunked the keys because its whole-row probabilities overflowed VMEM; the
// online core never holds more than a 64-key tile of them either. Four
// launches, K1's forward's order (ln_qkvo_attention.cu):
//   1. LN1 (layernorm.cuh), bf16 xn;
//   2. qkv = bf16(xn·Wqkv + bqkv) on gemm_sm90.cuh (wgmma m64n128k16 fed by
//      a producer warp's TMA loads, kEpiBias): the call K6's backward makes
//      for its recompute, so the two give the same qkv bits;
//   3. the online core (attention_core.cuh, kRowsOnline) with strided
//      operands: q, k, v the column blocks 0, hhd, 2·hhd of the packed rows
//      (row stride 3·hhd), the head outputs into attn (row stride hhd),
//      query rows to spq (the pad rows computed, as vitax computes them) and
//      keys masked at seq_len; one walk over 64-key tiles, a block two
//      warpgroups of 64 query rows sharing a cp.async ring of K and V
//      tiles, the scores, p and the fp32 output in registers, at vitax's
//      rounding points: p rounded unnormalised, the output divided by l
//      once at the end (as 1/l times it). Its tiles are 64 keys where
//      vitax's chunks are spq / _flash_chunks(spq) (88 at spq 264, 184 at
//      736), so the running max that p is rounded against moves at other
//      keys: the same function, inside the bf16 band of the twin;
//   4. out = bf16(attn·Wo + bo) on gemm_sm90.cuh (kEpiBias).
// The scores never reach device memory; xn, qkv and attn do (scratch). The
// TMA's zero fill masks the products' ragged edges on the way in and their
// epilogues mask the stores.
#include "attention_core.cuh"
#include "gemm_sm90.cuh"
#include "layernorm.cuh"

extern "C" int vitax_ln_qkvo_attention_flash_fwd(const void* x, const void* gamma,
                                                 const void* beta, const void* wqkv,
                                                 const void* bqkv, const void* wo, const void* bo,
                                                 void* xn, void* qkv, void* attn, void* out, int b,
                                                 int spq, int d, int seq_len, int heads,
                                                 int head_dim, float eps, float scale,
                                                 void* stream) {
  using vitax::bf16;
  namespace sm90 = vitax::sm90;
  namespace k13 = vitax::k13;
  const auto st = static_cast<cudaStream_t>(stream);
  const int n = b * spq;
  const int hhd = heads * head_dim;
  auto* xnb = static_cast<bf16*>(xn);
  auto* qkvb = static_cast<bf16*>(qkv);
  auto* attnb = static_cast<bf16*>(attn);
  if (b > 65535 || seq_len <= 0 || seq_len > spq) return cudaErrorInvalidValue;
  cudaError_t e = vitax::launch_layer_norm(static_cast<const bf16*>(x),
                                           static_cast<const float*>(gamma),
                                           static_cast<const float*>(beta), xnb, n, d, eps, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_nn<sm90::kEpiBias>(xnb, static_cast<const bf16*>(wqkv),
                                    static_cast<const float*>(bqkv), qkvb, nullptr, n, 3 * hhd,
                                    d, st);
  if (e != cudaSuccess) return e;
  k13::CoreArgs a{};
  a.q = qkvb, a.k = qkvb + hhd, a.v = qkvb + 2 * hhd, a.o = attnb;
  a.seq = seq_len, a.rows = a.kv_rows = spq, a.img_rows = a.kv_img_rows = spq, a.heads = heads;
  a.kv_heads = heads;
  a.scale = scale;
  a.ld_q = a.ld_k = a.ld_v = 3 * hhd;
  a.ld_o = hhd;
  e = k13::launch_core_online<k13::kRowsOnline>(a, head_dim, b, st);
  if (e != cudaSuccess) return e;
  return sm90::gemm_nn<sm90::kEpiBias>(attnb, static_cast<const bf16*>(wo),
                                       static_cast<const float*>(bo), static_cast<bf16*>(out),
                                       nullptr, n, d, hhd, st);
}

// K6's online core alone, for the card checks (cuda_kernels.flash_online_core;
// no path of the port calls it): qkv [b·spq, 3·hhd] bf16 → attn [b·spq, hhd]
// (kRowsOnline); with dattn [b·spq, hhd] not null, the backward's row pass
// (kRowsOnlineStats), which also writes stats fp32 [b, heads, 3, seq_pad]
// (vitax_attention_core_bwd_ws(b, spq, heads)).
extern "C" int vitax_attention_online(const void* qkv, const void* dattn, void* attn, void* stats,
                                      int b, int spq, int seq_len, int heads, int head_dim,
                                      float scale, void* stream) {
  using vitax::bf16;
  namespace k13 = vitax::k13;
  if (b > 65535 || seq_len <= 0 || seq_len > spq) return cudaErrorInvalidValue;
  const int hhd = heads * head_dim;
  const auto* qkvb = static_cast<const bf16*>(qkv);
  k13::CoreArgs a{};
  a.q = qkvb, a.k = qkvb + hhd, a.v = qkvb + 2 * hhd;
  a.o = static_cast<bf16*>(attn), a.dout = static_cast<const bf16*>(dattn);
  a.stats = static_cast<float*>(stats);
  a.seq = seq_len, a.rows = a.kv_rows = spq, a.img_rows = a.kv_img_rows = spq, a.heads = heads;
  a.kv_heads = heads;
  a.seq_pad = (spq + k13::kRows - 1) / k13::kRows * k13::kRows;
  a.scale = scale;
  a.ld_q = a.ld_k = a.ld_v = 3 * hhd;
  a.ld_o = a.ld_do = hhd;
  const auto st = static_cast<cudaStream_t>(stream);
  return dattn ? k13::launch_core_online<k13::kRowsOnlineStats>(a, head_dim, b, st)
               : k13::launch_core_online<k13::kRowsOnline>(a, head_dim, b, st);
}
