// K5, the attention half of the int8 block handoff: replaces
// _ln_qkvo_fwd_int8_ho_kernel (vitax/ops/pallas_kernels.py:3669), called at
// :3784 by _qkvo_ho_fwd_call from fused_block_int8_handoff (:3863). It is K3's
// forward (ln_qkvo_attention_int8.cu) without its LN+quant prologue: it takes
// the packed LN1 output (xq, sx) that the previous block's MLP epilogue wrote,
// adds the residual in fp32 and packs LN2 of the result for the MLP half:
//
//   qkv    = bf16(f32(xq Wq) sx sw + bqkv)
//   per head: the bf16 core with fp32 softmax, attn = p·v in fp32
//   aq, sa = quant_rows(attn)
//   r1     = bf16(f32(x) + f32(aq Woq) sa swo + bo)     the handoff's rounding
//   xq2, sx2 = quant_rows(LN2(f32(r1)))                 fp32 statistics, codes
//                                                       from the fp32 LN output
//
// The first block of the encoder has no previous epilogue: with `pack` set,
// the first launch packs x itself with LN1's γ/β (vitax's pack_stream :3840,
// which runs in XLA), into xq/sx. vitax carries 8 broadcast scale lanes a row
// (_HO_SCALE_LANES); the port keeps one fp32 scale a row.
//
// Bound on the H100: the two s8 projections and the attention core on the
// tensor cores. Design of this first version: K3's launches (weight
// quantizers, s8 QKV GEMM, core, row quantizer, s8 out-projection, whose
// epilogue adds the residual in fp32: gemm.cuh kS8ResidualF32), then the LN +
// quant of r1 as a separate row pass (layernorm.cuh), which re-reads r1 from
// device memory (a row's LN spans all 6 output tiles of the GEMM).
#include "attention.cuh"
#include "gemm.cuh"
#include "layernorm.cuh"

// Inputs x bf16 [n, d] (n = b·spq), xq int8 [n, d] and sx fp32 [n] (written
// here when pack != 0), g1, be1 (read only when packing), g2, be2 fp32 [d],
// wqkv bf16 [d, 3hhd], bqkv [3hhd], wo bf16 [hhd, d], bo [d]. Outputs r1 bf16
// [n, d], xq2 int8 [n, d], sx2 fp32 [n]. Scratch: w8t int8 [3hhd, d], sw
// [3hhd], wo8t int8 [d, hhd], swo [d], qkv bf16 [n, 3hhd], attn fp32
// [n, hhd], aq int8 [n, hhd], sa [n].
extern "C" int vitax_ln_qkvo_attention_int8_ho_fwd(
    const void* x, void* xq, void* sx, const void* g1, const void* be1, const void* g2,
    const void* be2, const void* wqkv, const void* bqkv, const void* wo, const void* bo, void* w8t,
    void* sw, void* wo8t, void* swo, void* qkv, void* attn, void* aq, void* sa, void* r1,
    void* xq2, void* sx2, int b, int spq, int d, int seq_len, int heads, int head_dim, int pack,
    float eps, float scale, void* stream) {
  using vitax::bf16;
  const auto st = static_cast<cudaStream_t>(stream);
  const int n = b * spq;
  const int hhd = heads * head_dim;
  const auto* xb = static_cast<const bf16*>(x);
  auto* xqi = static_cast<int8_t*>(xq);
  auto* sxf = static_cast<float*>(sx);
  auto* qkvb = static_cast<bf16*>(qkv);
  auto* attnf = static_cast<float*>(attn);
  auto* aqi = static_cast<int8_t*>(aq);
  auto* saf = static_cast<float*>(sa);
  auto* r1b = static_cast<bf16*>(r1);
  if (n == 0) return cudaSuccess;
  cudaError_t e = vitax::launch_quant_weight_cols_t(static_cast<const bf16*>(wqkv),
                                                    static_cast<int8_t*>(w8t),
                                                    static_cast<float*>(sw), d, 3 * hhd, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_weight_cols_t(static_cast<const bf16*>(wo), static_cast<int8_t*>(wo8t),
                                        static_cast<float*>(swo), hhd, d, st);
  if (e != cudaSuccess) return e;
  if (pack) {
    e = vitax::launch_layer_norm_quant<false>(xb, static_cast<const float*>(g1),
                                              static_cast<const float*>(be1), xqi, sxf, nullptr,
                                              n, d, eps, st);
    if (e != cudaSuccess) return e;
  }
  e = vitax::launch_gemm_s8<vitax::kS8Bf16>(xqi, static_cast<const int8_t*>(w8t), sxf,
                                            static_cast<const float*>(sw),
                                            static_cast<const float*>(bqkv), nullptr, nullptr,
                                            qkvb, nullptr, n, 3 * hhd, d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_attention_core_hd(qkvb, attnf, b, spq, seq_len, heads, head_dim, scale, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_rows(static_cast<const float*>(attnf), aqi, saf, n, hhd, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm_s8<vitax::kS8ResidualF32>(
      aqi, static_cast<const int8_t*>(wo8t), saf, static_cast<const float*>(swo),
      static_cast<const float*>(bo), xb, nullptr, r1b, nullptr, n, d, hhd, st);
  if (e != cudaSuccess) return e;
  return vitax::launch_layer_norm_quant<false>(r1b, static_cast<const float*>(g2),
                                               static_cast<const float*>(be2),
                                               static_cast<int8_t*>(xq2),
                                               static_cast<float*>(sx2), nullptr, n, d, eps, st);
}
