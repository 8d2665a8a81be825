// K3, the W8A8 forward of the fused LN-QKVO attention half: replaces
// _ln_qkvo_fwd_int8_kernel (vitax/ops/pallas_kernels.py:2690), the int8
// branch of fused_ln_qkvo_attention (:3111, pallas_call at :3163). In the
// order of the Pallas body (:2699-2742):
//
//   xq, sx = quant_rows(LN1(x))                   from the fp32 LN output
//   qkv    = bf16(f32(xq Wq) sx sw + bqkv)        Wq per output column
//   per head: the bf16 core with fp32 softmax (K1's), attn = p·v in fp32,
//             never rounded to bf16
//   aq, sa = quant_rows(attn)
//   out    = bf16(f32(aq Woq) sa swo + bo)        no residual
//
// Wqkv and Wo are quantized per output column (sw, swo) by the first
// launches (quant.cuh), written as [N, K], gemm.cuh's s8 layout. x is
// [B, spq, D] with the padded stream's pad rows; pad keys are masked by
// seq_len.
//
// GQA (K7's int8 tier, the kv_heads branch of :2690 with _kv_off :2803):
// kv_heads < heads packs qkv as [q (H·hd) | k (Hkv·hd) | v (Hkv·hd)], width
// (H + 2·Hkv)·hd, and query head h reads kv group h·Hkv/H; the quantizer,
// the s8 QKV GEMM and qkv take that width, the core its geometry.
//
// Bound on the H100: the two s8 projections (2·N·D·W + 2·N·hhd·D
// operations at 1979 TOP/s) and the attention core (4·spq²·hd a head, bf16
// on the tensor cores).
//
// kv_heads == heads at L = 127, the Hopper design: K1's forward sequence
// (ln_qkvo_attention.cu) with the int8 tier's arithmetic, five launches on
// one stream after the weights' column codes (quant.cuh, as [N, K]):
//   1. the LN-quant prologue (layernorm.cuh, the row in registers): xq, sx;
//   2. qkv = bf16(dq(xq·W8ᵀ) + bqkv) on gemm_sm90.cuh's s8 wgmma path
//      (kEpiS8Bf16): the call K3's backward makes for its recompute
//      (ln_qkvo_attention_int8_bwd.cu), so the two give the same qkv bits;
//   3. K13's forward core (attention_core.cuh, kRowsFwdF32) on the packed
//      qkv rows with strided operands, as K1's forward lays them out: query
//      rows to spq, keys masked at seq_len, p = exp2(s·scale·log2e − m)·(1/l)
//      rounded to bf16 once, attn = p·v written in fp32, never rounded
//      (vitax :2731-2737);
//   4. the row quantizer over the fp32 attn (quant.cuh): a row spans all
//      heads, i.e. hhd/hd blocks of the core, so its amax cannot be taken
//      inside one;
//   5. out = bf16(dq(aq·Wo8ᵀ) + bo) on the s8 path (kEpiS8Bf16).
// xq, qkv, the fp32 attn and aq go through device memory where the TPU
// kernel keeps them in VMEM; the scores never do. K13's p differs from the
// twin's softmax in its last bits, so out moves within the int8 band.
//
// K11-C, the A4W4 forward (vitax_ln_qkvo_attention_int4_fwd): replaces
// _ln_qkvo_fwd_int4_kernel (:2745), the int4 branch of
// fused_ln_qkvo_attention (pallas_call at :3137). Its body (:2756-2798) is
// K3's with the two projections' quantizers on the int4 grid
// (_quant_rows4 of the fp32 LN output and of the fp32 attn,
// _quant_cols_host4 of Wqkv and Wo: limit 7, quant.cuh); the core stays
// bf16 with fp32 softmax. So it is the Hopper sequence above at L = 7,
// codes in int8 (the s8 wgmma path takes codes of any range), with and
// without kv_heads (G-F): with kv_heads < heads the packed width is (H +
// 2·Hkv)·hd and K13's core runs in its GQA geometry (CoreArgs::kv_heads,
// query head h reading k, v of group h·Hkv/H; attention_core.cuh's
// kRowsFwdF32 mode reads them by group as every mode does). Bound: K3's.
//
// K7's int8 tier (kv_heads < heads at L = 127) keeps the first design in a
// branch of its own: gemm.cuh's mma.sync s8 GEMM and attention.cuh's
// whole-row core (the same core as K7's bf16 forward, writing fp32 attn),
// five launches as above.
#include "attention.cuh"
#include "gemm.cuh"
#include "gemm_sm90.cuh"
#include "layernorm.cuh"

namespace {

// The Hopper design on the grid of limit L: K3 (L = 127, kv_heads ==
// heads), K11-C and G-F (L = 7, any kv_heads).
template <int L>
int ln_qkvo_attention_quant_fwd_sm90(const vitax::bf16* x, const float* gamma,
                                     const float* beta, const int8_t* w8t, const float* sw,
                                     const float* bqkv, const int8_t* wo8t, const float* swo,
                                     const float* bo, int8_t* xq, float* sx, vitax::bf16* qkv,
                                     float* attn, int8_t* aq, float* sa, vitax::bf16* out, int b,
                                     int spq, int d, int seq_len, int heads, int kv_heads,
                                     int head_dim, float eps, float scale, cudaStream_t st) {
  namespace sm90 = vitax::sm90;
  const int n = b * spq;
  const int hhd = heads * head_dim;
  const int kvw = kv_heads * head_dim;
  const int w = hhd + 2 * kvw;
  cudaError_t e = vitax::launch_layer_norm_quant<false, false, L>(x, gamma, beta, xq, sx,
                                                                  nullptr, n, d, eps, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_s8<sm90::kEpiS8Bf16>(xq, w8t, sx, sw, bqkv, qkv, nullptr, n, w, d, st);
  if (e != cudaSuccess) return e;
  vitax::k13::CoreArgs a{};
  a.q = qkv, a.k = qkv + hhd, a.v = qkv + hhd + kvw, a.o32 = attn;
  a.seq = seq_len, a.rows = a.kv_rows = spq, a.img_rows = a.kv_img_rows = spq, a.heads = heads;
  a.kv_heads = kv_heads;
  a.scale = scale;
  a.ld_q = a.ld_k = a.ld_v = w;
  a.ld_o = hhd;
  e = vitax::k13::launch_core_rows<vitax::k13::kRowsFwdF32>(a, head_dim, b, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_rows<L>(attn, aq, sa, n, hhd, st);
  if (e != cudaSuccess) return e;
  return sm90::gemm_s8<sm90::kEpiS8Bf16>(aq, wo8t, sa, swo, bo, out, nullptr, n, d, hhd, st);
}

// The forward on the grid of limit L (127: K3, 7: K11-C).
template <int L>
int ln_qkvo_attention_quant_fwd(
    const void* x, const void* gamma, const void* beta, const void* wqkv, const void* bqkv,
    const void* wo, const void* bo, void* w8t, void* sw, void* wo8t, void* swo, void* xq,
    void* sx, void* qkv, void* attn, void* aq, void* sa, void* out, int b, int spq, int d,
    int seq_len, int heads, int kv_heads, int head_dim, float eps, float scale, void* stream) {
  using vitax::bf16;
  const auto st = static_cast<cudaStream_t>(stream);
  const int n = b * spq;
  const int hhd = heads * head_dim;
  const int w = (heads + 2 * kv_heads) * head_dim;
  auto* xqi = static_cast<int8_t*>(xq);
  auto* sxf = static_cast<float*>(sx);
  auto* qkvb = static_cast<bf16*>(qkv);
  auto* attnf = static_cast<float*>(attn);
  auto* aqi = static_cast<int8_t*>(aq);
  auto* saf = static_cast<float*>(sa);
  const bool hopper = L == vitax::kQ4 || kv_heads == heads;
  if (n == 0) return cudaSuccess;
  if (hopper && (b > 65535 || seq_len <= 0 || seq_len > spq)) return cudaErrorInvalidValue;
  cudaError_t e = vitax::launch_quant_weight_cols_t<L>(static_cast<const bf16*>(wqkv),
                                                       static_cast<int8_t*>(w8t),
                                                       static_cast<float*>(sw), d, w, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_weight_cols_t<L>(static_cast<const bf16*>(wo),
                                           static_cast<int8_t*>(wo8t), static_cast<float*>(swo),
                                           hhd, d, st);
  if (e != cudaSuccess) return e;
  if (hopper)
    return ln_qkvo_attention_quant_fwd_sm90<L>(
        static_cast<const bf16*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<const int8_t*>(w8t),
        static_cast<const float*>(sw), static_cast<const float*>(bqkv),
        static_cast<const int8_t*>(wo8t), static_cast<const float*>(swo),
        static_cast<const float*>(bo), xqi, sxf, qkvb, attnf, aqi, saf, static_cast<bf16*>(out),
        b, spq, d, seq_len, heads, kv_heads, head_dim, eps, scale, st);
  if constexpr (L == vitax::kQ8) {  // K7's int8 forward: the first design
    e = vitax::launch_layer_norm_quant<false, false, L>(
        static_cast<const bf16*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), xqi, sxf, nullptr, n, d, eps, st);
    if (e != cudaSuccess) return e;
    e = vitax::launch_gemm_s8<vitax::kS8Bf16>(xqi, static_cast<const int8_t*>(w8t), sxf,
                                              static_cast<const float*>(sw),
                                              static_cast<const float*>(bqkv), nullptr,
                                              qkvb, nullptr, n, w, d, st);
    if (e != cudaSuccess) return e;
    e = vitax::launch_attention_core_geom(
        vitax::attn_geom_packed(qkvb, b, spq, seq_len, heads, kv_heads, head_dim, scale), head_dim,
        attnf, st);
    if (e != cudaSuccess) return e;
    e = vitax::launch_quant_rows<L>(static_cast<const float*>(attnf), aqi, saf, n, hhd, st);
    if (e != cudaSuccess) return e;
    return vitax::launch_gemm_s8<vitax::kS8Bf16>(
        aqi, static_cast<const int8_t*>(wo8t), saf, static_cast<const float*>(swo),
        static_cast<const float*>(bo), nullptr, static_cast<bf16*>(out), nullptr, n, d,
        hhd, st);
  }
  return cudaErrorInvalidValue;  // unreached: L = 7 always takes the Hopper body
}

}  // namespace

// Inputs x bf16 [b·spq, d], gamma, beta fp32 [d], wqkv bf16 [d, w], bqkv
// [w], wo bf16 [hhd, d], bo [d], w = (heads + 2 kv_heads) head_dim; output
// out bf16 [b·spq, d]. Scratch: w8t int8 [w, d], sw [w], wo8t int8 [d, hhd],
// swo [d], xq int8 [n, d], sx [n], qkv bf16 [n, w], attn fp32 [n, hhd], aq
// int8 [n, hhd], sa [n].
extern "C" int vitax_ln_qkvo_attention_int8_fwd(
    const void* x, const void* gamma, const void* beta, const void* wqkv, const void* bqkv,
    const void* wo, const void* bo, void* w8t, void* sw, void* wo8t, void* swo, void* xq,
    void* sx, void* qkv, void* attn, void* aq, void* sa, void* out, int b, int spq, int d,
    int seq_len, int heads, int kv_heads, int head_dim, float eps, float scale, void* stream) {
  return ln_qkvo_attention_quant_fwd<vitax::kQ8>(
      x, gamma, beta, wqkv, bqkv, wo, bo, w8t, sw, wo8t, swo, xq, sx, qkv, attn, aq, sa, out, b,
      spq, d, seq_len, heads, kv_heads, head_dim, eps, scale, stream);
}

// K11-C: K3's arguments on the int4 grid.
extern "C" int vitax_ln_qkvo_attention_int4_fwd(
    const void* x, const void* gamma, const void* beta, const void* wqkv, const void* bqkv,
    const void* wo, const void* bo, void* w8t, void* sw, void* wo8t, void* swo, void* xq,
    void* sx, void* qkv, void* attn, void* aq, void* sa, void* out, int b, int spq, int d,
    int seq_len, int heads, int kv_heads, int head_dim, float eps, float scale, void* stream) {
  return ln_qkvo_attention_quant_fwd<vitax::kQ4>(
      x, gamma, beta, wqkv, bqkv, wo, bo, w8t, sw, wo8t, swo, xq, sx, qkv, attn, aq, sa, out, b,
      spq, d, seq_len, heads, kv_heads, head_dim, eps, scale, stream);
}
