// K4, the W8A8 forward of the fused LN-MLP half: replaces
// _ln_mlp_fwd_int8_kernel (vitax/ops/pallas_kernels.py:683), reached through
// fused_ln_mlp(int8=True) (:2123) -> _ln_mlp_2d_int8 / _ln_mlp_2d_int8g ->
// _ln_mlp_fwd_int8_call (pallas_call at :1758). In the order of the Pallas
// body (:692-721):
//
//   xq, sx = quant_rows(LN2(x))                  from the fp32 LN output
//   a1     = f32(xq W1q) sx s1 + b1              W1q per output column
//   h1q, sh = quant_rows(gelu_q(a1))              sigmoid GELU, in fp32
//   out    = x + bf16(f32(h1q W2q) sh s2 + b2)   the residual add in bf16
//
// With residual == 0 it is the kernel's `residual=False` branch (:718), which
// vitax's tensor-parallel MLP half runs per model shard
// (vitax/parallel/tp_kernels.py:106-129): out = bf16(f32(h1q W2q) sh s2 +
// b2), no x +, the last GEMM's epilogue kS8Bf16 in place of kS8Residual.
//
// W1 and W2 are quantized per output column (s1, s2) by the first launches
// (quant.cuh), written as [N, K], gemm.cuh's s8 layout.
//
// Bound on the H100: the two s8 products (4 N D M operations) on the tensor
// cores. Design of this first version, four launches on one stream after the
// weights' quantization: the LN with a quantizing epilogue (layernorm.cuh),
// the s8 GEMM whose epilogue writes gelu_q(a1) in fp32 [N, M], the row
// quantizer over it (quant.cuh;
// a row's amax spans all M columns, i.e. 24 GEMM tiles, so it cannot sit in
// the GEMM epilogue), and the s8 GEMM with the residual epilogue. The TPU
// kernel keeps a1 and h1q in VMEM; here the fp32 gelu_q(a1) makes a round
// trip through device memory (8 N M bytes, 79 MB at b32 spq 200), the price
// of the per-row scale. Fusing the amax into the GEMM (a row-block-wide
// tile) is later work.
//
// K11-A, the A4W4 forward (vitax_ln_mlp_int4_fwd): replaces
// _ln_mlp_fwd_int4_kernel (:961), reached through fused_ln_mlp(int4=True)
// (:2152) -> _ln_mlp_2d_int4 -> _ln_mlp_fwd_int4_call (pallas_call at
// :1880). Its body (:973-998) is K4's with every quantizer on the int4 grid
// (_quant_rows4, _quant_cols_host4: limit 7, quant.cuh), so it is the same
// four launches at L = 7 (its `residual=False` branch :997 as K4's); the
// codes live in int8 and the s8 products of
// values in [-7, 7] are the int4 products' int32 sums (|acc| <= 49 K). The
// H100 has no int4 tensor-core rate: the bound and the design are K4's.
#include "gemm.cuh"
#include "layernorm.cuh"

namespace {

// The forward on the grid of limit L (127: K4, 7: K11-A).
template <int L>
int ln_mlp_quant_fwd(const void* x, const void* gamma, const void* beta, const void* w1,
                     const void* b1, const void* w2, const void* b2, void* w1t, void* s1,
                     void* w2t, void* s2, void* xq, void* sx, void* g, void* h1q, void* sh,
                     void* out, int n, int d, int m, float eps, int residual, void* stream) {
  using vitax::bf16;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  cudaError_t e = vitax::launch_quant_weight_cols_t<L>(static_cast<const bf16*>(w1),
                                                       static_cast<int8_t*>(w1t),
                                                       static_cast<float*>(s1), d, m, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_weight_cols_t<L>(static_cast<const bf16*>(w2),
                                           static_cast<int8_t*>(w2t), static_cast<float*>(s2),
                                           m, d, st);
  if (e != cudaSuccess) return e;
  auto* xqi = static_cast<int8_t*>(xq);
  auto* sxf = static_cast<float*>(sx);
  auto* gf = static_cast<float*>(g);
  auto* h1qi = static_cast<int8_t*>(h1q);
  auto* shf = static_cast<float*>(sh);
  e = vitax::launch_layer_norm_quant<false, false, L>(
      xb, static_cast<const float*>(gamma), static_cast<const float*>(beta), xqi, sxf, nullptr, n,
      d, eps, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm_s8<vitax::kS8GeluQF32>(
      xqi, static_cast<const int8_t*>(w1t), sxf, static_cast<const float*>(s1),
      static_cast<const float*>(b1), nullptr, nullptr, nullptr, gf, n, m, d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_rows<L>(static_cast<const float*>(gf), h1qi, shf, n, m, st);
  if (e != cudaSuccess) return e;
  if (!residual)
    return vitax::launch_gemm_s8<vitax::kS8Bf16>(
        h1qi, static_cast<const int8_t*>(w2t), shf, static_cast<const float*>(s2),
        static_cast<const float*>(b2), nullptr, nullptr, static_cast<bf16*>(out), nullptr, n, d,
        m, st);
  return vitax::launch_gemm_s8<vitax::kS8Residual>(
      h1qi, static_cast<const int8_t*>(w2t), shf, static_cast<const float*>(s2),
      static_cast<const float*>(b2), xb, nullptr, static_cast<bf16*>(out), nullptr, n, d, m, st);
}

}  // namespace

// Inputs x bf16 [n, d], gamma, beta fp32 [d], w1 bf16 [d, m], b1 [m], w2 bf16
// [m, d], b2 [d]; output out bf16 [n, d]. Scratch: w1t int8 [m, d], s1 [m],
// w2t int8 [d, m], s2 [d], xq int8 [n, d], sx [n], g fp32 [n, m], h1q int8
// [n, m], sh [n]. residual 0: out = the partial sum, without x +.
extern "C" int vitax_ln_mlp_int8_fwd(const void* x, const void* gamma, const void* beta,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, void* w1t, void* s1, void* w2t, void* s2,
                                     void* xq, void* sx, void* g, void* h1q, void* sh, void* out,
                                     int n, int d, int m, float eps, int residual,
                                     void* stream) {
  return ln_mlp_quant_fwd<vitax::kQ8>(x, gamma, beta, w1, b1, w2, b2, w1t, s1, w2t, s2, xq, sx, g,
                                      h1q, sh, out, n, d, m, eps, residual, stream);
}

// K11-A: the same arguments, every code on the int4 grid.
extern "C" int vitax_ln_mlp_int4_fwd(const void* x, const void* gamma, const void* beta,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, void* w1t, void* s1, void* w2t, void* s2,
                                     void* xq, void* sx, void* g, void* h1q, void* sh, void* out,
                                     int n, int d, int m, float eps, int residual,
                                     void* stream) {
  return ln_mlp_quant_fwd<vitax::kQ4>(x, gamma, beta, w1, b1, w2, b2, w1t, s1, w2t, s2, xq, sx, g,
                                      h1q, sh, out, n, d, m, eps, residual, stream);
}
