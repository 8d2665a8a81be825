// K5, the MLP half of the int8 block handoff: replaces
// _ln_mlp_fwd_int8_ho_kernel (vitax/ops/pallas_kernels.py:3732), called at
// :3817 by _mlp_ho_fwd_call from fused_block_int8_handoff (:3863). It is K4's
// forward (ln_mlp_int8.cu) without its LN+quant prologue: it takes r1 and its
// packed LN2 (xq, sx) from the attention half's epilogue, adds the residual in
// fp32 and packs the NEXT block's LN1 of the result:
//
//   a1     = f32(xq W1q) sx s1 + b1
//   h1q, sh = quant_rows(gelu_q(a1))
//   r2     = bf16(f32(r1) + f32(h1q W2q) sh s2 + b2)    the handoff's rounding
//   xqn, sxn = quant_rows(LNn(f32(r2)))                 gn/ben: the next
//                                                       block's LN1
//
// For the encoder's last block gn/ben are the final encoder norm's, and its
// packed output is not read (vitax computes and discards it too).
//
// Bound on the H100: the two s8 products (4 N D M operations) on the tensor
// cores. Design of this first version: K4's launches (weight quantizers, s8
// GEMM writing gelu_q(a1) in fp32, row quantizer, s8 GEMM whose epilogue adds
// the residual in fp32: gemm.cuh kS8ResidualF32), then the LN + quant of r2
// as a separate row pass.
#include "gemm.cuh"
#include "layernorm.cuh"

// Inputs x (= r1) bf16 [n, d], xq int8 [n, d], sx fp32 [n], gn, ben fp32
// [d], w1 bf16 [d, m], b1 [m], w2 bf16 [m, d], b2 [d]. Outputs out (= r2)
// bf16 [n, d], xqn int8 [n, d], sxn fp32 [n]. Scratch: w1t int8 [m, d], s1
// [m], w2t int8 [d, m], s2 [d], g fp32 [n, m], h1q int8 [n, m], sh [n].
extern "C" int vitax_ln_mlp_int8_ho_fwd(const void* x, const void* xq, const void* sx,
                                        const void* gn, const void* ben, const void* w1,
                                        const void* b1, const void* w2, const void* b2, void* w1t,
                                        void* s1, void* w2t, void* s2, void* g, void* h1q,
                                        void* sh, void* out, void* xqn, void* sxn, int n, int d,
                                        int m, float eps, void* stream) {
  using vitax::bf16;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e = vitax::launch_quant_weight_cols_t(static_cast<const bf16*>(w1),
                                                    static_cast<int8_t*>(w1t),
                                                    static_cast<float*>(s1), d, m, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_weight_cols_t(static_cast<const bf16*>(w2), static_cast<int8_t*>(w2t),
                                        static_cast<float*>(s2), m, d, st);
  if (e != cudaSuccess) return e;
  auto* gf = static_cast<float*>(g);
  auto* h1qi = static_cast<int8_t*>(h1q);
  auto* shf = static_cast<float*>(sh);
  auto* outb = static_cast<bf16*>(out);
  e = vitax::launch_gemm_s8<vitax::kS8GeluQF32>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w1t),
      static_cast<const float*>(sx), static_cast<const float*>(s1),
      static_cast<const float*>(b1), nullptr, nullptr, nullptr, gf, n, m, d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_rows(static_cast<const float*>(gf), h1qi, shf, n, m, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm_s8<vitax::kS8ResidualF32>(
      h1qi, static_cast<const int8_t*>(w2t), shf, static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<const bf16*>(x), nullptr, outb, nullptr, n, d,
      m, st);
  if (e != cudaSuccess) return e;
  return vitax::launch_layer_norm_quant<false>(outb, static_cast<const float*>(gn),
                                               static_cast<const float*>(ben),
                                               static_cast<int8_t*>(xqn),
                                               static_cast<float*>(sxn), nullptr, n, d, eps, st);
}
