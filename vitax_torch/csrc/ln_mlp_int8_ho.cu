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
// Bound on the H100: the two s8 products (4 N D M operations at 1979 TOP/s)
// on the tensor cores. Design: K4's Hopper branch without its prologue, on
// one stream after the weights' column codes (quant.cuh, as [N, K]):
//   1. fc1 on gemm_sm90.cuh's s8 wgmma path with kEpiS8GeluQF32, K4's fc1:
//      g = gelu_q(dq(xq·W1ᵀ) + b1), fp32 [N, M];
//   2. the row quantizer over g (quant.cuh) into h1q, sh;
//   3. fc2 with kEpiS8ResidualF32: r2 = bf16(f32(r1) + (dq(h1q·W2ᵀ) + b2)),
//      r1 read in the epilogue only;
//   4. the LN-quant row pass of gn/ben over the bf16 r2 into xqn, sxn
//      (layernorm.cuh, the row in registers).
// The int32 sums are exact and the epilogues dequantize in the twin's order
// with explicit _rn steps, so h1q and r2 are the twin's bits from the same
// packed input. The TPU kernel keeps a1 and h1q in VMEM; here the fp32 g
// makes a round trip through device memory (981 MB at b768 spq 104), the
// price of the per-row scale.
#include "gemm_sm90.cuh"
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
  namespace sm90 = vitax::sm90;
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
  e = sm90::gemm_s8<sm90::kEpiS8GeluQF32>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w1t),
      static_cast<const float*>(sx), static_cast<const float*>(s1),
      static_cast<const float*>(b1), nullptr, gf, n, m, d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_rows(static_cast<const float*>(gf), h1qi, shf, n, m, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_s8<sm90::kEpiS8ResidualF32>(h1qi, static_cast<const int8_t*>(w2t), shf,
                                             static_cast<const float*>(s2),
                                             static_cast<const float*>(b2), outb, nullptr, n, d,
                                             m, st, static_cast<const bf16*>(x));
  if (e != cudaSuccess) return e;
  return vitax::launch_layer_norm_quant<false>(outb, static_cast<const float*>(gn),
                                               static_cast<const float*>(ben),
                                               static_cast<int8_t*>(xqn),
                                               static_cast<float*>(sxn), nullptr, n, d, eps, st);
}
