// K12 int8, the save-acts pair of the W8A8 LN-MLP half: replaces
// _ln_mlp_fwd_int8_save_kernel (vitax/ops/pallas_kernels.py:732, pallas_call
// at :2025) and _ln_mlp_bwd_int8_save_kernel (:778, pallas_call at :2066),
// reached through fused_ln_mlp(int8=True, int8_grad=True, save_acts=True)
// (:2123) -> _ln_mlp_2d_int8s (:2100), with int8_dw off or on.
//
// Forward, K4's first-design launches (gemm.cuh's mma.sync s8 GEMM), fc1's
// epilogue (kS8GeluQF32) given the codes' buffer: besides gelu_q(a1) in fp32
// it writes gpq = clip(rint(gelu_grad_q(a1) * 127/1.13)), GELU' on vitax's
// static grid (_GP_AMAX :723-729); h1q and its row scales sh are kept as
// outputs (vitax stores sh as [N, 128] lanes, the port one fp32 a row).
// K4's forward runs on gemm_sm90.cuh since its redesign; both epilogues
// dequantize in the twin's order with explicit _rn steps, so out is K4's,
// bit for bit.
//
// Backward from the saved codes (:789-864), no fc1 recompute, no LN
// quantization, no GELU:
//
//   xn     = bf16(LN2(x))                      statistics recomputed only
//   doq, sdo = quant_rows(do)
//   dh1_32 = f32(doq W2r^T) (sdo·1.13/127) s2r * f32(gpq)   (kS8GpqGrad)
//   dh1q, sdh = quant_rows(dh1_32);  dxn = f32(dh1q W1r^T) sdh s1r
//   db1 = Σ dh1_32 (fp32), db2 = Σ do
//   dW2 = bf16(h1q)^T bf16(sh·do),  dW1 = xn^T bf16(dh1_32)        (bf16 dW)
//   or, int8_dw, per group z (dw_int8.cuh, row-scale folding :816-830):
//   dW2 = Σ_z h1q_z^T quant_cols(sh·do)_z,  dW1 = Σ_z quant_cols(xn·sdh)_z^T dh1q_z
//   LN tail: dx = do + bf16(dx_ln), dγ = Σ dxn x̂, dβ = Σ dxn
//
// dW2's int8_dw codes differ from K4's (:1173-1197): here h1q comes saved
// with its row scale sh, which folds into do, so the column-quantized operand
// is sh·do [n, d] and the row codes h1q's; dw_int8.cuh computes the product
// as dW2^T [d, m] and stores it transposed. The group is the port's
// (ops/cuda_kernels.py), passed in.
//
// Bound on the H100: the four products on the tensor cores, two s8 and two
// bf16 (8·N·D·M operations; four s8 under int8_dw). This first design is the
// multi-launch form of K4's backward without its fc1 recompute: dh1_32 (fp32
// [n, m]) and the codes go through device memory; the bf16 dW operands are
// made by one elementwise pass each (h1q -> bf16, sh·do -> bf16). Weight
// grads are ordered split-K kTN products (or the ordered group sums) and
// vector grads two-pass column sums: no float atomics, the same bits each
// run.
//
// With residual == 0, the kernels' `residual=False` branches (:772, :862):
// out = bf16(f32(h1q W2q) sh s2 + b2) without x + (fc2's epilogue kS8Bf16 in
// place of kS8Residual), and dx = bf16(dx_ln) without do +.
#include "dw_int8.cuh"
#include "gemm.cuh"
#include "layernorm.cuh"

using vitax::bf16;

namespace {

__device__ __forceinline__ void load8_any(const bf16* p, float v[8]) {
  vitax::load4(p, v);
  vitax::load4(p + 4, v + 4);
}
__device__ __forceinline__ void load8_any(const int8_t* p, float v[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int t = 0; t < 8; ++t) v[t] = static_cast<float>(b[t]);
}

// out[r][c] = bf16(u[r] * f32(a[r][c])), or bf16(f32(a[r][c])) with u null:
// the bf16 dW2 operands, bf16(h1q) (exact) and bf16(sh·do). w % 8 == 0.
template <typename T>
__global__ void __launch_bounds__(256)
    scale_rows_bf16_kernel(const T* __restrict__ a, const float* __restrict__ u,
                           bf16* __restrict__ out, int n, int w) {
  const size_t count = static_cast<size_t>(n) * w / 8;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t e = i * 8;
    float v[8];
    load8_any(a + e, v);
    if (u != nullptr) {
      const float s = u[e / w];
#pragma unroll
      for (int t = 0; t < 8; ++t) v[t] = s * v[t];
    }
    vitax::store4(out + e, v);
    vitax::store4(out + e + 4, v + 4);
  }
}

template <typename T>
cudaError_t launch_scale_rows_bf16(const T* a, const float* u, bf16* out, int n, int w,
                                   cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  if (w % 8) return cudaErrorInvalidValue;
  const size_t count = static_cast<size_t>(n) * w / 8;
  const int blocks = static_cast<int>((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  scale_rows_bf16_kernel<T><<<blocks, 256, 0, stream>>>(a, u, out, n, w);
  return cudaGetLastError();
}

}  // namespace

// Inputs x bf16 [n, d], gamma, beta fp32 [d], w1 bf16 [d, m], b1 [m], w2 bf16
// [m, d], b2 [d]. Outputs out bf16 [n, d], h1q int8 [n, m], sh fp32 [n], gpq
// int8 [n, m]. Scratch: w1t int8 [m, d], s1 [m], w2t int8 [d, m], s2 [d], xq
// int8 [n, d], sx [n], g fp32 [n, m].
extern "C" int vitax_ln_mlp_int8_save_fwd(const void* x, const void* gamma, const void* beta,
                                          const void* w1, const void* b1, const void* w2,
                                          const void* b2, void* w1t, void* s1, void* w2t,
                                          void* s2, void* xq, void* sx, void* g, void* h1q,
                                          void* sh, void* gpq, void* out, int n, int d, int m,
                                          float eps, int residual, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  cudaError_t e = vitax::launch_quant_weight_cols_t(static_cast<const bf16*>(w1),
                                                    static_cast<int8_t*>(w1t),
                                                    static_cast<float*>(s1), d, m, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_weight_cols_t(static_cast<const bf16*>(w2), static_cast<int8_t*>(w2t),
                                        static_cast<float*>(s2), m, d, st);
  if (e != cudaSuccess) return e;
  auto* xqi = static_cast<int8_t*>(xq);
  auto* sxf = static_cast<float*>(sx);
  auto* gf = static_cast<float*>(g);
  auto* h1qi = static_cast<int8_t*>(h1q);
  auto* shf = static_cast<float*>(sh);
  e = vitax::launch_layer_norm_quant<false>(
      xb, static_cast<const float*>(gamma), static_cast<const float*>(beta), xqi, sxf, nullptr, n,
      d, eps, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm_s8<vitax::kS8GeluQF32>(
      xqi, static_cast<const int8_t*>(w1t), sxf, static_cast<const float*>(s1),
      static_cast<const float*>(b1), nullptr, nullptr, gf, n, m, d, st,
      static_cast<int8_t*>(gpq));
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_rows(static_cast<const float*>(gf), h1qi, shf, n, m, st);
  if (e != cudaSuccess) return e;
  if (!residual)
    return vitax::launch_gemm_s8<vitax::kS8Bf16>(
        h1qi, static_cast<const int8_t*>(w2t), shf, static_cast<const float*>(s2),
        static_cast<const float*>(b2), nullptr, static_cast<bf16*>(out), nullptr, n, d,
        m, st);
  return vitax::launch_gemm_s8<vitax::kS8Residual>(
      h1qi, static_cast<const int8_t*>(w2t), shf, static_cast<const float*>(s2),
      static_cast<const float*>(b2), xb, static_cast<bf16*>(out), nullptr, n, d, m, st);
}

// Inputs x, dout bf16 [n, d], gamma, beta fp32 [d], w1 bf16 [d, m], w2 bf16
// [m, d], h1q int8 [n, m], sh fp32 [n], gpq int8 [n, m] (the forward's).
// Outputs dx (bf16 [n, d]) and fp32 dgamma, dbeta [d], dw1 [d, m], db1 [m],
// dw2 [m, d], db2 [d]. Scratch: w1r int8 [d, m], s1r [d], w2r int8 [m, d],
// s2r [m], xn bf16 [n, d], doq int8 [n, d], sdo [n], dh1f fp32 [n, m], dh1
// bf16 [n, m], dh1q int8 [n, m], sdh [n], dxn fp32 [n, d], ws fp32
// vitax_ln_mlp_bwd_ws(n, d, m); without int8_dw (else null) h1b bf16
// [n, m], dos bf16 [n, d]; with int8_dw (else null), kp = groups *
// round_up(group, 64): doct int8 [d, kp], sdoc fp32 [groups, d], h1qt int8
// [m, kp], xnct int8 [d, kp], sxn fp32 [groups, d], dh1qt int8 [m, kp].
extern "C" int vitax_ln_mlp_int8_save_bwd(
    const void* x, const void* gamma, const void* beta, const void* w1, const void* w2,
    const void* h1q, const void* sh, const void* gpq, const void* dout, void* dx, void* dgamma,
    void* dbeta, void* dw1, void* db1, void* dw2, void* db2, void* w1r, void* s1r, void* w2r,
    void* s2r, void* xn, void* doq, void* sdo, void* dh1f, void* dh1, void* dh1q, void* sdh,
    void* dxn, void* ws, void* h1b, void* dos, void* doct, void* sdoc, void* h1qt, void* xnct,
    void* sxn, void* dh1qt, int n, int d, int m, int group, int int8_dw, float eps,
    int residual, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e = vitax::launch_quant_weight_rows(static_cast<const bf16*>(w1),
                                                  static_cast<int8_t*>(w1r),
                                                  static_cast<float*>(s1r), d, m, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_weight_rows(static_cast<const bf16*>(w2), static_cast<int8_t*>(w2r),
                                      static_cast<float*>(s2r), m, d, st);
  if (e != cudaSuccess) return e;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* dob = static_cast<const bf16*>(dout);
  const auto* h1qi = static_cast<const int8_t*>(h1q);
  const auto* shf = static_cast<const float*>(sh);
  auto* xnb = static_cast<bf16*>(xn);
  auto* doqi = static_cast<int8_t*>(doq);
  auto* sdof = static_cast<float*>(sdo);
  auto* dh1ff = static_cast<float*>(dh1f);
  auto* dh1b = static_cast<bf16*>(dh1);
  auto* dh1qi = static_cast<int8_t*>(dh1q);
  auto* sdhf = static_cast<float*>(sdh);
  auto* dxnf = static_cast<float*>(dxn);
  auto* wsf = static_cast<float*>(ws);

  e = vitax::launch_layer_norm(xb, static_cast<const float*>(gamma),
                               static_cast<const float*>(beta), xnb, n, d, eps, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_rows(dob, doqi, sdof, n, d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm_s8<vitax::kS8GpqGrad>(
      doqi, static_cast<const int8_t*>(w2r), sdof, static_cast<const float*>(s2r), nullptr,
      nullptr, dh1b, dh1ff, n, m, d, st,
      const_cast<int8_t*>(static_cast<const int8_t*>(gpq)));
  if (e != cudaSuccess) return e;
  if (!int8_dw) {
    auto* h1bb = static_cast<bf16*>(h1b);
    auto* dosb = static_cast<bf16*>(dos);
    e = launch_scale_rows_bf16(h1qi, static_cast<const float*>(nullptr), h1bb, n, m, st);
    if (e != cudaSuccess) return e;
    e = launch_scale_rows_bf16(dob, shf, dosb, n, d, st);
    if (e != cudaSuccess) return e;
    e = vitax::launch_gemm_tn(h1bb, dosb, static_cast<float*>(dw2), wsf, m, d, n, st);
    if (e != cudaSuccess) return e;
    e = vitax::launch_gemm_tn(xnb, dh1b, static_cast<float*>(dw1), wsf, d, m, n, st);
    if (e != cudaSuccess) return e;
  }
  e = vitax::launch_colsum(dob, static_cast<float*>(db2), wsf, n, d, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_colsum(static_cast<const float*>(dh1ff), static_cast<float*>(db1), wsf, n, m,
                           st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_quant_rows(static_cast<const float*>(dh1ff), dh1qi, sdhf, n, m, st);
  if (e != cudaSuccess) return e;
  if (int8_dw) {
    e = vitax::launch_dw_int8<bf16>(dob, shf, h1qi, n, d, m, group, static_cast<int8_t*>(doct),
                                    static_cast<float*>(sdoc), static_cast<int8_t*>(h1qt),
                                    static_cast<float*>(dw2), st, /*transpose=*/true);
    if (e != cudaSuccess) return e;
    e = vitax::launch_dw_int8<bf16>(xnb, sdhf, dh1qi, n, d, m, group, static_cast<int8_t*>(xnct),
                                    static_cast<float*>(sxn), static_cast<int8_t*>(dh1qt),
                                    static_cast<float*>(dw1), st);
    if (e != cudaSuccess) return e;
  }
  e = vitax::launch_gemm_s8<vitax::kS8F32>(dh1qi, static_cast<const int8_t*>(w1r), sdhf,
                                           static_cast<const float*>(s1r), nullptr, nullptr,
                                           nullptr, dxnf, n, d, m, st);
  if (e != cudaSuccess) return e;
  return vitax::launch_layer_norm_bwd<bf16, float>(
      xb, static_cast<const float*>(gamma), dxnf, residual ? dob : nullptr,
      static_cast<bf16*>(dx),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), wsf, n, d, eps, st);
}
