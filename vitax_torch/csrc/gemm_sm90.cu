// gemm_sm90.cuh's products, one launch each, for the card tests: each layout
// and epilogue held against an fp32 torch.matmul of the same bf16 inputs,
// and two runs against each other. It replaces no TPU kernel (the products
// live inside K1's and K2's forwards and backwards and K12's forward); the
// port's paths never call it.
#include "gemm_sm90.cuh"

// fp32 elements of kind 2's split-K workspace
extern "C" long long vitax_gemm_sm90_ws(int m, int n, int k) {
  return static_cast<long long>(vitax::gemm_tn_workspace(m, n, k));
}

// kind 0: C = bf16(A[m,k]·B[k,n] + bias); 1: C = bf16(A·B[n,k]ᵀ); 2: F = A·B[n,k]ᵀ
// (fp32); 3: F = A[k,m]ᵀ·B[k,n] (fp32, split K over ws); 4: the dual pair,
// a = A·B[k,n] + bias, C = bf16(gelu(a)), C2 = bf16((A2[m,k]·B2[n,k]ᵀ)·gelu'(a));
// the forwards' epilogues on a = A·B[k,n] + bias: 5: C = bf16(gelu(a)); 6: that
// C and C2 = bf16(gelu'(a)); 7: C = bf16(R + bf16(a)), the residual R [m, n]
// passed as a2.
extern "C" int vitax_gemm_sm90(const void* a, const void* b, const void* bias, const void* a2,
                               const void* b2, void* c, void* c2, void* f, void* ws, int m, int n,
                               int k, int kind, void* stream) {
  using vitax::bf16;
  namespace sm90 = vitax::sm90;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const bf16*>(a);
  const auto* B = static_cast<const bf16*>(b);
  switch (kind) {
    case 0:
      return sm90::gemm_nn<sm90::kEpiBias>(A, B, static_cast<const float*>(bias),
                                           static_cast<bf16*>(c), nullptr, m, n, k, st);
    case 1:
      return sm90::gemm_nt<sm90::kEpiStore>(A, B, static_cast<bf16*>(c), nullptr, m, n, k, st);
    case 2:
      return sm90::gemm_nt<sm90::kEpiF32>(A, B, nullptr, static_cast<float*>(f), m, n, k, st);
    case 3:
      return sm90::gemm_tn(A, B, static_cast<float*>(f), static_cast<float*>(ws), m, n, k, st);
    case 4:
      return sm90::gemm_gelu_pair(A, B, static_cast<const float*>(bias),
                                  static_cast<const bf16*>(a2), static_cast<const bf16*>(b2),
                                  static_cast<bf16*>(c), static_cast<bf16*>(c2), m, n, k, st);
    case 5:
      return sm90::gemm_nn<sm90::kEpiBiasGelu>(A, B, static_cast<const float*>(bias),
                                               static_cast<bf16*>(c), nullptr, m, n, k, st);
    case 6:
      return sm90::gemm_nn<sm90::kEpiBiasGeluSave>(A, B, static_cast<const float*>(bias),
                                                   static_cast<bf16*>(c), nullptr, m, n, k, st,
                                                   nullptr, static_cast<bf16*>(c2));
    case 7:
      return sm90::gemm_nn<sm90::kEpiBiasResidual>(A, B, static_cast<const float*>(bias),
                                                   static_cast<bf16*>(c), nullptr, m, n, k, st,
                                                   static_cast<const bf16*>(a2));
    default:
      return cudaErrorInvalidValue;
  }
}
