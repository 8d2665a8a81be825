// gemm_sm90.cuh's s8 products, one launch each, for the card tests: each
// epilogue held against exact int32 products dequantized by its plain twin
// (ops/cuda_kernels.py `gemm_sm90_s8_ref`), and two runs against each other.
// It replaces no TPU kernel (the products live inside K3's and K4's int8
// forwards and backwards and K5's halves); the port's paths never call it.
// vitax_gemm_sm90_s8_launches reads how many products of each kind
// launch_s8 has launched, by whichever caller.
#include "gemm_sm90.cuh"

// A [m, k], B [n, k] int8 codes (the dual product's A2 [m, k], B2 [n, k]);
// sr [m] and sc [n] their scales (sr2, sc2 the second product's), bias [n]
// or null. kind 0: C = bf16(f32(A·Bᵀ)·sr·sc (+ bias)); 1: F = the same in
// fp32; 2: K4's dual product, a = f32(A·Bᵀ)·sr·sc + bias, C = bf16(gelu_q(a)),
// F = f32(A2·B2ᵀ)·sr2·sc2·gelu_q'(a), C2 = bf16(F); 3: the int8_dw group
// fold, F = Σ over groups z of f32(A_z·B_zᵀ)·sr[z·m + i], the groups gp
// columns of K each (gp % 128 == 0); 4: K4's fc1, F = gelu_q(f32(A·Bᵀ)·sr·sc
// + bias); 5: K4's fc2, C = bf16(R + bf16(f32(A·Bᵀ)·sr·sc + bias)), R [m, n]
// bf16; 6: K5's out-projection and fc2, C = bf16(f32(R) + (f32(A·Bᵀ)·sr·sc +
// bias)), the add in fp32; 7: the int4_grad backwards' int8_dw fold with two
// scale vectors, F = Σ over groups z of (f32(A_z·B_zᵀ)·sr[z·m + i])·sc[z·n +
// j], sr [groups, m], sc [groups, n].
extern "C" int vitax_gemm_sm90_s8(const void* a, const void* b, const void* a2, const void* b2,
                                  const void* sr, const void* sc, const void* bias,
                                  const void* sr2, const void* sc2, const void* r, void* c,
                                  void* c2, void* f, int m, int n, int k, int gp, int kind,
                                  void* stream) {
  using vitax::bf16;
  namespace sm90 = vitax::sm90;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const int8_t*>(a);
  const auto* B = static_cast<const int8_t*>(b);
  const auto* SR = static_cast<const float*>(sr);
  const auto* SC = static_cast<const float*>(sc);
  const auto* bias_f = static_cast<const float*>(bias);
  switch (kind) {
    case 0:
      return sm90::gemm_s8<sm90::kEpiS8Bf16>(A, B, SR, SC, bias_f, static_cast<bf16*>(c), nullptr,
                                             m, n, k, st);
    case 1:
      return sm90::gemm_s8<sm90::kEpiS8F32>(A, B, SR, SC, bias_f, nullptr, static_cast<float*>(f),
                                            m, n, k, st);
    case 2:
      return sm90::gemm_s8_gelu_pair(A, B, SR, SC, bias_f, static_cast<const int8_t*>(a2),
                                     static_cast<const int8_t*>(b2),
                                     static_cast<const float*>(sr2),
                                     static_cast<const float*>(sc2), static_cast<bf16*>(c),
                                     static_cast<bf16*>(c2), static_cast<float*>(f), m, n, k, st);
    case 3:
      return sm90::gemm_s8_groups(A, B, SR, static_cast<float*>(f), m, n, k, gp, st);
    case 4:
      return sm90::gemm_s8<sm90::kEpiS8GeluQF32>(A, B, SR, SC, bias_f, nullptr,
                                                 static_cast<float*>(f), m, n, k, st);
    case 5:
      return sm90::gemm_s8<sm90::kEpiS8Residual>(A, B, SR, SC, bias_f, static_cast<bf16*>(c),
                                                 nullptr, m, n, k, st,
                                                 static_cast<const bf16*>(r));
    case 6:
      return sm90::gemm_s8<sm90::kEpiS8ResidualF32>(A, B, SR, SC, bias_f,
                                                    static_cast<bf16*>(c), nullptr, m, n, k,
                                                    st, static_cast<const bf16*>(r));
    case 7:
      return sm90::gemm_s8_groups_rc(A, B, SR, SC, static_cast<float*>(f), m, n, k, gp, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// gemm.cuh's two-scale group fold (kS8GroupF32RC, the first design's) on
// the same operands as kind 7 above, for the card
// test that holds the two folds to the same bits: F [m, n] = Σ over groups z
// of (f32(A_z·B_zᵀ)·sa[z·m + i])·sb[z·n + j], A [m, k], B [n, k] int8, the
// groups gp columns of k each (gp % 64 == 0). Counted as a gemm.cuh s8
// product.
extern "C" int vitax_gemm_s8_groups_rc(const void* a, const void* b, const void* sa,
                                       const void* sb, void* f, int m, int n, int k, int gp,
                                       void* stream) {
  return vitax::launch_gemm_s8_groups(static_cast<const int8_t*>(a),
                                      static_cast<const int8_t*>(b),
                                      static_cast<const float*>(sa), static_cast<float*>(f), m,
                                      n, k, gp, static_cast<cudaStream_t>(stream), false,
                                      static_cast<const float*>(sb));
}

// counts[kind] = the launches of each kind (the order of the switch above)
// since the last reset; reset != 0 zeroes them after the read
extern "C" int vitax_gemm_sm90_s8_launches(long long* counts, int reset) {
  for (int kind = 0; kind < 8; ++kind) {
    counts[kind] = vitax::sm90::s8_launches[kind];
    if (reset) vitax::sm90::s8_launches[kind] = 0;
  }
  return 0;
}

// counts[0] = gemm.cuh's mma.sync s8 products, counts[1] = attention.cuh's
// whole-row forward cores, counts[2] = attention_bwd.cuh's whole-row
// backward cores, counts[3] = gemm.cuh's bf16 WMMA products launched since
// the last reset (common.cuh's first_design_launches); reset != 0 zeroes
// them after the read
extern "C" int vitax_first_design_launches(long long* counts, int reset) {
  for (int i = 0; i < vitax::kFirstDesignPieces; ++i) {
    counts[i] = vitax::first_design_launches[i];
    if (reset) vitax::first_design_launches[i] = 0;
  }
  return 0;
}
