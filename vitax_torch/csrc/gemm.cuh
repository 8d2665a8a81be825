// Tiled bf16 GEMM with fp32 accumulation and a fused epilogue: the products
// inside the fused attention halves other than K1's (K6, K7, K8, forward
// and backward) and K12's backward (the TPU kernels compute them in
// their own bodies with jnp.dot / dot_general(..., preferred_element_type=
// f32)); K1's and K2's products and K12's forward run on gemm_sm90.cuh.
//
// Three operand layouts, all row-major bf16 in memory, none transposed in
// device memory:
//   kNN  C[M,N] = A[M,K]   @ B[K,N]    forward projections (B = weight [in,out])
//   kNT  C[M,N] = A[M,K]   @ B[N,K]^T  backward dx-path: do·Woᵀ, do·W2ᵀ, dqkv·Wqkvᵀ, dh1·W1ᵀ
//   kTN  C[M,N] = A[K,M]^T @ B[K,N]    weight grads: xnᵀ·dqkv, attnᵀ·do, xnᵀ·dh1, h1ᵀ·do
// kTN contracts over all B·spq rows, so K is ragged (3·200 = 600 is not a
// multiple of the 32-deep K tile): the K loop masks its tail by zero-filling
// the rows past K. kNN and kNT need K % 32 == 0 (D, M, 3·H·Hd, H·Hd all are).
//
// Bound on the H100: the tensor cores at the ViT-B/16 shapes (M = B*spq rows,
// K and N 768..3072: ~380 flops a byte). Design of this first version: WMMA
// 16x16x16 bf16 tiles (mma.sync on Hopper), a 128x128x32 block tile in 8
// warps of 64x32, and a two-stage cp.async ring so the next K tile loads while
// the current one multiplies. It does not reach wgmma/TMA rates; that is left
// for later work. The epilogue stages each 16x16 accumulator through a
// per-warp shared buffer (aliasing the operand ring, free by then), applies
// the epilogue and writes 16-byte vectors with the ragged row edge masked.
//
// The weight grads have small outputs (768x768 is 36 block tiles for 132 SMs)
// and a long K (all rows), so kTN splits K over gridDim.z: each split writes
// an fp32 partial to a workspace and a second pass adds the partials in split
// order. No float atomics: two runs give the same bits.
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace vitax {

enum Layout : int { kNN = 0, kNT = 1, kTN = 2 };

enum Epilogue : int {
  kBias = 0,       // C = bf16(acc + bias)
  kStore = 4,      // C = bf16(acc)
  kStoreF32 = 5,   // F = acc (fp32; with split K, F is the partial of split z)
  kGradSaved = 8,  // C = bf16(acc * f32(G)), G the saved bf16 g' [M,N]
};

constexpr int kGemmBM = 128;
constexpr int kGemmBN = 128;
constexpr int kGemmBK = 32;
constexpr int kGemmThreads = 256;
constexpr int kGemmKLd = kGemmBK + 8;   // tiles stored [rows][32 of K], padded
constexpr int kGemmMNLd = kGemmBN + 8;  // tiles stored [32 of K][128], padded
constexpr int kGemmStage = kGemmBM * kGemmKLd;  // >= kGemmBK * kGemmMNLd
// blocks to aim for when splitting K: two waves of the H100's 132 SMs
constexpr int kSplitKTargetBlocks = 264;

__device__ __forceinline__ float gelu_erf(float a) {
  return 0.5f * a * (1.0f + erff(a * 0.70710678118654752f));
}

// d/da of gelu_erf: Phi(a) + a * phi(a), in fp32 (the TPU's _gelu_grad).
__device__ __forceinline__ float gelu_erf_grad(float a) {
  const float phi = 0.5f * (1.0f + erff(a * 0.70710678118654752f));
  const float pdf = expf(-0.5f * a * a) * 0.3989422804014327f;
  return phi + a * pdf;
}

// The int8 tiers' GELU: a * sigmoid(1.702 a), the sigmoid written as the TPU
// kernels write it, rsqrt(1 + exp(-1.702 a))^2 (_gelu_q / _sigmoid_1702,
// pallas_kernels.py:547-561), and its derivative s (1 + 1.702 a (1 - s))
// (_gelu_grad_q :564-571).
__device__ __forceinline__ float sigmoid_1702(float a) {
  const float r = rsqrtf(1.0f + expf(a * -1.702f));
  return r * r;
}
__device__ __forceinline__ float gelu_q(float a) { return a * sigmoid_1702(a); }
__device__ __forceinline__ float gelu_grad_q(float a) {
  const float s = sigmoid_1702(a);
  return s * (1.0f + 1.702f * a * (1.0f - s));
}

// The save-acts tiers' GELU' codes (K12 int8, pallas_kernels.py:723-729):
// |gelu_q'| <= 1.13 everywhere, so g' is quantized on a static grid,
// q = clip(rint(g' * 127/1.13)), and read back as f32(q) * 1.13/127. The
// constants are the fp32 roundings of the double quotients, as vitax's
// Python floats reach its fp32 arrays.
constexpr float kGpQScale = static_cast<float>(127.0 / 1.13);
constexpr float kGpDequant = static_cast<float>(1.13 / 127.0);

// Loads of one K step into shared memory. A tile: [128 rows of M][32 of K]
// (kNN, kNT) or [32 of K][128 of M] (kTN). B tile: [32 of K][128 of N] (kNN,
// kTN; B's rows ldb apart) or [128 of N][32 of K] (kNT). Rows past M/N and K
// rows past k_end are zero-filled.
template <int LAYOUT>
__device__ __forceinline__ void gemm_load_tile(bf16* As, bf16* Bs, const bf16* __restrict__ A,
                                               const bf16* __restrict__ B, int bm, int bn,
                                               int k0, int k_end, int M, int N, int K,
                                               int ldb) {
  const int tid = threadIdx.x;
  if (LAYOUT == kTN) {
#pragma unroll
    for (int i = tid; i < kGemmBK * kGemmBM / 8; i += kGemmThreads) {
      const int r = i / (kGemmBM / 8);
      const int c = (i % (kGemmBM / 8)) * 8;
      const bool ok = k0 + r < k_end && bm + c < M;
      const bf16* src = A + (ok ? static_cast<size_t>(k0 + r) * M + bm + c : 0);
      cp_async16(&As[r * kGemmMNLd + c], src, ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int i = tid; i < kGemmBM * kGemmBK / 8; i += kGemmThreads) {
      const int r = i / (kGemmBK / 8);
      const int c = (i % (kGemmBK / 8)) * 8;
      const bool ok = bm + r < M && k0 + c < k_end;
      const bf16* src = A + (ok ? static_cast<size_t>(bm + r) * K + k0 + c : 0);
      cp_async16(&As[r * kGemmKLd + c], src, ok ? 16 : 0);
    }
  }
  if (LAYOUT == kNT) {
#pragma unroll
    for (int i = tid; i < kGemmBN * kGemmBK / 8; i += kGemmThreads) {
      const int r = i / (kGemmBK / 8);
      const int c = (i % (kGemmBK / 8)) * 8;
      const bool ok = bn + r < N && k0 + c < k_end;
      const bf16* src = B + (ok ? static_cast<size_t>(bn + r) * ldb + k0 + c : 0);
      cp_async16(&Bs[r * kGemmKLd + c], src, ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int i = tid; i < kGemmBK * kGemmBN / 8; i += kGemmThreads) {
      const int r = i / (kGemmBN / 8);
      const int c = (i % (kGemmBN / 8)) * 8;
      const bool ok = k0 + r < k_end && bn + c < N;
      const bf16* src = B + (ok ? static_cast<size_t>(k0 + r) * ldb + bn + c : 0);
      cp_async16(&Bs[r * kGemmMNLd + c], src, ok ? 16 : 0);
    }
  }
  cp_async_commit();
}

// Requires N % 8 == 0 and M % 8 == 0 for kTN (checked by the wrappers), and
// K % 32 == 0 for kNN/kNT; ldb is B's row stride (N for kNN/kTN and K for
// kNT). blockIdx.z is the K split: K rows
// [z*k_chunk, min(K, (z+1)*k_chunk)); F then points at split z's partial.
template <int LAYOUT, int EPI>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                     const float* __restrict__ bias, const bf16* __restrict__ G,
                     bf16* __restrict__ C, float* __restrict__ F, int M, int N, int K,
                     int k_chunk, int ldb) {
  using namespace nvcuda;
  using ALayout = typename std::conditional<LAYOUT == kTN, wmma::col_major, wmma::row_major>::type;
  using BLayout = typename std::conditional<LAYOUT == kNT, wmma::col_major, wmma::row_major>::type;
  __shared__ __align__(128) bf16 smem[4 * kGemmStage];  // A[2], B[2]; Cs after the loop
  bf16* As[2] = {smem, smem + kGemmStage};
  bf16* Bs[2] = {smem + 2 * kGemmStage, smem + 3 * kGemmStage};

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bm = blockIdx.y * kGemmBM;
  const int bn = blockIdx.x * kGemmBN;
  const int wm = (warp / 4) * 64;
  const int wn = (warp % 4) * 32;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  if (EPI == kStoreF32) F += static_cast<size_t>(blockIdx.z) * M * N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = k_end > k_begin ? (k_end - k_begin + kGemmBK - 1) / kGemmBK : 0;
  if (nk > 0) gemm_load_tile<LAYOUT>(As[0], Bs[0], A, B, bm, bn, k_begin, k_end, M, N, K, ldb);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      gemm_load_tile<LAYOUT>(As[(kt + 1) & 1], Bs[(kt + 1) & 1], A, B, bm, bn,
                             k_begin + (kt + 1) * kGemmBK, k_end, M, N, K, ldb);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* as = As[kt & 1];
    const bf16* bs = Bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < kGemmBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (LAYOUT == kTN)
          wmma::load_matrix_sync(a[i], as + kk * kGemmMNLd + wm + i * 16, kGemmMNLd);
        else
          wmma::load_matrix_sync(a[i], as + (wm + i * 16) * kGemmKLd + kk, kGemmKLd);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (LAYOUT == kNT)
          wmma::load_matrix_sync(b[j], bs + (wn + j * 16) * kGemmKLd + kk, kGemmKLd);
        else
          wmma::load_matrix_sync(b[j], bs + kk * kGemmMNLd + wn + j * 16, kGemmMNLd);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration's load overwrites this stage
  }

  float* cs = reinterpret_cast<float*>(smem) + warp * 256;  // the ring is free now
  const int r = lane / 2;
  const int c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = bm + wm + i * 16 + r;
      const int gc = bn + wn + j * 16 + c0;
      if (gr < M && gc < N) {
        const size_t off = static_cast<size_t>(gr) * N + gc;
        const float* v = cs + r * 16 + c0;
        if (EPI == kStoreF32) {
          *reinterpret_cast<float4*>(F + off) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(F + off + 4) = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          uint4 out_u;
          float aux[8];
          if (EPI == kGradSaved) load4(G + off, aux), load4(G + off + 4, aux + 4);
          bf16* out = reinterpret_cast<bf16*>(&out_u);
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            if (EPI == kStore)
              out[t] = __float2bfloat16(v[t]);
            else if (EPI == kGradSaved)
              out[t] = __float2bfloat16(v[t] * aux[t]);
            else  // kBias
              out[t] = __float2bfloat16(v[t] + bias[gc + t]);
          }
          *reinterpret_cast<uint4*>(C + off) = out_u;
        }
      }
      __syncwarp();
    }
  }
}

// out[i] = sum over s of part[s][i], s in order (the second pass of split K).
template <int kDummy = 0>
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  size_t count, int splits) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * count + i];
    out[i] = s;
  }
}

// K splits of a weight-grad product [M,N] over K rows: enough blocks for two
// waves, each split at least 256 rows deep.
inline int gemm_tn_splits(int M, int N, int K) {
  const int tiles = ((M + kGemmBM - 1) / kGemmBM) * ((N + kGemmBN - 1) / kGemmBN);
  int s = 1;
  while (s < 16 && tiles * s < kSplitKTargetBlocks && K / (2 * s) >= 256) s *= 2;
  return s;
}

// fp32 workspace a weight-grad product needs (0 without a split).
inline size_t gemm_tn_workspace(int M, int N, int K) {
  const int s = gemm_tn_splits(M, N, K);
  return s > 1 ? static_cast<size_t>(s) * M * N : 0;
}

template <int LAYOUT, int EPI>
cudaError_t launch_gemm_impl(const bf16* A, const bf16* B, const float* bias, const bf16* G,
                             bf16* C, float* F, int M, int N, int K, int splits,
                             cudaStream_t stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  const int ldb = LAYOUT == kNT ? K : N;  // the elements of a row of B
  const int k_chunk = (K + splits * kGemmBK - 1) / (splits * kGemmBK) * kGemmBK;
  const dim3 grid((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM, splits);
  gemm_bf16_kernel<LAYOUT, EPI>
      <<<grid, kGemmThreads, 0, stream>>>(A, B, bias, G, C, F, M, N, K, k_chunk, ldb);
  const cudaError_t launched = cudaGetLastError();
  if (launched == cudaSuccess) ++first_design_launches[3];
  return launched;
}

// Forward products: C[M,N] = bf16(A[M,K] @ B[K,N] + bias) (kBias).
template <int EPI>
cudaError_t launch_gemm(const bf16* A, const bf16* B, const float* bias, bf16* C, int M, int N,
                        int K, cudaStream_t stream) {
  return launch_gemm_impl<kNN, EPI>(A, B, bias, nullptr, C, nullptr, M, N, K, 1, stream);
}

// dx-path products: C[M,N] = epilogue(A[M,K] @ B[N,K]^T), epilogue kStore
// (bf16 C) or kStoreF32 (fp32 F).
template <int EPI>
cudaError_t launch_gemm_nt(const bf16* A, const bf16* B, bf16* C, float* F, int M, int N, int K,
                           cudaStream_t stream) {
  return launch_gemm_impl<kNT, EPI>(A, B, nullptr, nullptr, C, F, M, N, K, 1, stream);
}

// The save-acts dh1 product: C[M,N] = bf16(f32(A[M,K] @ B[N,K]^T) * f32(G)),
// G the forward's saved bf16 g' [M,N] (kGradSaved).
inline cudaError_t launch_gemm_nt_saved(const bf16* A, const bf16* B, const bf16* G, bf16* C,
                                        int M, int N, int K, cudaStream_t stream) {
  return launch_gemm_impl<kNT, kGradSaved>(A, B, nullptr, G, C, nullptr, M, N, K, 1, stream);
}

// Weight grads: F[M,N] = A[K,M]^T @ B[K,N] in fp32, over K = all rows
// (ragged). ws holds gemm_tn_workspace(M, N, K) floats.
inline cudaError_t launch_gemm_tn(const bf16* A, const bf16* B, float* F, float* ws, int M, int N,
                                  int K, cudaStream_t stream) {
  const int splits = gemm_tn_splits(M, N, K);
  if (splits == 1)
    return launch_gemm_impl<kTN, kStoreF32>(A, B, nullptr, nullptr, nullptr, F, M, N, K, 1, stream);
  cudaError_t e =
      launch_gemm_impl<kTN, kStoreF32>(A, B, nullptr, nullptr, nullptr, ws, M, N, K, splits, stream);
  if (e != cudaSuccess) return e;
  const size_t count = static_cast<size_t>(M) * N;
  const int blocks = static_cast<int>((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  sum_splits_kernel<0><<<blocks, 256, 0, stream>>>(ws, F, count, splits);
  return cudaGetLastError();
}

// =============================================================================
// s8 x s8 -> s32 products of the W8A8 and A4W4 tiers (the TPU kernels'
// dot_general(int8, int8, preferred_element_type=int32)), dequantized in the
// epilogue in the TPU kernels' order: f32(acc) * s_row[m] * s_col[n] (+ bias),
// the bias add fused with the last multiply (as XLA contracts it, and as the
// plain twins' torch.addcmul and gemm_sm90.cuh's s8 epilogues do), each step
// an explicit _rn intrinsic, so nvcc's contraction choices cannot move a bit:
// K7's int8 forward, R-F, K11-A and K12's int8 pair. The int8 and int4
// backwards, K3's, K4's and K8's int8 forwards and K5's halves run
// gemm_sm90.cuh's s8 wgmma path instead, to the same bits.
//
// One layout: C[M,N] = A[M,K] @ B[N,K]^T, both int8 row-major. mma.sync's
// int8 shape takes only .row.col, i.e. B with K contiguous, so the forward
// products' column-quantized weights are stored [N,K] by their quantizer
// (once per call), and the backward's row-quantized weights, contracted over
// their columns, already are [N,K]: every int8 product of the slice is this
// one layout. K % 16 == 0 (16-byte rows for cp.async), N % 2 == 0.
//
// Design of this first version: mma.sync.m16n8k32.s8 from PTX (WMMA's s8
// tiles are 16 deep, and their loads want 32-byte-aligned K offsets, which a
// 16-byte K step breaks), the same 128x128 block tile and 8 warps of 64x32 as
// the bf16 GEMM, 64-deep K tiles in a two-stage cp.async ring. Shared rows
// are padded to 80 bytes, which makes the 32-bit fragment loads (row g, bytes
// 4t of each 16-row tile) hit 32 distinct banks. The epilogue works on the
// accumulator registers directly (two neighbouring columns a thread) and
// writes bf16x2 / float2. The int32 sums are exact (|acc| <= 127^2 K), so two
// runs give the same bits. Bound on the H100: the tensor cores, as the bf16
// GEMM; mma.sync does not reach the int8 wgmma rate (gemm_sm90.cuh's s8 path
// runs wgmma, for the two backwards that use it).
//
// kS8GroupF32 is the int8_dw weight grad (dw_int8.cuh): K is the rows of the
// batch cut into groups of gp = group_stages * 64 (each zero-padded to a whole
// number of K stages); after a group's last stage the int32 accumulator is
// folded into an fp32 one, F += f32(acc) * sr[z][m] (the group's column
// scales, one per output row m), and cleared. Groups fold in order and the
// product is a separate rounding (__fmul_rn, never contracted into the add),
// as the plain twin adds them: no split, no atomics, the same bits each run.
// kS8GroupF32T stores the same sum as F^T [N, M] (the save-acts backward's
// dW2, whose group codes come as dW2^T's operands). kS8GroupF32RC is the
// int8_dw weight grad of the int4_grad backwards, whose two operands are
// both quantized per column over the group (no row-scale folding): F +=
// (f32(acc) * sr[z][m]) * sc[z][n], each product rounded on its own, as
// vitax's _ln_mlp_bwd_int4_kernel (pallas_kernels.py:1057-1074) orders it;
// the backwards run gemm_sm90.cuh's kEpiS8GroupRC, and this one stays as
// its second implementation (vitax_gemm_s8_groups_rc), which the tests
// hold it against.
//
// The int8 save-acts tier (K12): given Q, kS8GeluQF32 also writes the
// static-grid GELU' codes Q [M,N] of a1 (one instantiation for K12-int8's
// forward and K11-A's), and
// kS8GpqGrad reads them back, the row scale times 1.13/127 first, as
// _ln_mlp_bwd_int8_save_kernel (pallas_kernels.py:802-806) orders it.
// =============================================================================

enum EpilogueS8 : int {
  kS8Bf16 = 0,         // C = bf16(acc*sr*sc (+ bias))
  kS8F32 = 1,          // F = acc*sr*sc (+ bias)
  kS8GeluQF32 = 2,     // F = gelu_q(a), a = acc*sr*sc + bias; Q (if set) = gp codes of gelu_grad_q(a)
  kS8Residual = 4,     // C = R + bf16(acc*sr*sc + bias), the add in bf16
  kS8GroupF32 = 7,     // F = sum over groups z of f32(acc_z) * sr[z*M + m]
  kS8GpqGrad = 8,      // F = acc*(sr*1.13/127)*sc * f32(Q), C = bf16(F); Q the saved gp codes
  kS8GroupF32T = 9,    // kS8GroupF32 stored transposed: F[n*M + m]
  kS8GroupF32RC = 10,  // F = sum over groups z of f32(acc_z) * sr[z*M + m] * sc[z*N + n]
};

constexpr int kS8BK = 64;          // K bytes a stage
constexpr int kS8Ld = kS8BK + 16;  // shared row pitch in bytes
constexpr int kS8Tile = kGemmBM * kS8Ld;

__device__ __forceinline__ void mma_s8_16832(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One K stage: A rows [bm, bm+128) and B rows [bn, bn+128), bytes [k0, k0+64)
// of each, zero past M, N and K.
__device__ __forceinline__ void gemm_s8_load_tile(int8_t* As, int8_t* Bs,
                                                  const int8_t* __restrict__ A,
                                                  const int8_t* __restrict__ B, int bm, int bn,
                                                  int k0, int M, int N, int K) {
#pragma unroll
  for (int i = threadIdx.x; i < kGemmBM * (kS8BK / 16); i += kGemmThreads) {
    const int r = i / (kS8BK / 16);
    const int c = (i % (kS8BK / 16)) * 16;
    const bool ka = k0 + c < K;
    const bool oa = ka && bm + r < M;
    const bool ob = ka && bn + r < N;
    cp_async16(As + r * kS8Ld + c, A + (oa ? static_cast<size_t>(bm + r) * K + k0 + c : 0),
               oa ? 16 : 0);
    cp_async16(Bs + r * kS8Ld + c, B + (ob ? static_cast<size_t>(bn + r) * K + k0 + c : 0),
               ob ? 16 : 0);
  }
  cp_async_commit();
}

template <int EPI>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_s8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                   const float* __restrict__ sr, const float* __restrict__ sc,
                   const float* __restrict__ bias, const bf16* __restrict__ R,
                   bf16* __restrict__ C, float* __restrict__ F,
                   int8_t* __restrict__ Q, int M, int N, int K, int group_stages) {
  constexpr bool kGroups = EPI == kS8GroupF32 || EPI == kS8GroupF32T || EPI == kS8GroupF32RC;
  __shared__ __align__(128) int8_t smem[4 * kS8Tile];  // A[2], B[2]
  int8_t* As[2] = {smem, smem + kS8Tile};
  int8_t* Bs[2] = {smem + 2 * kS8Tile, smem + 3 * kS8Tile};
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in group
  const int bm = blockIdx.y * kGemmBM;
  const int bn = blockIdx.x * kGemmBN;
  const int wm = (warp / 4) * 64;
  const int wn = (warp % 4) * 32;

  int acc[4][4][4];
  float facc[4][4][4];  // kGroups only; dead otherwise
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0, facc[i][j][r] = 0.f;

  const int nk = (K + kS8BK - 1) / kS8BK;
  if (nk > 0) gemm_s8_load_tile(As[0], Bs[0], A, B, bm, bn, 0, M, N, K);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      gemm_s8_load_tile(As[(kt + 1) & 1], Bs[(kt + 1) & 1], A, B, bm, bn, (kt + 1) * kS8BK, M, N,
                        K);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* as = As[kt & 1];
    const int8_t* bs = Bs[kt & 1];
#pragma unroll
    for (int ks = 0; ks < kS8BK; ks += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = as + (wm + i * 16 + g) * kS8Ld + ks + t * 4;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kS8Ld);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kS8Ld + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = bs + (wn + j * 8 + g) * kS8Ld + ks + t * 4;
        b[j][0] = *reinterpret_cast<const uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8_16832(acc[i][j], a[i], b[j]);
    }
    __syncthreads();  // the next iteration's load overwrites this stage
    if (kGroups && (kt + 1) % group_stages == 0) {  // the end of group z
      const int z = kt / group_stages;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = bm + wm + i * 16 + g + 8 * h;
          const float s = row < M ? sr[static_cast<size_t>(z) * M + row] : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = __fmul_rn(static_cast<float>(acc[i][j][2 * h + e]), s);
              if (EPI == kS8GroupF32RC) {
                const int col = bn + wn + j * 8 + 2 * t + e;
                v = __fmul_rn(v, col < N ? sc[static_cast<size_t>(z) * N + col] : 0.f);
              }
              facc[i][j][2 * h + e] += v;
              acc[i][j][2 * h + e] = 0;
            }
        }
    }
  }

  // accumulator c[2h], c[2h+1]: row g + 8h, columns 2t, 2t+1 of each 16x8 tile
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = bm + wm + i * 16 + g + 8 * h;
      if (row >= M) continue;
      if (kGroups) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = bn + wn + j * 8 + 2 * t;
          if (col >= N) continue;
          if (EPI == kS8GroupF32T) {
            F[static_cast<size_t>(col) * M + row] = facc[i][j][2 * h];
            F[static_cast<size_t>(col + 1) * M + row] = facc[i][j][2 * h + 1];
          } else {
            *reinterpret_cast<float2*>(F + static_cast<size_t>(row) * N + col) =
                make_float2(facc[i][j][2 * h], facc[i][j][2 * h + 1]);
          }
        }
        continue;
      }
      const float srow = EPI == kS8GpqGrad ? __fmul_rn(sr[row], kGpDequant) : sr[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = bn + wn + j * 8 + 2 * t;
        if (col >= N) continue;
        const size_t off = static_cast<size_t>(row) * N + col;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // the twin's order, each step one _rn rounding
          const float a = __fmul_rn(static_cast<float>(acc[i][j][2 * h + e]), srow);
          v[e] = EPI != kS8GpqGrad && bias != nullptr
                     ? __fmaf_rn(a, sc[col + e], bias[col + e])
                     : __fmul_rn(a, sc[col + e]);
        }
        if (EPI == kS8GeluQF32 && Q != nullptr) {
          const float2 gq = make_float2(gelu_grad_q(v[0]) * kGpQScale,
                                        gelu_grad_q(v[1]) * kGpQScale);
          char2 q2;
          q2.x = static_cast<signed char>(fminf(fmaxf(rintf(gq.x), -127.f), 127.f));
          q2.y = static_cast<signed char>(fminf(fmaxf(rintf(gq.y), -127.f), 127.f));
          *reinterpret_cast<char2*>(Q + off) = q2;
        }
        if (EPI == kS8F32 || EPI == kS8GeluQF32 || EPI == kS8GpqGrad) {
          float f[2] = {v[0], v[1]};
          if (EPI == kS8GeluQF32) f[0] = gelu_q(v[0]), f[1] = gelu_q(v[1]);
          if (EPI == kS8GpqGrad) {
            const char2 q2 = *reinterpret_cast<const char2*>(Q + off);
            f[0] = v[0] * static_cast<float>(q2.x);
            f[1] = v[1] * static_cast<float>(q2.y);
          }
          *reinterpret_cast<float2*>(F + off) = make_float2(f[0], f[1]);
          v[0] = f[0], v[1] = f[1];
        }
        if (EPI == kS8Bf16 || EPI == kS8Residual || EPI == kS8GpqGrad) {
          float o[2] = {v[0], v[1]};
          if (EPI == kS8Residual) {
            const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(R + off);
            o[0] = __bfloat162float(r.x) + __bfloat162float(__float2bfloat16(v[0]));
            o[1] = __bfloat162float(r.y) + __bfloat162float(__float2bfloat16(v[1]));
          }
          *reinterpret_cast<__nv_bfloat162*>(C + off) = __floats2bfloat162_rn(o[0], o[1]);
        }
      }
    }
  }
}

// C/F[M,N] = epilogue(f32(A[M,K] @ B[N,K]^T) * sr[M] * sc[N] (+ bias[N])).
// bias may be null (no bias); R, C, F, Q as the epilogue reads/writes
// them (Q: the int8 GELU' codes [M,N] of kS8GeluQF32, optional, and of
// kS8GpqGrad).
template <int EPI>
cudaError_t launch_gemm_s8(const int8_t* A, const int8_t* B, const float* sr, const float* sc,
                           const float* bias, const bf16* R, bf16* C, float* F,
                           int M, int N, int K, cudaStream_t stream, int8_t* Q = nullptr) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (K % 16 || N % 2 || EPI == kS8GroupF32 || EPI == kS8GroupF32T || EPI == kS8GroupF32RC)
    return cudaErrorInvalidValue;
  const dim3 grid((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM);
  gemm_s8_kernel<EPI>
      <<<grid, kGemmThreads, 0, stream>>>(A, B, sr, sc, bias, R, C, F, Q, M, N, K, 0);
  const cudaError_t launched = cudaGetLastError();
  if (launched == cudaSuccess) ++first_design_launches[0];
  return launched;
}

// The int8_dw product: F[M,N] = sum over groups z of f32(A_z @ B_z^T) * s[z*M + m],
// A [M, K] and B [N, K] int8 with K = groups * gp, group z the K columns
// [z*gp, (z+1)*gp) (zero past its rows); gp % 64 == 0. With `transpose`, F
// is written as [N, M]; with column scales sc [groups, N] (not null), each
// group's term is also multiplied by sc[z*N + n] (kS8GroupF32RC).
inline cudaError_t launch_gemm_s8_groups(const int8_t* A, const int8_t* B, const float* s,
                                         float* F, int M, int N, int K, int gp,
                                         cudaStream_t stream, bool transpose = false,
                                         const float* sc = nullptr) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (gp <= 0 || gp % kS8BK || K % gp || N % 2 || (sc != nullptr && transpose))
    return cudaErrorInvalidValue;
  const dim3 grid((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM);
  if (sc != nullptr)
    gemm_s8_kernel<kS8GroupF32RC><<<grid, kGemmThreads, 0, stream>>>(
        A, B, s, sc, nullptr, nullptr, nullptr, F, nullptr, M, N, K, gp / kS8BK);
  else if (transpose)
    gemm_s8_kernel<kS8GroupF32T><<<grid, kGemmThreads, 0, stream>>>(
        A, B, s, nullptr, nullptr, nullptr, nullptr, F, nullptr, M, N, K, gp / kS8BK);
  else
    gemm_s8_kernel<kS8GroupF32><<<grid, kGemmThreads, 0, stream>>>(
        A, B, s, nullptr, nullptr, nullptr, nullptr, F, nullptr, M, N, K, gp / kS8BK);
  const cudaError_t launched = cudaGetLastError();
  if (launched == cudaSuccess) ++first_design_launches[0];
  return launched;
}

}  // namespace vitax
