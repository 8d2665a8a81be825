// A Hopper GEMM on warpgroup MMAs: the bf16 products of K1's and K2's
// backwards (ln_qkvo_attention_bwd.cu, ln_mlp_bwd.cu) and, since their
// redesign, of K1's and K2's forwards and K12's (ln_qkvo_attention.cu with
// kv_heads == heads, ln_mlp.cu, ln_mlp_save.cu) and of K8's bf16 pair on
// the column slices of Wqkv (ln_qkvo_attention_rect{,_bwd}.cu); and, in its
// own section below, the s8 products of K3's backward with kv_heads == heads and K4's
// (ln_qkvo_attention_int8_bwd.cu, ln_mlp_int8_bwd.cu), their bf16 weight
// grads on the kTN path here. Every other kernel keeps gemm.cuh's WMMA and
// mma.sync products. The TPU kernels compute these products in their own
// bodies with jnp.dot / dot_general(..., preferred_element_type=f32 or
// int32); here each is one launch over the whole [M, N] output.
//
// Layouts, all row-major bf16 in memory, none transposed in device memory:
//   kNN  C[M,N] = A[M,K]   · B[K,N]    xn·Wqkv
//   kNT  C[M,N] = A[M,K]   · B[N,K]ᵀ   do·Woᵀ, dqkv·Wqkvᵀ, dh1·W1ᵀ
//   kTN  C[M,N] = A[K,M]ᵀ  · B[K,N]    weight grads over all rows (K ragged)
// and the dual product of K2's backward: for one [M, N] output tile,
// a1 = A·B (kNN, xn·W1) and dh1f = A2·B2ᵀ (kNT, do·W2ᵀ) accumulate side by
// side over the same K, and the epilogue writes h1 = bf16(gelu(a1 + b1)) and
// dh1 = bf16(dh1f·gelu'(a1 + b1)), both in fp32 math (vitax's stages 2–4,
// pallas_kernels.py:1335-1350), so a1 never reaches device memory.
//
// Bound on the H100: the tensor cores at the ViT shapes (K and N 768..5120,
// M = B·spq rows: 380 and more operations a byte). Design: a block of two
// consumer warpgroups owns a 128×128 output tile, 64 rows a warpgroup, its
// fp32 accumulators in registers (64 a thread; 128 with the dual product),
// and a producer warp keeps the operands' TMA loads in flight: a ring of
// 64-deep K tiles (four stages of 32 KB, three of 64 KB for the dual
// product), each stage with a `full` mbarrier that the copies' bytes
// complete and an `empty` one that both warpgroups arrive on once their
// products have read it. Every product is wgmma.mma_async m64n128k16 with
// both operands in shared memory in the 128-byte swizzle that the TMA
// writes; wgmma's transpose bits read a tile K-major (rows of 64 K) or
// MN-major (boxes of 64 M or N by 64 K), so there is no transposed copy.
// The TMA zero-fills what lies past a matrix, which masks every ragged edge
// (rows, N, kTN's K) on the way in; the epilogue stages each warpgroup's
// tile through shared memory (the ring, free by then), applies the
// epilogue in fp32 and writes 16-byte rows, the edges masked.
// The forwards' epilogues: bias (qkv, the out-projection, fc2 without the
// residual), bias + exact-erf GELU (fc1: h1 = bf16(gelu(acc + b1))), the
// same with g' = bf16(gelu'(acc + b1)) beside h1 (K12's fc1), and bias +
// residual (fc2: out = bf16(x + bf16(acc + b2)), the add of two bf16 values
// in fp32, then one rounding); the math in fp32 at the TPU kernels' rounding
// points (pallas_kernels.py:608-615, :649).
// ptxas: 90 registers a thread (111 for kNT into bf16), 159 with the dual
// product, no spills. Its rate at ViT-B/16's b32 shapes, and with its
// copies or its products cut: `python -m
// vitax_torch.scripts.gemm_sm90_ablations` (PERF.md). A first version
// filled the ring with cp.async from every thread in the no-swizzle layout
// and was bound by those copies.
//
// kTN keeps gemm.cuh's split of K over gridDim.z (gemm_tn_splits, the same
// 128×128 tiles, so the same workspace): each split writes an fp32 partial
// and sum_splits_kernel adds them in split order. No float atomics: two runs
// give the same bits.
#pragma once

#include <cuda.h>

#include "attention_core.cuh"
#include "gemm.cuh"

namespace vitax {
namespace sm90 {

using k13::fence_regs;
using k13::wg_commit;
using k13::wg_fence;
using k13::wg_wait;

constexpr int kBM = 128;       // rows of a block tile: two warpgroups of 64
constexpr int kBN = 128;       // columns: one m64n128 wgmma a k-step
constexpr int kThreads = 256;  // two warpgroups

enum Epi : int {
  kEpiBias = 0,      // C = bf16(acc + bias)
  kEpiStore = 1,     // C = bf16(acc)
  kEpiF32 = 2,       // F = acc (with split K, F is split z's partial)
  kEpiGeluPair = 3,  // the dual product: a = acc + bias, C = bf16(gelu(a)), C2 = bf16(acc2·gelu'(a))
  kEpiBiasGelu = 4,      // a = acc + bias, C = bf16(gelu(a))
  kEpiBiasGeluSave = 5,  // a = acc + bias, C = bf16(gelu(a)), C2 = bf16(gelu'(a))
  kEpiBiasResidual = 6,  // C = bf16(R + bf16(acc + bias)), R bf16 [M, N], the add in fp32 of bf16 values
};

// Ring stages: a K tile is 64 deep (one 128-byte swizzle row of bf16); a
// single product stages 32 KB a tile in four stages (128 KB;
// gemm_sm90_ablations times six), the dual product 64 KB a tile (two A and two B tiles) in
// three. One block an SM.
constexpr int kBK = 64;
template <bool kDual>
constexpr int kStages = kDual ? 3 : 4;
template <bool kDual>
constexpr int kStageBytes = (kDual ? 2 : 1) * (kBM + kBN) * kBK * 2;
// the ring (1024-byte aligned for the swizzle), then its barriers
template <bool kDual>
constexpr size_t kSmemBytes = 1024 + kStages<kDual> * kStageBytes<kDual> + 2 * kStages<kDual> * 8;

struct GemmArgs {
  const float* bias;
  const bf16* R;  // kEpiBiasResidual's residual [M, N]
  bf16* C;
  bf16* C2;
  float* F;
  int M, N, K, k_chunk;
};

// The operands as TMA tensor maps, boxes of 64 columns (128 bytes, the swizzle
// width) by 128 rows (K-major tiles: A of kNN/kNT, B of kNT, the dual
// product's A2 and B2) or 64 rows (MN-major tiles, two boxes side by side:
// B of kNN/kTN, A of kTN).
struct Maps {
  CUtensorMap a, b, a2, b2;
};

#define VX_SM90_F4(i) "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define VX_SM90_F16(i) VX_SM90_F4(i), VX_SM90_F4((i) + 4), VX_SM90_F4((i) + 8), VX_SM90_F4((i) + 12)
#define VX_SM90_F64(i) VX_SM90_F16(i), VX_SM90_F16((i) + 16), VX_SM90_F16((i) + 32), VX_SM90_F16((i) + 48)

// d[64] (64×128, fp32) += A·B, both from shared memory; TA / TB: 1 reads
// the operand MN-major (wgmma's transpose bits, 16-bit types only)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : VX_SM90_F64(0)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

#undef VX_SM90_F4
#undef VX_SM90_F16
#undef VX_SM90_F64

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A descriptor of a 128-byte-swizzled operand (layout type 1): K-major tiles
// are rows of 64 K (stride offset 1024, the 8-row swizzle atom; the leading
// offset unused); MN-major tiles are atoms of 64 M or N by 8 K rows (leading
// offset: from one 64-wide atom to the next along M or N; stride offset 1024,
// from one 8-row group of K to the next).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
}

// The box at (column c0, row c1) of a map into dst, counted on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// Descriptors of warpgroup wg's A operand and of the B operand at k-step kk
// (16 deep) of a stage: A [kBM rows][64 K] K-major, or for kTN two MN-major
// boxes [64 K][64 M], warpgroup wg's the box wg; B [kBN rows][64 K] K-major
// for kNT, else two MN-major boxes [64 K][64 N].
template <int LAYOUT>
__device__ __forceinline__ uint64_t desc_a(const unsigned char* t, int wg, int kk) {
  if (LAYOUT == kTN) return desc_sw128(t + wg * 8192 + kk * 2048, 8192);
  return desc_sw128(t + wg * 8192 + kk * 32, 16);
}
template <int LAYOUT>
__device__ __forceinline__ uint64_t desc_b(const unsigned char* t, int kk) {
  if (LAYOUT == kNT) return desc_sw128(t + kk * 32, 16);
  return desc_sw128(t + kk * 2048, 8192);
}

// One block a 128×128 tile of C (blockIdx.x along N, y along M) and a K
// split (z): K rows [z·k_chunk, min(K, (z + 1)·k_chunk)), k_chunk a
// multiple of 64, so a tile never straddles two splits. Warps 0–7 are the
// two consumer warpgroups; lane 0 of warp 8 is the producer, which keeps the
// ring's TMA loads in flight: stage s is refilled once both warpgroups have
// released it (`empty`), and its bytes land on `full`.
template <int LAYOUT, int EPI, bool kDual>
__global__ void __launch_bounds__(kThreads + 32, 1)
    gemm_sm90_kernel(const __grid_constant__ Maps maps, const GemmArgs g) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int S = kStages<kDual>;
  constexpr int kTile = kBM * kBK * 2;  // 16 KB: a 128×64 tile or two 64×64 boxes
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * kStageBytes<kDual>);
  uint64_t* empty = full + S;
  const int bm = blockIdx.y * kBM;
  const int bn = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * g.k_chunk;
  const int k_end = min(g.K, k_begin + g.k_chunk);
  const int nk = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kThreads) {  // the producer
    if (threadIdx.x == kThreads) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % S;
        if (t >= S) mbar_wait(empty + s, (t / S - 1) & 1);
        unsigned char* st = ring + s * kStageBytes<kDual>;
        const int k0 = k_begin + t * kBK;
        mbar_expect_tx(full + s, kStageBytes<kDual>);
        if (LAYOUT == kTN) {
          tma_load(st, &maps.a, bm, k0, full + s);
          tma_load(st + 8192, &maps.a, bm + 64, k0, full + s);
        } else {
          tma_load(st, &maps.a, k0, bm, full + s);
        }
        if (LAYOUT == kNT) {
          tma_load(st + kTile, &maps.b, k0, bn, full + s);
        } else {
          tma_load(st + kTile, &maps.b, bn, k0, full + s);
          tma_load(st + kTile + 8192, &maps.b, bn + 64, k0, full + s);
        }
        if (kDual) {
          tma_load(st + 2 * kTile, &maps.a2, k0, bm, full + s);
          tma_load(st + 3 * kTile, &maps.b2, k0, bn, full + s);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  float acc[64];
  float acc2[kDual ? 64 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kDual ? 64 : 1); ++i) acc2[i] = 0.f;

  for (int t = 0; t < nk; ++t) {
    const int s = t % S;
    mbar_wait(full + s, (t / S) & 1);
    const unsigned char* st = ring + s * kStageBytes<kDual>;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_m64n128<LAYOUT == kTN ? 1 : 0, LAYOUT == kNT ? 0 : 1>(
          acc, desc_a<LAYOUT>(st, wg, kk), desc_b<LAYOUT>(st + kTile, kk));
    if constexpr (kDual) {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_m64n128<0, 0>(acc2, desc_a<kNN>(st + 2 * kTile, wg, kk),
                            desc_b<kNT>(st + 3 * kTile, kk));
    }
    wg_commit();
    wg_wait<1>();  // tile t − 1's products are done: release its stage
    if (t > 0) mbar_arrive(empty + (t - 1) % S);
  }
  wg_wait<0>();
  fence_regs<64>(acc);
  if constexpr (kDual) fence_regs<64>(acc2);
  // both warpgroups are done with the ring: it stages the epilogue
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");

  const int tid = threadIdx.x % 128;
  const int row0 = bm + wg * 64;
  if constexpr (EPI == kEpiF32) {
    constexpr int kLd = kBN + 4;
    float* buf = reinterpret_cast<float*>(ring) + wg * 64 * kLd;
#pragma unroll
    for (int i = 0; i < 64; i += 2)
      *reinterpret_cast<float2*>(buf + k13::acc_row(i) * kLd + k13::acc_col(i)) =
          make_float2(acc[i], acc[i + 1]);
    asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
    float* F = g.F + static_cast<size_t>(blockIdx.z) * g.M * g.N;
    for (int c = tid; c < 64 * (kBN / 4); c += 128) {
      const int r = c / (kBN / 4);
      const int col = (c % (kBN / 4)) * 4;
      if (row0 + r < g.M && bn + col < g.N)
        *reinterpret_cast<float4*>(F + static_cast<size_t>(row0 + r) * g.N + bn + col) =
            *reinterpret_cast<const float4*>(buf + r * kLd + col);
    }
  } else {
    constexpr int kLd = kBN + 8;
    constexpr bool kTwo = EPI == kEpiGeluPair || EPI == kEpiBiasGeluSave;  // writes C2
    bf16* buf = reinterpret_cast<bf16*>(ring) + wg * 64 * kLd;
    bf16* buf2 = buf + 2 * 64 * kLd;  // the second output (C2)
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int col = k13::acc_col(i);
      const int off = k13::acc_row(i) * kLd + col;
      float v0 = acc[i], v1 = acc[i + 1];
      if (EPI != kEpiStore) {
        const bool ok = bn + col < g.N;
        v0 += ok ? g.bias[bn + col] : 0.f;
        v1 += ok ? g.bias[bn + col + 1] : 0.f;
      }
      if constexpr (EPI == kEpiGeluPair) {
        *reinterpret_cast<__nv_bfloat162*>(buf + off) =
            __floats2bfloat162_rn(gelu_erf(v0), gelu_erf(v1));
        *reinterpret_cast<__nv_bfloat162*>(buf2 + off) = __floats2bfloat162_rn(
            acc2[i] * gelu_erf_grad(v0), acc2[i + 1] * gelu_erf_grad(v1));
      } else if constexpr (EPI == kEpiBiasGelu || EPI == kEpiBiasGeluSave) {
        *reinterpret_cast<__nv_bfloat162*>(buf + off) =
            __floats2bfloat162_rn(gelu_erf(v0), gelu_erf(v1));
        if (EPI == kEpiBiasGeluSave)
          *reinterpret_cast<__nv_bfloat162*>(buf2 + off) =
              __floats2bfloat162_rn(gelu_erf_grad(v0), gelu_erf_grad(v1));
      } else {  // kEpiBiasResidual adds R to this bf16 value on the way out
        *reinterpret_cast<__nv_bfloat162*>(buf + off) = __floats2bfloat162_rn(v0, v1);
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
    for (int c = tid; c < 64 * (kBN / 8); c += 128) {
      const int r = c / (kBN / 8);
      const int col = (c % (kBN / 8)) * 8;
      if (row0 + r < g.M && bn + col < g.N) {
        const size_t o = static_cast<size_t>(row0 + r) * g.N + bn + col;
        uint4 v = *reinterpret_cast<const uint4*>(buf + r * kLd + col);
        if constexpr (EPI == kEpiBiasResidual) {
          const uint4 res = *reinterpret_cast<const uint4*>(g.R + o);
          const auto* y2 = reinterpret_cast<const __nv_bfloat162*>(&v);
          const auto* r2 = reinterpret_cast<const __nv_bfloat162*>(&res);
          uint4 sum;
          auto* s2 = reinterpret_cast<__nv_bfloat162*>(&sum);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 a = __bfloat1622float2(r2[j]), b = __bfloat1622float2(y2[j]);
            s2[j] = __floats2bfloat162_rn(a.x + b.x, a.y + b.y);
          }
          v = sum;
        }
        *reinterpret_cast<uint4*>(g.C + o) = v;
        if (kTwo)
          *reinterpret_cast<uint4*>(g.C2 + o) =
              *reinterpret_cast<const uint4*>(buf2 + r * kLd + col);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time: the library links against
// the CUDA runtime alone
inline decltype(&cuTensorMapEncodeTiled) tensor_map_encoder() {
  static const auto fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<decltype(&cuTensorMapEncodeTiled)>(p);
  }();
  return fn;
}

// The map of a row-major matrix [rows, cols] of bf16 (or, with `s8`, of
// int8 codes; row stride ld elements) in boxes of 128 bytes (the swizzle
// width: 64 bf16 or 128 int8 columns) × box_rows rows, 128-byte swizzle;
// elements past the matrix read as zeros
inline bool make_map(CUtensorMap* map, const void* base, int rows, int cols, int ld,
                     int box_rows, bool s8 = false) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const int bytes = s8 ? 1 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, s8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Operands of a launch: A, B (and the dual product's A2 [M, K], B2 [N, K])
// with their row strides
struct Operands {
  const bf16* A;
  const bf16* B;
  const bf16* A2;
  const bf16* B2;
  int lda, ldb, lda2, ldb2;
};

template <int LAYOUT, int EPI, bool kDual>
cudaError_t launch(const Operands& op, const GemmArgs& g, int splits, cudaStream_t st) {
  if (g.M == 0 || g.N == 0) return cudaSuccess;
  // TMA: 16-byte aligned rows, so every row stride a multiple of 8 (N, and
  // K or, for kTN, M, which are the strides here)
  if (op.lda % 8 || op.ldb % 8 || (kDual && (op.lda2 % 8 || op.ldb2 % 8)) ||
      (LAYOUT == kTN && g.k_chunk % kBK))
    return cudaErrorInvalidValue;
  Maps maps{};
  const bool ok =
      (LAYOUT == kTN ? make_map(&maps.a, op.A, g.K, g.M, op.lda, 64)
                     : make_map(&maps.a, op.A, g.M, g.K, op.lda, kBM)) &&
      (LAYOUT == kNT ? make_map(&maps.b, op.B, g.N, g.K, op.ldb, kBN)
                     : make_map(&maps.b, op.B, g.K, g.N, op.ldb, 64)) &&
      (!kDual || (make_map(&maps.a2, op.A2, g.M, g.K, op.lda2, kBM) &&
                  make_map(&maps.b2, op.B2, g.N, g.K, op.ldb2, kBN)));
  if (!ok) return cudaErrorInvalidValue;
  constexpr size_t smem = kSmemBytes<kDual>;
  const cudaError_t e = cudaFuncSetAttribute(gemm_sm90_kernel<LAYOUT, EPI, kDual>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((g.N + kBN - 1) / kBN, (g.M + kBM - 1) / kBM, splits);
  gemm_sm90_kernel<LAYOUT, EPI, kDual><<<grid, kThreads + 32, smem, st>>>(maps, g);
  return cudaGetLastError();
}

// C = epilogue(A[M,K] · B[K,N]): kEpiBias, kEpiStore, kEpiBiasGelu (C),
// kEpiBiasGeluSave (C and C2), kEpiBiasResidual (C, residual R [M, N]) or
// kEpiF32 (F). ldb is B's row stride (0: N), so B may be a column slice of
// a wider weight read in place (K8's Q and KV slices of Wqkv); the TMA map
// is N columns wide, so nothing past the slice is read.
template <int EPI>
cudaError_t gemm_nn(const bf16* A, const bf16* B, const float* bias, bf16* C, float* F, int M,
                    int N, int K, cudaStream_t st, const bf16* R = nullptr,
                    bf16* C2 = nullptr, int ldb = 0) {
  if (ldb != 0 && ldb < N) return cudaErrorInvalidValue;
  const Operands op{A, B, nullptr, nullptr, K, ldb == 0 ? N : ldb, 0, 0};
  GemmArgs g{};
  g.bias = bias, g.R = R, g.C = C, g.C2 = C2, g.F = F;
  g.M = M, g.N = N, g.K = K, g.k_chunk = K;
  return launch<kNN, EPI, false>(op, g, 1, st);
}

// C = epilogue(A[M,K] · B[N,K]ᵀ): kEpiStore (C) or kEpiF32 (F). ldb is B's
// row stride (0: K), so B may be a column slice of a wider weight (K8's
// backward contracts over the Q and KV slices of Wqkv); the map is K wide.
template <int EPI>
cudaError_t gemm_nt(const bf16* A, const bf16* B, bf16* C, float* F, int M, int N, int K,
                    cudaStream_t st, int ldb = 0) {
  if (ldb != 0 && ldb < K) return cudaErrorInvalidValue;
  const Operands op{A, B, nullptr, nullptr, K, ldb == 0 ? K : ldb, 0, 0};
  GemmArgs g{};
  g.C = C, g.F = F;
  g.M = M, g.N = N, g.K = K, g.k_chunk = K;
  return launch<kNT, EPI, false>(op, g, 1, st);
}

// Weight grads: F[M,N] = A[K,M]ᵀ · B[K,N] in fp32 over K = all rows
// (ragged), split as gemm.cuh's launch_gemm_tn; ws holds
// gemm_tn_workspace(M, N, K) floats.
inline cudaError_t gemm_tn(const bf16* A, const bf16* B, float* F, float* ws, int M, int N, int K,
                           cudaStream_t st) {
  const int splits = gemm_tn_splits(M, N, K);
  const Operands op{A, B, nullptr, nullptr, M, N, 0, 0};
  GemmArgs g{};
  g.F = splits == 1 ? F : ws;
  g.M = M, g.N = N, g.K = K;
  g.k_chunk = (K + splits * kBK - 1) / (splits * kBK) * kBK;
  cudaError_t e = launch<kTN, kEpiF32, false>(op, g, splits, st);
  if (e != cudaSuccess || splits == 1) return e;
  const size_t count = static_cast<size_t>(M) * N;
  const int blocks = static_cast<int>((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  sum_splits_kernel<0><<<blocks, 256, 0, st>>>(ws, F, count, splits);
  return cudaGetLastError();
}

// K2's backward pair over one K = d: a = xn[n,d] · W1[d,m] + b1,
// h1 = bf16(gelu(a)), dh1 = bf16((do[n,d] · W2[m,d]ᵀ) · gelu'(a)), [n, m] each
inline cudaError_t gemm_gelu_pair(const bf16* xn, const bf16* w1, const float* b1,
                                  const bf16* dout, const bf16* w2, bf16* h1, bf16* dh1, int n,
                                  int m, int d, cudaStream_t st) {
  const Operands op{xn, w1, dout, w2, d, m, d, d};
  GemmArgs g{};
  g.bias = b1, g.C = h1, g.C2 = dh1;
  g.M = n, g.N = m, g.K = d, g.k_chunk = d;
  return launch<kNN, kEpiGeluPair, true>(op, g, 1, st);
}

// =============================================================================
// s8 products of the W8A8 tiers (K3's forward and backward with kv_heads ==
// heads, K4's forward and backward, and K5's two halves):
// C[M,N] = A[M,K]·B[N,K]ᵀ, both int8 codes read K-major. 8-bit wgmma has no
// transpose bits, and every int8 product of those backwards already has this
// layout: the weight quantizers store their codes [N, K] (quant.cuh), the
// row codes of xq, aq, h1q, do, dqkv and dh1 are [rows, K], and dw_int8.cuh
// transposes the weight grads' operands to [W, kp]. The block is the bf16 products': two
// consumer warpgroups own a 128×128 tile, the producer warp keeps the TMA
// ring full; a K tile is 128 codes deep (one 128-byte swizzle row, so a stage
// is 32 KB a product as the bf16 one), each k-step one
// wgmma.mma_async m64n128k32.s32.s8.s8 with int32 accumulators in registers
// (the descriptors are the bf16 kNT ones: 32 bytes a k-step). The int32 sums
// are exact (|acc| <= 127²·K), so two runs give the same bits. The
// epilogues dequantize as gemm.cuh's s8 GEMM and the plain twins
// (ops/cuda_kernels.py `_dequant`) order it, f32(acc)·sr[m]·sc[n], the bias
// add fused with the last multiply, each step an explicit _rn intrinsic:
//   kEpiS8Bf16      C = bf16(dq(acc) (+ bias))     K3's qkv (forward and
//                                                  recompute), out, dattn;
//                                                  K4's fc2 without residual
//   kEpiS8F32       F = dq(acc) (+ bias)           dxn
//   kEpiS8GeluPair  K4's dual product, two accumulators over the same K (D):
//                   a1 = dq(xq·W1cᵀ) + b1 and dh1f = dq2(doq·W2rᵀ) (the
//                   scales sr2, sc2); C = bf16(gelu_q(a1)) (h1), F = dh1_32 =
//                   dh1f·gelu_q'(a1) (its row codes and db1 read it) and, for
//                   the bf16 dW1 (C2 null under int8_dw), C2 = bf16(dh1_32);
//                   a1 never reaches device memory (vitax :1155-1169,
//                   and K11-B's :1017-1040 on the int4 grid's codes)
//   kEpiS8Group     the int8_dw weight grads: K is groups of group_tiles K
//                   tiles (each group's rows zero-padded to whole tiles); at
//                   a group's end its int32 sum is folded into an fp32 one,
//                   F += f32(acc)·sr[z·M + m] (__fmul_rn, never contracted
//                   into the add), groups in order, as gemm.cuh's
//                   kS8GroupF32: no split of K, no partials, no atomics. The
//                   fold waits for the group's last product, so the tensor
//                   cores idle through it (K4's groups are one K tile deep).
//   kEpiS8GroupRC   the int4_grad backwards' int8_dw (K11-B, K11-D, G-B,
//                   R-B): both operands packed per column over each group,
//                   so each group folds with two scale vectors, F +=
//                   (f32(acc)·sr[z·M + m])·sc[z·N + n], each product
//                   __fmul_rn in that order, as gemm.cuh's kS8GroupF32RC
//                   (and vitax, pallas_kernels.py:3036-3040): on the same
//                   packs the same bits
//   kEpiS8GeluQF32  K4's forward fc1: F = gelu_q(dq(acc) + b1) in fp32, the
//                   sigmoid GELU a·σ(1.702a) (gemm.cuh's kS8GeluQF32 without
//                   its K12 codes)
//   kEpiS8Residual  K4's forward fc2: C = bf16(R + bf16(dq(acc) + b2)), the
//                   add of two bf16 values in fp32 and one rounding, as
//                   gemm.cuh's kS8Residual (vitax :715-721); R [M, N] bf16 is
//                   read in the store loop, 16 bytes a thread
//   kEpiS8ResidualF32 K5's out-projection and fc2: C = bf16(f32(R) +
//                   (dq(acc) + bias)), the handoff's rounding: the add in
//                   fp32, one rounding (vitax :3721-3722, :3760-3761); y
//                   stays fp32 (staged as kEpiS8F32's) and R [M, N] bf16 is
//                   read in the store loop only, never through the TMA ring,
//                   so R may be the stream whose codes are A
// Rows M and K are ragged (the TMA zero-fills), N % 8 == 0 (16-byte stores),
// K % 16 == 0 (16-byte TMA rows). No file that includes this header may be
// built with --use_fast_math (quant.cuh).
// =============================================================================

enum EpiS8 : int {
  kEpiS8Bf16 = 0,
  kEpiS8F32 = 1,
  kEpiS8GeluPair = 2,
  kEpiS8Group = 3,
  kEpiS8GeluQF32 = 4,
  kEpiS8Residual = 5,
  kEpiS8ResidualF32 = 6,
  kEpiS8GroupRC = 7,
};

// Launches of gemm_s8_sm90_kernel by epilogue, one added where launch_s8
// launches it (every translation unit that includes this header shares the
// one array); read and reset through gemm_sm90_s8.cu's
// vitax_gemm_sm90_s8_launches
inline long long s8_launches[8] = {};

constexpr int kBK8 = 128;  // codes of a K tile

struct GemmS8Args {
  const float* sr;    // [M] (kEpiS8Group, kEpiS8GroupRC: [groups, M])
  const float* sc;    // [N] (kEpiS8GroupRC: [groups, N])
  const float* bias;  // [N] or null
  const float* sr2;   // kEpiS8GeluPair's second product: [M]
  const float* sc2;   // [N]
  const bf16* R;      // kEpiS8Residual's and kEpiS8ResidualF32's residual [M, N]
  bf16* C;
  bf16* C2;
  float* F;
  int M, N, K, group_tiles;
};

#define VX_S8_R4(i) "+r"(d[(i)]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]), "+r"(d[(i) + 3])
#define VX_S8_R16(i) VX_S8_R4(i), VX_S8_R4((i) + 4), VX_S8_R4((i) + 8), VX_S8_R4((i) + 12)
#define VX_S8_R64(i) VX_S8_R16(i), VX_S8_R16((i) + 16), VX_S8_R16((i) + 32), VX_S8_R16((i) + 48)

// d[64] (64×128, int32) += A·B, both K-major int8 in shared memory
__device__ __forceinline__ void wgmma_s8_m64n128(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : VX_S8_R64(0)
      : "l"(a), "l"(b), "r"(1));
}

#undef VX_S8_R4
#undef VX_S8_R16
#undef VX_S8_R64

template <int N>
__device__ __forceinline__ void fence_regs_s32(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// f32(acc)·sr·sc, and with a bias fma(f32(acc)·sr, sc, bias)
__device__ __forceinline__ float dequant(int acc, float sr, float sc) {
  return __fmul_rn(__fmul_rn(static_cast<float>(acc), sr), sc);
}
__device__ __forceinline__ float dequant(int acc, float sr, float sc, float bias) {
  return __fmaf_rn(__fmul_rn(static_cast<float>(acc), sr), sc, bias);
}

// One block a 128×128 tile of C (blockIdx.x along N, y along M), all of K;
// warps 0–7 the consumers, lane 0 of warp 8 the producer, as
// gemm_sm90_kernel.
template <int EPI>
__global__ void __launch_bounds__(kThreads + 32, 1)
    gemm_s8_sm90_kernel(const __grid_constant__ Maps maps, const GemmS8Args g) {
  constexpr bool kDual = EPI == kEpiS8GeluPair;
  constexpr bool kGroups = EPI == kEpiS8Group || EPI == kEpiS8GroupRC;
  constexpr int S = kStages<kDual>;
  constexpr int kBytes = kStageBytes<kDual>;
  constexpr int kTile = kBM * kBK8;  // 16 KB: 128 rows × 128 codes
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * kBytes);
  uint64_t* empty = full + S;
  const int bm = blockIdx.y * kBM;
  const int bn = blockIdx.x * kBN;
  const int nk = (g.K + kBK8 - 1) / kBK8;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kThreads) {  // the producer
    if (threadIdx.x == kThreads) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % S;
        if (t >= S) mbar_wait(empty + s, (t / S - 1) & 1);
        unsigned char* st = ring + s * kBytes;
        const int k0 = t * kBK8;
        mbar_expect_tx(full + s, kBytes);
        tma_load(st, &maps.a, k0, bm, full + s);
        tma_load(st + kTile, &maps.b, k0, bn, full + s);
        if (kDual) {
          tma_load(st + 2 * kTile, &maps.a2, k0, bm, full + s);
          tma_load(st + 3 * kTile, &maps.b2, k0, bn, full + s);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int row0 = bm + wg * 64;
  int acc[64];
  int acc2[kDual ? 64 : 1];
  float facc[kGroups ? 64 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
#pragma unroll
  for (int i = 0; i < (kDual ? 64 : 1); ++i) acc2[i] = 0;
#pragma unroll
  for (int i = 0; i < (kGroups ? 64 : 1); ++i) facc[i] = 0.f;

  for (int t = 0; t < nk; ++t) {
    const int s = t % S;
    mbar_wait(full + s, (t / S) & 1);
    const unsigned char* st = ring + s * kBytes;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK8 / 32; ++kk)
      wgmma_s8_m64n128(acc, desc_sw128(st + wg * 8192 + kk * 32, 16),
                       desc_sw128(st + kTile + kk * 32, 16));
    if constexpr (kDual) {
#pragma unroll
      for (int kk = 0; kk < kBK8 / 32; ++kk)
        wgmma_s8_m64n128(acc2, desc_sw128(st + 2 * kTile + wg * 8192 + kk * 32, 16),
                         desc_sw128(st + 3 * kTile + kk * 32, 16));
    }
    wg_commit();
    if (kGroups && (t + 1) % g.group_tiles == 0) {  // the end of group z: fold
      // the group's scales, loaded while its last products run: the fold
      // waits on them, and one K tile's products take about an L2 round trip
      const size_t z = t / g.group_tiles;
      const int r = row0 + k13::acc_row(0);  // this thread's rows r and r + 8
      const float s_lo = r < g.M ? g.sr[z * g.M + r] : 0.f;
      const float s_hi = r + 8 < g.M ? g.sr[z * g.M + r + 8] : 0.f;
      float2 sc[EPI == kEpiS8GroupRC ? 16 : 1];  // columns acc_col(4j), + 1
      if constexpr (EPI == kEpiS8GroupRC) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = bn + k13::acc_col(4 * j);  // even, and N % 8 == 0
          sc[j] = col < g.N ? *reinterpret_cast<const float2*>(g.sc + z * g.N + col)
                            : make_float2(0.f, 0.f);
        }
      }
      wg_wait<0>();
      fence_regs_s32<64>(acc);
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        float v = __fmul_rn(static_cast<float>(acc[i]), (i / 2) % 2 ? s_hi : s_lo);
        if constexpr (EPI == kEpiS8GroupRC)
          v = __fmul_rn(v, i % 2 ? sc[i / 4].y : sc[i / 4].x);
        facc[i] += v;
        acc[i] = 0;
      }
    } else {
      wg_wait<1>();  // tile t − 1's products are done: release its stage
    }
    if (t > 0) mbar_arrive(empty + (t - 1) % S);
  }
  wg_wait<0>();
  fence_regs_s32<64>(acc);
  if constexpr (kDual) fence_regs_s32<64>(acc2);
  // both warpgroups are done with the ring: it stages the epilogue
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");

  const int tid = threadIdx.x % 128;
  const int ra = row0 + k13::acc_row(0), rb = ra + 8;  // a thread's two rows
  auto row_scale = [&](const float* v, int i) {
    const int r = (i / 2) % 2 ? rb : ra;
    return r < g.M ? v[r] : 0.f;
  };
  if constexpr (EPI == kEpiS8F32 || EPI == kEpiS8GeluQF32 || EPI == kEpiS8ResidualF32 ||
                kGroups) {
    constexpr int kLd = kBN + 4;
    float* buf = reinterpret_cast<float*>(ring) + wg * 64 * kLd;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int col = k13::acc_col(i);
      float v0, v1;
      if constexpr (kGroups) {
        v0 = facc[i], v1 = facc[i + 1];
      } else {
        const bool ok = bn + col < g.N;
        const float sr = row_scale(g.sr, i);
        const float c0 = ok ? g.sc[bn + col] : 0.f, c1 = ok ? g.sc[bn + col + 1] : 0.f;
        if (g.bias != nullptr) {
          v0 = dequant(acc[i], sr, c0, ok ? g.bias[bn + col] : 0.f);
          v1 = dequant(acc[i + 1], sr, c1, ok ? g.bias[bn + col + 1] : 0.f);
        } else {
          v0 = dequant(acc[i], sr, c0);
          v1 = dequant(acc[i + 1], sr, c1);
        }
        if constexpr (EPI == kEpiS8GeluQF32) v0 = gelu_q(v0), v1 = gelu_q(v1);
      }
      *reinterpret_cast<float2*>(buf + k13::acc_row(i) * kLd + col) = make_float2(v0, v1);
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
    if constexpr (EPI == kEpiS8ResidualF32) {  // bf16(f32(R) + y), one rounding
      for (int c = tid; c < 64 * (kBN / 8); c += 128) {
        const int r = c / (kBN / 8);
        const int col = (c % (kBN / 8)) * 8;
        if (row0 + r < g.M && bn + col < g.N) {
          const size_t o = static_cast<size_t>(row0 + r) * g.N + bn + col;
          const uint4 rr = *reinterpret_cast<const uint4*>(g.R + o);
          const auto* rv = reinterpret_cast<const __nv_bfloat162*>(&rr);
          const float* y = buf + r * kLd + col;
          uint4 out;
          auto* cv = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 a = __bfloat1622float2(rv[j]);
            cv[j] = __floats2bfloat162_rn(__fadd_rn(a.x, y[2 * j]), __fadd_rn(a.y, y[2 * j + 1]));
          }
          *reinterpret_cast<uint4*>(g.C + o) = out;
        }
      }
    } else {
      for (int c = tid; c < 64 * (kBN / 4); c += 128) {
        const int r = c / (kBN / 4);
        const int col = (c % (kBN / 4)) * 4;
        if (row0 + r < g.M && bn + col < g.N)
          *reinterpret_cast<float4*>(g.F + static_cast<size_t>(row0 + r) * g.N + bn + col) =
              *reinterpret_cast<const float4*>(buf + r * kLd + col);
      }
    }
  } else {
    // bf16 C (and, for the dual product, bf16 C2 and fp32 F) staged per
    // warpgroup: F's tiles first, then C's, then C2's
    constexpr int kLdF = kBN + 4;
    constexpr int kLd = kBN + 8;
    float* fbuf = reinterpret_cast<float*>(ring) + wg * 64 * kLdF;
    bf16* buf = reinterpret_cast<bf16*>(ring + (kDual ? 2 * 64 * kLdF * 4 : 0)) + wg * 64 * kLd;
    bf16* buf2 = buf + 2 * 64 * kLd;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int col = k13::acc_col(i);
      const int off = k13::acc_row(i) * kLd + col;
      const bool ok = bn + col < g.N;
      const float sr = row_scale(g.sr, i);
      const float c0 = ok ? g.sc[bn + col] : 0.f, c1 = ok ? g.sc[bn + col + 1] : 0.f;
      float v0, v1;
      if (g.bias != nullptr) {
        v0 = dequant(acc[i], sr, c0, ok ? g.bias[bn + col] : 0.f);
        v1 = dequant(acc[i + 1], sr, c1, ok ? g.bias[bn + col + 1] : 0.f);
      } else {
        v0 = dequant(acc[i], sr, c0);
        v1 = dequant(acc[i + 1], sr, c1);
      }
      if constexpr (kDual) {  // v = a1
        const float sr2 = row_scale(g.sr2, i);
        const float d0 = __fmul_rn(dequant(acc2[i], sr2, ok ? g.sc2[bn + col] : 0.f),
                                   gelu_grad_q(v0));
        const float d1 = __fmul_rn(dequant(acc2[i + 1], sr2, ok ? g.sc2[bn + col + 1] : 0.f),
                                   gelu_grad_q(v1));
        *reinterpret_cast<float2*>(fbuf + k13::acc_row(i) * kLdF + col) = make_float2(d0, d1);
        *reinterpret_cast<__nv_bfloat162*>(buf2 + off) = __floats2bfloat162_rn(d0, d1);
        v0 = gelu_q(v0), v1 = gelu_q(v1);
      }
      *reinterpret_cast<__nv_bfloat162*>(buf + off) = __floats2bfloat162_rn(v0, v1);
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
    for (int c = tid; c < 64 * (kBN / 8); c += 128) {
      const int r = c / (kBN / 8);
      const int col = (c % (kBN / 8)) * 8;
      if (row0 + r < g.M && bn + col < g.N) {
        const size_t o = static_cast<size_t>(row0 + r) * g.N + bn + col;
        uint4 out = *reinterpret_cast<const uint4*>(buf + r * kLd + col);
        if constexpr (EPI == kEpiS8Residual) {  // bf16(R + bf16(y)), one rounding
          const uint4 rr = *reinterpret_cast<const uint4*>(g.R + o);
          auto* cv = reinterpret_cast<__nv_bfloat162*>(&out);
          const auto* rv = reinterpret_cast<const __nv_bfloat162*>(&rr);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 a = __bfloat1622float2(rv[j]), y = __bfloat1622float2(cv[j]);
            cv[j] = __floats2bfloat162_rn(__fadd_rn(a.x, y.x), __fadd_rn(a.y, y.y));
          }
        }
        *reinterpret_cast<uint4*>(g.C + o) = out;
        if constexpr (kDual) {
          if (g.C2 != nullptr)
            *reinterpret_cast<uint4*>(g.C2 + o) =
                *reinterpret_cast<const uint4*>(buf2 + r * kLd + col);
          const float* f = fbuf + r * kLdF + col;
          *reinterpret_cast<float4*>(g.F + o) = *reinterpret_cast<const float4*>(f);
          *reinterpret_cast<float4*>(g.F + o + 4) = *reinterpret_cast<const float4*>(f + 4);
        }
      }
    }
  }
}

// The operands (A [M, K], B [N, K], and the dual product's A2 [M, K], B2
// [N, K], all int8 with row stride K) of a launch of epilogue EPI
template <int EPI>
cudaError_t launch_s8(const int8_t* A, const int8_t* B, const int8_t* A2, const int8_t* B2,
                      const GemmS8Args& g, cudaStream_t st) {
  constexpr bool kDual = EPI == kEpiS8GeluPair;
  constexpr bool kGroups = EPI == kEpiS8Group || EPI == kEpiS8GroupRC;
  if (g.M == 0 || g.N == 0) return cudaSuccess;
  if (g.K <= 0 || g.K % 16 || g.N % 8 ||
      (kGroups && (g.group_tiles <= 0 || g.K % (g.group_tiles * kBK8))))
    return cudaErrorInvalidValue;
  Maps maps{};
  const bool ok = make_map(&maps.a, A, g.M, g.K, g.K, kBM, true) &&
                  make_map(&maps.b, B, g.N, g.K, g.K, kBN, true) &&
                  (!kDual || (make_map(&maps.a2, A2, g.M, g.K, g.K, kBM, true) &&
                              make_map(&maps.b2, B2, g.N, g.K, g.K, kBN, true)));
  if (!ok) return cudaErrorInvalidValue;
  constexpr size_t smem = kSmemBytes<kDual>;
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_s8_sm90_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((g.N + kBN - 1) / kBN, (g.M + kBM - 1) / kBM);
  gemm_s8_sm90_kernel<EPI><<<grid, kThreads + 32, smem, st>>>(maps, g);
  const cudaError_t launched = cudaGetLastError();
  if (launched == cudaSuccess) ++s8_launches[EPI];
  return launched;
}

// C (kEpiS8Bf16, bf16) or F (kEpiS8F32, fp32) [M, N] = f32(A[M,K]·B[N,K]ᵀ)
// ·sr[M]·sc[N] (+ bias[N]; null: none); kEpiS8GeluQF32: F = gelu_q(that +
// bias); kEpiS8Residual: C = bf16(R + bf16(that + bias)), R [M, N] bf16;
// kEpiS8ResidualF32: C = bf16(f32(R) + (that + bias))
template <int EPI>
cudaError_t gemm_s8(const int8_t* A, const int8_t* B, const float* sr, const float* sc,
                    const float* bias, bf16* C, float* F, int M, int N, int K, cudaStream_t st,
                    const bf16* R = nullptr) {
  static_assert(EPI == kEpiS8Bf16 || EPI == kEpiS8F32 || EPI == kEpiS8GeluQF32 ||
                    EPI == kEpiS8Residual || EPI == kEpiS8ResidualF32,
                "gemm_s8: a single product's epilogue");
  if ((EPI == kEpiS8Residual || EPI == kEpiS8ResidualF32) && R == nullptr)
    return cudaErrorInvalidValue;
  GemmS8Args g{};
  g.sr = sr, g.sc = sc, g.bias = bias, g.R = R, g.C = C, g.F = F;
  g.M = M, g.N = N, g.K = K;
  return launch_s8<EPI>(A, B, nullptr, nullptr, g, st);
}

// K4's dual product over K = d: a1 = f32(xq[n,d]·W1c[m,d]ᵀ)·sx·s1c + b1,
// h1 = bf16(gelu_q(a1)), dh1_32 = f32(doq[n,d]·W2r[m,d]ᵀ)·sdo·s2r·gelu_q'(a1),
// dh1 = bf16(dh1_32) (dh1 null: not written), [n, m] each
inline cudaError_t gemm_s8_gelu_pair(const int8_t* xq, const int8_t* w1c, const float* sx,
                                     const float* s1c, const float* b1, const int8_t* doq,
                                     const int8_t* w2r, const float* sdo, const float* s2r,
                                     bf16* h1, bf16* dh1, float* dh1_32, int n, int m, int d,
                                     cudaStream_t st) {
  GemmS8Args g{};
  g.sr = sx, g.sc = s1c, g.bias = b1, g.sr2 = sdo, g.sc2 = s2r;
  g.C = h1, g.C2 = dh1, g.F = dh1_32;
  g.M = n, g.N = m, g.K = d;
  return launch_s8<kEpiS8GeluPair>(xq, w1c, doq, w2r, g, st);
}

// The int8_dw weight grad: F[M,N] = Σ over groups z of f32(A_z·B_zᵀ)·s[z·M + m],
// A [M, K] and B [N, K] int8 with K = groups·gp, group z the K columns
// [z·gp, (z + 1)·gp) (zero past its rows); gp % kBK8 == 0.
inline cudaError_t gemm_s8_groups(const int8_t* A, const int8_t* B, const float* s, float* F,
                                  int M, int N, int K, int gp, cudaStream_t st) {
  if (gp <= 0 || gp % kBK8) return cudaErrorInvalidValue;
  GemmS8Args g{};
  g.sr = s, g.F = F;
  g.M = M, g.N = N, g.K = K, g.group_tiles = gp / kBK8;
  return launch_s8<kEpiS8Group>(A, B, nullptr, nullptr, g, st);
}

// The int4_grad backwards' int8_dw weight grad: F[M,N] = Σ over groups z of
// (f32(A_z·B_zᵀ)·sa[z·M + m])·sb[z·N + n], both operands' column codes
// packed fresh over each group (dw_int8.cuh); the layout of gemm_s8_groups
inline cudaError_t gemm_s8_groups_rc(const int8_t* A, const int8_t* B, const float* sa,
                                     const float* sb, float* F, int M, int N, int K, int gp,
                                     cudaStream_t st) {
  if (gp <= 0 || gp % kBK8) return cudaErrorInvalidValue;
  GemmS8Args g{};
  g.sr = sa, g.sc = sb, g.F = F;
  g.M = M, g.N = N, g.K = K, g.group_tiles = gp / kBK8;
  return launch_s8<kEpiS8GroupRC>(A, B, nullptr, nullptr, g, st);
}

}  // namespace sm90
}  // namespace vitax
