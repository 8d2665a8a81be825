// Tiled bf16 GEMM with fp32 accumulation and a fused epilogue: the projection
// products inside the fused attention and MLP halves (the TPU kernels compute
// them in their own bodies with jnp.dot(..., preferred_element_type=f32)).
//
// C[M,N] = epilogue(A[M,K] @ B[K,N]), A and B row-major bf16 (B is the weight
// in the JAX [in, out] layout, so no transpose is ever made).
//
// Bound on the H100: the tensor cores at the ViT-B/16 shapes (M = B*spq rows,
// K and N 768..3072: ~380 flops a byte). Design of this first version: WMMA
// 16x16x16 bf16 tiles (mma.sync on Hopper), a 128x128x32 block tile in 8
// warps of 64x32, and a two-stage cp.async ring so the next K tile loads while
// the current one multiplies. It does not reach wgmma/TMA rates; that is work
// for a later PR. The epilogue stages each 16x16 accumulator through a
// per-warp shared buffer, adds the fp32 bias, applies GELU or the residual,
// and writes 16-byte bf16 vectors with the ragged row edge masked.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace vitax {

enum Epilogue : int {
  kBias = 0,          // C = bf16(acc + bias)
  kBiasGelu = 1,      // C = bf16(gelu_erf(acc + bias)), GELU in fp32
  kBiasResidual = 2,  // C = R + bf16(acc + bias), the add in bf16
};

constexpr int kGemmBM = 128;
constexpr int kGemmBN = 128;
constexpr int kGemmBK = 32;
constexpr int kGemmThreads = 256;
constexpr int kGemmALd = kGemmBK + 8;  // padded rows: fewer bank conflicts
constexpr int kGemmBLd = kGemmBN + 8;

__device__ __forceinline__ float gelu_erf(float a) {
  return 0.5f * a * (1.0f + erff(a * 0.70710678118654752f));
}

// Requires K % 32 == 0 and N % 8 == 0 (checked by the Python wrapper).
template <int EPI>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                     const float* __restrict__ bias, const bf16* __restrict__ R,
                     bf16* __restrict__ C, int M, int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[2][kGemmBM * kGemmALd];
  __shared__ __align__(128) bf16 Bs[2][kGemmBK * kGemmBLd];
  __shared__ __align__(128) float Cs[kGemmThreads / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bm = blockIdx.y * kGemmBM;
  const int bn = blockIdx.x * kGemmBN;
  const int wm = (warp / 4) * 64;
  const int wn = (warp % 4) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  auto load_tile = [&](int stage, int k0) {
#pragma unroll
    for (int i = tid; i < kGemmBM * kGemmBK / 8; i += kGemmThreads) {
      const int r = i / (kGemmBK / 8);
      const int c = (i % (kGemmBK / 8)) * 8;
      const int gr = bm + r;
      const bf16* src = A + static_cast<size_t>(gr < M ? gr : 0) * K + k0 + c;
      cp_async16(&As[stage][r * kGemmALd + c], src, gr < M ? 16 : 0);
    }
#pragma unroll
    for (int i = tid; i < kGemmBK * kGemmBN / 8; i += kGemmThreads) {
      const int r = i / (kGemmBN / 8);
      const int c = (i % (kGemmBN / 8)) * 8;
      const int gc = bn + c;
      const bf16* src = B + static_cast<size_t>(k0 + r) * N + (gc < N ? gc : 0);
      cp_async16(&Bs[stage][r * kGemmBLd + c], src, gc < N ? 16 : 0);
    }
    cp_async_commit();
  };

  const int nk = K / kGemmBK;
  load_tile(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_tile((kt + 1) & 1, (kt + 1) * kGemmBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s = kt & 1;
#pragma unroll
    for (int kk = 0; kk < kGemmBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], &As[s][(wm + i * 16) * kGemmALd + kk], kGemmALd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[s][kk * kGemmBLd + wn + j * 16], kGemmBLd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration's load overwrites this stage
  }

  float* cs = Cs[warp];
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
        uint4 out_u;
        uint4 res_u = make_uint4(0, 0, 0, 0);
        if (EPI == kBiasResidual) res_u = *reinterpret_cast<const uint4*>(R + off);
        bf16* out = reinterpret_cast<bf16*>(&out_u);
        const bf16* res = reinterpret_cast<const bf16*>(&res_u);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float v = cs[r * 16 + c0 + t] + bias[gc + t];
          if (EPI == kBias) {
            out[t] = __float2bfloat16(v);
          } else if (EPI == kBiasGelu) {
            out[t] = __float2bfloat16(gelu_erf(v));
          } else {
            const float yb = __bfloat162float(__float2bfloat16(v));
            out[t] = __float2bfloat16(__bfloat162float(res[t]) + yb);
          }
        }
        *reinterpret_cast<uint4*>(C + off) = out_u;
      }
      __syncwarp();
    }
  }
}

template <int EPI>
cudaError_t launch_gemm(const bf16* A, const bf16* B, const float* bias, const bf16* R, bf16* C,
                        int M, int N, int K, cudaStream_t stream) {
  if (M == 0) return cudaSuccess;
  const dim3 grid((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM);
  gemm_bf16_kernel<EPI><<<grid, kGemmThreads, 0, stream>>>(A, B, bias, R, C, M, N, K);
  return cudaGetLastError();
}

}  // namespace vitax
