// Deterministic column sums over all rows of a [n, c] matrix: the vector
// grads of the backward kernels (db, dbo, db1, db2 over the cotangents, and
// dγ = Σ dy·x̂, dβ = Σ dy of the LN tails).
//
// The TPU kernels carry these sums across a sequential grid in VMEM. On
// Hopper blocks run in parallel and in no order, so the sum is two passes: a
// block per (128-column strip, chunk of rows) writes its fp32 partial to a
// workspace, then one thread per column adds the partials in chunk order. No
// float atomics: two runs give the same bits. (The LN backward up to 1280
// columns sums its dγ/dβ inside its own row pass: layernorm.cuh.)
//
// Bound on the H100: device memory (one read of the matrix; the partials are
// ≤ 256 rows of c floats). Each warp reads 128 neighbouring columns of a row,
// 8 rows in flight per block.
#pragma once

#include "common.cuh"

namespace vitax {

constexpr int kColsumCols = 128;  // columns a block covers: 32 threads x 4
constexpr int kColsumLanes = 8;   // rows a block reads at once

inline int colsum_rows_per_chunk(int n) {
  const int r = (n + 255) / 256;  // at most 256 chunks
  return r < 64 ? 64 : r;
}

inline int colsum_chunks(int n) {
  const int r = colsum_rows_per_chunk(n);
  return (n + r - 1) / r;
}

// fp32 workspace of one column sum (two with XHAT).
inline size_t colsum_workspace(int n, int c) {
  return static_cast<size_t>(colsum_chunks(n)) * c;
}

// part_b[chunk][j] = Σ_{r in chunk} dy[r][j]; with XHAT also
// part_g[chunk][j] = Σ_{r in chunk} dy[r][j] * (x[r][j] - mean[r]) * rstd[r].
// Needs c % 4 == 0.
template <typename TD, typename TX, bool XHAT>
__global__ void __launch_bounds__(256)
    colsum_partial_kernel(const TD* __restrict__ dy, const TX* __restrict__ x,
                          const float* __restrict__ mean, const float* __restrict__ rstd,
                          float* __restrict__ part_b, float* __restrict__ part_g, int n, int c,
                          int rows_per_chunk) {
  __shared__ float sb[kColsumLanes][kColsumCols];
  __shared__ float sg[XHAT ? kColsumLanes : 1][kColsumCols];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int col = blockIdx.x * kColsumCols + tx * 4;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(n, r0 + rows_per_chunk);
  float ab[4] = {0.f, 0.f, 0.f, 0.f};
  float ag[4] = {0.f, 0.f, 0.f, 0.f};
  if (col < c) {
    for (int r = r0 + ty; r < r1; r += kColsumLanes) {
      float d[4];
      load4(dy + static_cast<size_t>(r) * c + col, d);
      if (XHAT) {
        float xv[4];
        load4(x + static_cast<size_t>(r) * c + col, xv);
        const float mu = mean[r];
        const float rs = rstd[r];
#pragma unroll
        for (int t = 0; t < 4; ++t) ag[t] += d[t] * ((xv[t] - mu) * rs);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) ab[t] += d[t];
    }
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    sb[ty][tx * 4 + t] = ab[t];
    if (XHAT) sg[ty][tx * 4 + t] = ag[t];
  }
  __syncthreads();
  if (ty == 0 && col < c) {
    const size_t out = static_cast<size_t>(blockIdx.y) * c + col;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float s = 0.f;
      float g = 0.f;
#pragma unroll
      for (int l = 0; l < kColsumLanes; ++l) {
        s += sb[l][tx * 4 + t];
        if (XHAT) g += sg[l][tx * 4 + t];
      }
      part_b[out + t] = s;
      if (XHAT) part_g[out + t] = g;
    }
  }
}

// out[j] = Σ_k part[k][j], k in chunk order. A column's chunk loads are
// issued kColsumFinalUnroll at a time ahead of their adds (the order of the
// adds, and so the bits, stay), and the columns spread over c / 32 blocks.
constexpr int kColsumFinalThreads = 32;
constexpr int kColsumFinalUnroll = 16;

template <int kDummy = 0>
__global__ void __launch_bounds__(kColsumFinalThreads)
    colsum_final_kernel(const float* __restrict__ part, float* __restrict__ out, int chunks,
                        int c) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= c) return;
  float s = 0.f;
  int k = 0;
  for (; k + kColsumFinalUnroll <= chunks; k += kColsumFinalUnroll) {
    float v[kColsumFinalUnroll];
#pragma unroll
    for (int u = 0; u < kColsumFinalUnroll; ++u) v[u] = part[static_cast<size_t>(k + u) * c + j];
#pragma unroll
    for (int u = 0; u < kColsumFinalUnroll; ++u) s = __fadd_rn(s, v[u]);
  }
  for (; k < chunks; ++k) s = __fadd_rn(s, part[static_cast<size_t>(k) * c + j]);
  out[j] = s;
}

// Both passes; part_g/x/mean/rstd are read only with XHAT. ws holds
// colsum_workspace(n, c) floats (twice that with XHAT).
template <typename TD, typename TX, bool XHAT>
cudaError_t launch_colsum_pair(const TD* dy, const TX* x, const float* mean, const float* rstd,
                               float* out_b, float* out_g, float* ws, int n, int c,
                               cudaStream_t stream) {
  if (c == 0) return cudaSuccess;
  if (n == 0) {
    cudaError_t e = cudaMemsetAsync(out_b, 0, sizeof(float) * c, stream);
    if (e == cudaSuccess && XHAT) e = cudaMemsetAsync(out_g, 0, sizeof(float) * c, stream);
    return e;
  }
  const int rpc = colsum_rows_per_chunk(n);
  const int chunks = colsum_chunks(n);
  float* part_b = ws;
  float* part_g = ws + colsum_workspace(n, c);
  const dim3 grid((c + kColsumCols - 1) / kColsumCols, chunks);
  colsum_partial_kernel<TD, TX, XHAT><<<grid, dim3(32, kColsumLanes), 0, stream>>>(
      dy, x, mean, rstd, part_b, part_g, n, c, rpc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int fblocks = (c + kColsumFinalThreads - 1) / kColsumFinalThreads;
  colsum_final_kernel<0><<<fblocks, kColsumFinalThreads, 0, stream>>>(part_b, out_b, chunks, c);
  if (XHAT) {
    colsum_final_kernel<0><<<fblocks, kColsumFinalThreads, 0, stream>>>(part_g, out_g, chunks,
                                                                        c);
  }
  return cudaGetLastError();
}

// out[j] = Σ_r X[r][j] in fp32 (db over a bf16 cotangent).
template <typename T>
cudaError_t launch_colsum(const T* X, float* out, float* ws, int n, int c, cudaStream_t stream) {
  return launch_colsum_pair<T, T, false>(X, nullptr, nullptr, nullptr, out, nullptr, ws, n, c,
                                         stream);
}

}  // namespace vitax
