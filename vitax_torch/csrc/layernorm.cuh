// Row LayerNorm with fp32 statistics: the device half of the LN kernel, and
// the LN1/LN2 prologue of the fused attention and MLP halves.
#pragma once

#include "common.cuh"

namespace vitax {

// One warp per row. Each lane reads 16-byte vectors, so d must be a multiple
// of 8 (bf16) or 4 (fp32). Two passes over the row for the mean and the
// centred variance, as the TPU kernel computes them; the re-reads hit L1.
template <typename T>
__global__ void __launch_bounds__(256)
    layer_norm_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                           const float* __restrict__ beta, T* __restrict__ y, int n, int d,
                           float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const T* xr = x + static_cast<size_t>(row) * d;
  T* yr = y + static_cast<size_t>(row) * d;

  float s = 0.f;
  for (int i = lane * VEC; i < d; i += 32 * VEC) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) s += to_float(v[j]);
  }
  const float mean = warp_sum(s) / static_cast<float>(d);

  float q = 0.f;
  for (int i = lane * VEC; i < d; i += 32 * VEC) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float c = to_float(v[j]) - mean;
      q += c * c;
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / static_cast<float>(d) + eps);

  for (int i = lane * VEC; i < d; i += 32 * VEC) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
    const T* v = reinterpret_cast<const T*>(&raw);
    uint4 out;
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float xhat = (to_float(v[j]) - mean) * rstd;
      o[j] = from_float<T>(xhat * gamma[i + j] + beta[i + j]);
    }
    *reinterpret_cast<uint4*>(yr + i) = out;
  }
}

template <typename T>
cudaError_t launch_layer_norm(const T* x, const float* gamma, const float* beta, T* y, int n,
                              int d, float eps, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  constexpr int kRowsPerBlock = 8;
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  layer_norm_rows_kernel<T><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(x, gamma, beta, y, n, d,
                                                                       eps);
  return cudaGetLastError();
}

}  // namespace vitax
