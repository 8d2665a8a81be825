// Row LayerNorm with fp32 statistics: the device half of the LN kernel, and
// the LN1/LN2 prologue of the fused attention and MLP halves; and its
// backward, which also serves the LN tails of the fused halves' backwards.
#pragma once

#include "colsum.cuh"
#include "common.cuh"
#include "quant.cuh"

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

// The LN1/LN2 prologue of the W8A8 and A4W4 halves: the row LN of
// layer_norm_rows_kernel (same statistics, same expression for xn), then the
// row's codes q and scale s on the grid of limit L (quant.cuh: 127 int8, 7
// int4), quantized from the fp32 xn
// (K3 forward and backward, K4 forward: _quant_rows(xn32),
// pallas_kernels.py:2706, :3015, :708) or, with FROM_BF16, from the
// bf16-rounded xn (K4 backward, :1155). xn_out, if not null, receives xn for
// the weight-grad products: bf16(xn), or with XN_F32 the fp32 xn (K3's
// backward under int8_dw quantizes it per column, :3081). One warp a row; the
// row is read four times (statistics twice, amax, codes), all but the first
// from L1. Also the handoff's row pack (K5, _ln_quant_rows :3660).
template <bool FROM_BF16, bool XN_F32, int L>
__global__ void __launch_bounds__(256)
    layer_norm_quant_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                            const float* __restrict__ beta, int8_t* __restrict__ q,
                            float* __restrict__ s, void* __restrict__ xn_out, int n, int d,
                            float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const bf16* xr = x + static_cast<size_t>(row) * d;

  float sum = 0.f;
  for (int i = lane * 8; i < d; i += 256) {
    float v[8];
    load8(xr + i, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += v[e];
  }
  const float mean = warp_sum(sum) / static_cast<float>(d);
  float sq = 0.f;
  for (int i = lane * 8; i < d; i += 256) {
    float v[8];
    load8(xr + i, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float c = v[e] - mean;
      sq += c * c;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(d) + eps);

  // xn of 8 neighbouring columns, as the quantizer sees them
  auto xn8 = [&](int i, float y[8]) {
    float v[8];
    load8(xr + i, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float xhat = (v[e] - mean) * rstd;
      y[e] = xhat * gamma[i + e] + beta[i + e];
      if (FROM_BF16) y[e] = __bfloat162float(__float2bfloat16(y[e]));
    }
  };
  float amax = 0.f;
  for (int i = lane * 8; i < d; i += 256) {
    float y[8];
    xn8(i, y);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(y[e]));
  }
  const float2 sr = quant_scale<L>(warp_max(amax));
  const size_t base = static_cast<size_t>(row) * d;
  for (int i = lane * 8; i < d; i += 256) {
    float y[8];
    xn8(i, y);
    __align__(8) int8_t o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = quant_i8<L>(y[e], sr.y);
    *reinterpret_cast<uint2*>(q + base + i) = *reinterpret_cast<const uint2*>(o);
    if (xn_out != nullptr) {
      if (XN_F32) {
        float* xo = static_cast<float*>(xn_out) + base + i;
        store4(xo, y);
        store4(xo + 4, y + 4);
      } else {
        bf16* xo = static_cast<bf16*>(xn_out) + base + i;
        store4(xo, y);
        store4(xo + 4, y + 4);
      }
    }
  }
  if (lane == 0) s[row] = sr.x;
}

// d % 8 == 0. xn_out: null, bf16 [n, d], or with XN_F32 fp32 [n, d].
template <bool FROM_BF16, bool XN_F32 = false, int L = kQ8>
cudaError_t launch_layer_norm_quant(const bf16* x, const float* gamma, const float* beta,
                                    int8_t* q, float* s, void* xn_out, int n, int d, float eps,
                                    cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  if (d % 8) return cudaErrorInvalidValue;
  constexpr int kRowsPerBlock = 8;
  layer_norm_quant_kernel<FROM_BF16, XN_F32, L>
      <<<(n + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0, stream>>>(
          x, gamma, beta, q, s, xn_out, n, d, eps);
  return cudaGetLastError();
}

// LN backward, the row half: statistics recomputed in fp32, then
//   dx = rstd * (dyg - mean(dyg) - xhat * mean(dyg * xhat)),  dyg = dy * gamma
// (the TPU's _ln_bwd_kernel, and the LN tails of the fused halves'
// backwards). With R (K2's residual), dx = R + TX(dx_ln), the add in TX.
// Writes each row's mean and rstd for the dγ/dβ pass. One warp per row, four
// values a lane (d % 4 == 0); the re-reads of the row hit L1.
template <typename TX, typename TD>
__global__ void __launch_bounds__(256)
    layer_norm_bwd_rows_kernel(const TX* __restrict__ x, const float* __restrict__ gamma,
                               const TD* __restrict__ dy, const TX* __restrict__ R,
                               TX* __restrict__ dx, float* __restrict__ mean_out,
                               float* __restrict__ rstd_out, int n, int d, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const size_t base = static_cast<size_t>(row) * d;
  const float inv_d = 1.0f / static_cast<float>(d);

  float s = 0.f;
  for (int i = lane * 4; i < d; i += 128) {
    float v[4];
    load4(x + base + i, v);
    s += (v[0] + v[1]) + (v[2] + v[3]);
  }
  const float mean = warp_sum(s) * inv_d;
  float q = 0.f;
  for (int i = lane * 4; i < d; i += 128) {
    float v[4];
    load4(x + base + i, v);
#pragma unroll
    for (int t = 0; t < 4; ++t) q += (v[t] - mean) * (v[t] - mean);
  }
  const float rstd = rsqrtf(warp_sum(q) * inv_d + eps);

  float s1 = 0.f, s2 = 0.f;
  for (int i = lane * 4; i < d; i += 128) {
    float v[4], g[4], dv[4];
    load4(x + base + i, v);
    load4(gamma + i, g);
    load4(dy + base + i, dv);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float dyg = dv[t] * g[t];
      s1 += dyg;
      s2 += dyg * ((v[t] - mean) * rstd);
    }
  }
  const float m1 = warp_sum(s1) * inv_d;
  const float m2 = warp_sum(s2) * inv_d;

  for (int i = lane * 4; i < d; i += 128) {
    float v[4], g[4], dv[4], r[4], out[4];
    load4(x + base + i, v);
    load4(gamma + i, g);
    load4(dy + base + i, dv);
    if (R != nullptr) load4(R + base + i, r);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float xhat = (v[t] - mean) * rstd;
      const float dxl = rstd * (dv[t] * g[t] - m1 - xhat * m2);
      out[t] = R != nullptr ? r[t] + to_float(from_float<TX>(dxl)) : dxl;
    }
    store4(dx + base + i, out);
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// fp32 workspace of one LN backward: per-row mean and rstd, then the dβ and
// dγ partials.
inline size_t layer_norm_bwd_workspace(int n, int d) {
  return 2 * static_cast<size_t>(n) + 2 * colsum_workspace(n, d);
}

// dx (TX), dγ = Σ dy·x̂ and dβ = Σ dy (fp32 [d]) of a row LN over x [n, d];
// R (optional) is added to dx in TX. d % 4 == 0.
template <typename TX, typename TD>
cudaError_t launch_layer_norm_bwd(const TX* x, const float* gamma, const TD* dy, const TX* R,
                                  TX* dx, float* dgamma, float* dbeta, float* ws, int n, int d,
                                  float eps, cudaStream_t stream) {
  float* mean = ws;
  float* rstd = ws + n;
  if (n > 0) {
    constexpr int kRowsPerBlock = 8;
    const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
    layer_norm_bwd_rows_kernel<TX, TD><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
        x, gamma, dy, R, dx, mean, rstd, n, d, eps);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return launch_colsum_pair<TD, TX, true>(dy, x, mean, rstd, dbeta, dgamma, ws + 2 * n, n, d,
                                          stream);
}

// a[i] += b[i] over n floats.
template <int kDummy = 0>
__global__ void add_into_kernel(float* __restrict__ a, const float* __restrict__ b, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) a[i] += b[i];
}

// The LN backward of one LN applied to two row sets (K8's gathered rows xc
// [nc, d] and all rows x [n, d]): dxc and dx in TX; dγ and dβ the sum of
// the two sets' sums, the second set's first into g2, b2 (fp32 [d]
// scratch), then added. ws: the larger layer_norm_bwd_workspace of the two.
template <typename TX, typename TD>
cudaError_t launch_layer_norm_bwd_two(const TX* xc, const TD* dyc, TX* dxc, int nc, const TX* x,
                                      const TD* dy, TX* dx, int n, const float* gamma,
                                      float* dgamma, float* dbeta, float* g2, float* b2,
                                      float* ws, int d, float eps, cudaStream_t stream) {
  cudaError_t e = launch_layer_norm_bwd<TX, TD>(xc, gamma, dyc, nullptr, dxc, dgamma, dbeta, ws,
                                                nc, d, eps, stream);
  if (e != cudaSuccess) return e;
  e = launch_layer_norm_bwd<TX, TD>(x, gamma, dy, nullptr, dx, g2, b2, ws, n, d, eps, stream);
  if (e != cudaSuccess) return e;
  add_into_kernel<0><<<(d + 255) / 256, 256, 0, stream>>>(dgamma, g2, d);
  add_into_kernel<0><<<(d + 255) / 256, 256, 0, stream>>>(dbeta, b2, d);
  return cudaGetLastError();
}

}  // namespace vitax
