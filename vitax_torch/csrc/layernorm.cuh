// Row LayerNorm with fp32 statistics: the device half of the LN kernel, and
// the LN1/LN2 prologue of the fused attention and MLP halves; and its
// backward, which also serves the LN tails of the fused halves' backwards.
//
// Both are bound by device memory (a few flops a byte). Up to kLnRegMaxD
// (ViT-B's 768, L's 1024, H's 1280) a warp holds its lane's share of a row in
// registers, so each row is read once with all of its loads in flight:
// - forward: each warp walks rows over a grid of the card's resident blocks
//   and issues the next row's loads before the current row's reductions; γ
//   and β sit in shared memory, read once a block;
// - backward: one pass over x, dy (and R) a row; each lane adds dy·x̂ and dy
//   for its own columns over the rows its warp walks, a block combines its
//   warps' sums in shared memory and writes one partial row, and a second
//   launch adds the partial rows of each column. No float atomics: two runs
//   give the same bits.
// Both keep the first design's lane mapping, order of each lane's fp32 ops
// and warp_sum tree, written as explicit _rn intrinsics (the contractions the
// first design compiled to), so y and dx keep its bits; dγ and dβ are summed
// in another order. Wider rows, up to the gate's 8192, loop over the row
// (the first design: three passes forward; backward a row pass writing
// mean/rstd and colsum.cuh's two-pass column sums).
#pragma once

#include <algorithm>

#include "colsum.cuh"
#include "common.cuh"
#include "quant.cuh"

namespace vitax {

constexpr int kLnThreads = 256;   // 8 warps a block, one row a warp at a time
constexpr int kLnRegMaxD = 1280;  // widest row held in registers
constexpr int kLnBwdBlocksPerSm = 2;

inline cudaError_t ln_sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

// Blocks of kLnThreads threads of `kernel` resident on one SM (0 if it cannot
// launch, or the query failed).
template <typename K>
inline int ln_blocks_per_sm(K kernel) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kLnThreads, 0) !=
      cudaSuccess)
    return 0;
  return blocks;
}

// A lane's 16-byte vector k of a row covers elements (lane + 32 k) VEC ...
// + VEC - 1, VEC = 16 / sizeof(T): the first design's mapping.
template <typename T, int NV>
__device__ __forceinline__ void ln_load_row(uint4 (&v)[NV], const T* __restrict__ xr, int lane,
                                            int d) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = (lane + 32 * k) * VEC;
    if (i < d) v[k] = *reinterpret_cast<const uint4*>(xr + i);
  }
}

// The row LN with a lane's share of the row in NV vectors of registers
// (d <= 32 VEC NV). mean, then the centred variance, then (x − μ)·rstd·γ + β,
// each lane's values in the first design's order and rounding.
template <typename T, int NV>
__global__ void __launch_bounds__(kLnThreads)
    layer_norm_rows_reg_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                               const float* __restrict__ beta, T* __restrict__ y, int n, int d,
                               float eps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int kMaxD = 32 * VEC * NV;
  __shared__ __align__(16) float sg[kMaxD];
  __shared__ __align__(16) float sb[kMaxD];
  for (int i = threadIdx.x * 4; i < d; i += kLnThreads * 4) {
    *reinterpret_cast<float4*>(sg + i) = *reinterpret_cast<const float4*>(gamma + i);
    *reinterpret_cast<float4*>(sb + i) = *reinterpret_cast<const float4*>(beta + i);
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int stride = gridDim.x * (kLnThreads / 32);
  const float fd = static_cast<float>(d);
  int row = blockIdx.x * (kLnThreads / 32) + threadIdx.x / 32;
  uint4 cur[NV], nxt[NV];
  if (row < n) ln_load_row<T, NV>(cur, x + static_cast<size_t>(row) * d, lane, d);
  for (; row < n; row += stride) {
    if (row + stride < n)
      ln_load_row<T, NV>(nxt, x + static_cast<size_t>(row + stride) * d, lane, d);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if ((lane + 32 * k) * VEC >= d) continue;
      const T* v = reinterpret_cast<const T*>(&cur[k]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s = __fadd_rn(s, to_float(v[j]));
    }
    const float mean = __fdiv_rn(warp_sum(s), fd);
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if ((lane + 32 * k) * VEC >= d) continue;
      const T* v = reinterpret_cast<const T*>(&cur[k]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float c = __fsub_rn(to_float(v[j]), mean);
        q = __fmaf_rn(c, c, q);
      }
    }
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(q), fd), eps));
    T* yr = y + static_cast<size_t>(row) * d;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = (lane + 32 * k) * VEC;
      if (i >= d) continue;
      const T* v = reinterpret_cast<const T*>(&cur[k]);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xhat = __fmul_rn(__fsub_rn(to_float(v[j]), mean), rstd);
        o[j] = from_float<T>(__fmaf_rn(xhat, sg[i + j], sb[i + j]));
      }
      *reinterpret_cast<uint4*>(yr + i) = out;
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) cur[k] = nxt[k];
  }
}

// The loop form for d > kLnRegMaxD (the first design): one warp a row, three
// passes over the row (sum, centred squares, normalise), the re-reads from L1.
template <typename T>
__global__ void __launch_bounds__(kLnThreads)
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

template <typename T, int NV>
cudaError_t launch_layer_norm_reg(const T* x, const float* gamma, const float* beta, T* y, int n,
                                  int d, float eps, cudaStream_t stream) {
  static const int per_sm = ln_blocks_per_sm(layer_norm_rows_reg_kernel<T, NV>);
  if (per_sm == 0) return cudaErrorLaunchOutOfResources;
  int sms = 0;
  const cudaError_t e = ln_sm_count(&sms);
  if (e != cudaSuccess) return e;
  constexpr int kWarps = kLnThreads / 32;
  const int blocks = std::min((n + kWarps - 1) / kWarps, per_sm * sms);
  layer_norm_rows_reg_kernel<T, NV><<<blocks, kLnThreads, 0, stream>>>(x, gamma, beta, y, n, d,
                                                                       eps);
  return cudaGetLastError();
}

// d % 8 == 0 (16-byte vectors), d <= 8192.
template <typename T>
cudaError_t launch_layer_norm(const T* x, const float* gamma, const float* beta, T* y, int n,
                              int d, float eps, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  if (d <= kLnRegMaxD) {
    constexpr int kLaneD = 32 * 16 / static_cast<int>(sizeof(T));  // a vector a lane
    const int nv = (d + kLaneD - 1) / kLaneD;
    if constexpr (sizeof(T) == 2) {  // bf16: 1..5 vectors a lane
      switch (nv) {
        case 1: return launch_layer_norm_reg<T, 1>(x, gamma, beta, y, n, d, eps, stream);
        case 2: return launch_layer_norm_reg<T, 2>(x, gamma, beta, y, n, d, eps, stream);
        case 3: return launch_layer_norm_reg<T, 3>(x, gamma, beta, y, n, d, eps, stream);
        case 4: return launch_layer_norm_reg<T, 4>(x, gamma, beta, y, n, d, eps, stream);
        default: return launch_layer_norm_reg<T, 5>(x, gamma, beta, y, n, d, eps, stream);
      }
    } else {  // fp32: 2, 4, ..., 10 vectors a lane
      switch ((nv + 1) / 2) {
        case 1: return launch_layer_norm_reg<T, 2>(x, gamma, beta, y, n, d, eps, stream);
        case 2: return launch_layer_norm_reg<T, 4>(x, gamma, beta, y, n, d, eps, stream);
        case 3: return launch_layer_norm_reg<T, 6>(x, gamma, beta, y, n, d, eps, stream);
        case 4: return launch_layer_norm_reg<T, 8>(x, gamma, beta, y, n, d, eps, stream);
        default: return launch_layer_norm_reg<T, 10>(x, gamma, beta, y, n, d, eps, stream);
      }
    }
  }
  constexpr int kRowsPerBlock = kLnThreads / 32;
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  layer_norm_rows_kernel<T><<<blocks, kLnThreads, 0, stream>>>(x, gamma, beta, y, n, d, eps);
  return cudaGetLastError();
}

// The LN1/LN2 prologue of the W8A8 and A4W4 halves: the row LN (the same
// statistics and xn as the first design's layer_norm_rows_kernel), then the
// row's codes q and scale s on the grid of limit L (quant.cuh: 127 int8, 7
// int4), quantized from the fp32 xn (K3 forward and backward, K4 forward:
// _quant_rows(xn32), pallas_kernels.py:2706, :3015, :708) or, with
// FROM_BF16, from the bf16-rounded xn (K4 backward, :1155). xn_out, if not
// null, receives xn for the weight-grad products: bf16(xn), or with XN_F32
// the fp32 xn (K3's backward under int8_dw quantizes it per column, :3081).
// Also the handoff's row pack (K5, _ln_quant_rows :3660). Bound by device
// memory: it reads 2 bytes and writes 1 (plus xn) an element.
//
// Up to kLnRegMaxD columns, layer_norm_rows_reg_kernel's pattern: a lane
// holds its share of the row in registers (NV 16-byte vectors, columns
// (lane + 32 k)·8 .. + 7), so x is read once; each warp walks rows over the
// card's resident blocks with the next row's loads in flight; γ and β sit in
// shared memory. Each lane's fp32 ops keep the first design's order and
// rounding as explicit _rn intrinsics (the contractions it compiled to), so
// the codes, scales and xn keep its bits. Wider rows take the first design:
// one warp a row, the row read four times (statistics twice, amax, codes).
template <bool FROM_BF16, bool XN_F32, int L, int NV>
__global__ void __launch_bounds__(kLnThreads)
    layer_norm_quant_reg_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                                const float* __restrict__ beta, int8_t* __restrict__ q,
                                float* __restrict__ s, void* __restrict__ xn_out, int n, int d,
                                float eps) {
  constexpr int kMaxD = 32 * 8 * NV;
  __shared__ __align__(16) float sg[kMaxD];
  __shared__ __align__(16) float sb[kMaxD];
  for (int i = threadIdx.x * 4; i < d; i += kLnThreads * 4) {
    *reinterpret_cast<float4*>(sg + i) = *reinterpret_cast<const float4*>(gamma + i);
    *reinterpret_cast<float4*>(sb + i) = *reinterpret_cast<const float4*>(beta + i);
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int stride = gridDim.x * (kLnThreads / 32);
  const float fd = static_cast<float>(d);
  int row = blockIdx.x * (kLnThreads / 32) + threadIdx.x / 32;
  uint4 cur[NV], nxt[NV];
  if (row < n) ln_load_row<bf16, NV>(cur, x + static_cast<size_t>(row) * d, lane, d);
  for (; row < n; row += stride) {
    if (row + stride < n)
      ln_load_row<bf16, NV>(nxt, x + static_cast<size_t>(row + stride) * d, lane, d);
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if ((lane + 32 * k) * 8 >= d) continue;
      const bf16* v = reinterpret_cast<const bf16*>(&cur[k]);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum = __fadd_rn(sum, to_float(v[e]));
    }
    const float mean = __fdiv_rn(warp_sum(sum), fd);
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if ((lane + 32 * k) * 8 >= d) continue;
      const bf16* v = reinterpret_cast<const bf16*>(&cur[k]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float c = __fsub_rn(to_float(v[e]), mean);
        sq = __fmaf_rn(c, c, sq);
      }
    }
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), fd), eps));
    float y[NV][8];
    float amax = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = (lane + 32 * k) * 8;
      if (i >= d) continue;
      const bf16* v = reinterpret_cast<const bf16*>(&cur[k]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xhat = __fmul_rn(__fsub_rn(to_float(v[e]), mean), rstd);
        y[k][e] = __fmaf_rn(xhat, sg[i + e], sb[i + e]);
        if (FROM_BF16) y[k][e] = __bfloat162float(__float2bfloat16(y[k][e]));
        amax = fmaxf(amax, fabsf(y[k][e]));
      }
    }
    const float2 sr = quant_scale<L>(warp_max(amax));
    const size_t base = static_cast<size_t>(row) * d;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = (lane + 32 * k) * 8;
      if (i >= d) continue;
      __align__(8) int8_t o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = quant_i8<L>(y[k][e], sr.y);
      *reinterpret_cast<uint2*>(q + base + i) = *reinterpret_cast<const uint2*>(o);
      if (xn_out != nullptr) {
        if (XN_F32) {
          float* xo = static_cast<float*>(xn_out) + base + i;
          store4(xo, y[k]);
          store4(xo + 4, y[k] + 4);
        } else {
          bf16* xo = static_cast<bf16*>(xn_out) + base + i;
          store4(xo, y[k]);
          store4(xo + 4, y[k] + 4);
        }
      }
    }
    if (lane == 0) s[row] = sr.x;
#pragma unroll
    for (int k = 0; k < NV; ++k) cur[k] = nxt[k];
  }
}

// The first design, for rows wider than kLnRegMaxD: one warp a row.
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

template <bool FROM_BF16, bool XN_F32, int L, int NV>
cudaError_t launch_layer_norm_quant_reg(const bf16* x, const float* gamma, const float* beta,
                                        int8_t* q, float* s, void* xn_out, int n, int d,
                                        float eps, cudaStream_t stream) {
  static const int per_sm = ln_blocks_per_sm(layer_norm_quant_reg_kernel<FROM_BF16, XN_F32, L, NV>);
  if (per_sm == 0) return cudaErrorLaunchOutOfResources;
  int sms = 0;
  const cudaError_t e = ln_sm_count(&sms);
  if (e != cudaSuccess) return e;
  constexpr int kWarps = kLnThreads / 32;
  const int blocks = std::min((n + kWarps - 1) / kWarps, per_sm * sms);
  layer_norm_quant_reg_kernel<FROM_BF16, XN_F32, L, NV>
      <<<blocks, kLnThreads, 0, stream>>>(x, gamma, beta, q, s, xn_out, n, d, eps);
  return cudaGetLastError();
}

// d % 8 == 0. xn_out: null, bf16 [n, d], or with XN_F32 fp32 [n, d].
template <bool FROM_BF16, bool XN_F32 = false, int L = kQ8>
cudaError_t launch_layer_norm_quant(const bf16* x, const float* gamma, const float* beta,
                                    int8_t* q, float* s, void* xn_out, int n, int d, float eps,
                                    cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  if (d % 8) return cudaErrorInvalidValue;
  if (d <= kLnRegMaxD) {
    switch ((d + 255) / 256) {  // 16-byte vectors a lane
      case 1:
        return launch_layer_norm_quant_reg<FROM_BF16, XN_F32, L, 1>(x, gamma, beta, q, s, xn_out,
                                                                    n, d, eps, stream);
      case 2:
        return launch_layer_norm_quant_reg<FROM_BF16, XN_F32, L, 2>(x, gamma, beta, q, s, xn_out,
                                                                    n, d, eps, stream);
      case 3:
        return launch_layer_norm_quant_reg<FROM_BF16, XN_F32, L, 3>(x, gamma, beta, q, s, xn_out,
                                                                    n, d, eps, stream);
      case 4:
        return launch_layer_norm_quant_reg<FROM_BF16, XN_F32, L, 4>(x, gamma, beta, q, s, xn_out,
                                                                    n, d, eps, stream);
      default:
        return launch_layer_norm_quant_reg<FROM_BF16, XN_F32, L, 5>(x, gamma, beta, q, s, xn_out,
                                                                    n, d, eps, stream);
    }
  }
  constexpr int kRowsPerBlock = 8;
  layer_norm_quant_kernel<FROM_BF16, XN_F32, L>
      <<<(n + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0, stream>>>(
          x, gamma, beta, q, s, xn_out, n, d, eps);
  return cudaGetLastError();
}

// Four neighbouring values of T held in registers as loaded (8 bytes of bf16,
// 16 of fp32), read back as fp32.
template <typename T>
struct Vec4;
template <>
struct Vec4<bf16> {
  uint2 r;
  __device__ __forceinline__ void load(const bf16* p) { r = *reinterpret_cast<const uint2*>(p); }
  __device__ __forceinline__ float operator[](int t) const {
    return __bfloat162float(reinterpret_cast<const bf16*>(&r)[t]);
  }
};
template <>
struct Vec4<float> {
  float4 r;
  __device__ __forceinline__ void load(const float* p) { r = *reinterpret_cast<const float4*>(p); }
  __device__ __forceinline__ float operator[](int t) const {
    return reinterpret_cast<const float*>(&r)[t];
  }
};

// A lane's registers grow with the width and the operands' bytes: two
// blocks an SM (≤ 128 registers a thread) up to 768 columns with bf16 x and
// bf16 or fp32 dy (123 and 127 registers on sm_90a, no spills), one beyond
// (fp32 x and dy at 768 columns, or 1024 columns, spill at 128).
template <typename TX, typename TD, int NC>
constexpr int ln_bwd_min_blocks() {
  return NC <= 6 && NC * (sizeof(TX) + sizeof(TD)) <= 36 ? kLnBwdBlocksPerSm : 1;
}

// LN backward, one pass over a block's rows [r0, r0 + rows_per_block): a warp
// holds a row's x, dy (and R) in registers, NC chunks of 4 a lane at columns
// (lane + 32 k) 4 (the first design's mapping; d <= 128 NC), recomputes the
// statistics and writes
//   dx = rstd * (dyg - mean(dyg) - xhat * mean(dyg * xhat)),  dyg = dy * gamma
// (the TPU's _ln_bwd_kernel; with R, K2's residual, dx = R + TX(dx_ln)) in
// the first design's order and rounding. Each lane adds dy·x̂ and dy of its
// columns over its warp's rows; the block's eight warps are combined in
// shared memory by a fixed tree (warps 4-7 into 0-3, 2-3 into 0-1, 1 into 0)
// and written as partial row blockIdx.x of part: dγ rows [0, gridDim.x),
// then dβ rows.
template <typename TX, typename TD, int NC>
__global__ void __launch_bounds__(kLnThreads, ln_bwd_min_blocks<TX, TD, NC>())
    layer_norm_bwd_reg_kernel(const TX* __restrict__ x, const float* __restrict__ gamma,
                              const TD* __restrict__ dy, const TX* __restrict__ R,
                              TX* __restrict__ dx, float* __restrict__ part, int n, int d,
                              int rows_per_block, float eps) {
  constexpr int kMaxD = 128 * NC;
  constexpr int kWarps = kLnThreads / 32;
  __shared__ __align__(16) float sg[kMaxD];
  __shared__ __align__(16) float red[kWarps / 2][2][kMaxD];
  for (int i = threadIdx.x * 4; i < d; i += kLnThreads * 4)
    *reinterpret_cast<float4*>(sg + i) = *reinterpret_cast<const float4*>(gamma + i);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);
  const float inv_d = 1.0f / static_cast<float>(d);
  float ag[NC][4], ab[NC][4];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
#pragma unroll
    for (int t = 0; t < 4; ++t) ag[k][t] = ab[k][t] = 0.f;
  }

  for (int row = r0 + warp; row < r1; row += kWarps) {
    const size_t base = static_cast<size_t>(row) * d;
    Vec4<TX> xv[NC], rv[NC];
    Vec4<TD> dv[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = (lane + 32 * k) * 4;
      if (c >= d) continue;
      xv[k].load(x + base + c);
      dv[k].load(dy + base + c);
      if (R != nullptr) rv[k].load(R + base + c);
    }
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      if ((lane + 32 * k) * 4 >= d) continue;
      s = __fadd_rn(s, __fadd_rn(__fadd_rn(xv[k][0], xv[k][1]), __fadd_rn(xv[k][2], xv[k][3])));
    }
    const float mean = __fmul_rn(warp_sum(s), inv_d);
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      if ((lane + 32 * k) * 4 >= d) continue;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float c = __fsub_rn(xv[k][t], mean);
        q = __fmaf_rn(c, c, q);
      }
    }
    const float rstd = rsqrtf(__fmaf_rn(warp_sum(q), inv_d, eps));
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = (lane + 32 * k) * 4;
      if (c >= d) continue;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float dyg = __fmul_rn(dv[k][t], sg[c + t]);
        s1 = __fadd_rn(s1, dyg);
        s2 = __fmaf_rn(dyg, __fmul_rn(__fsub_rn(xv[k][t], mean), rstd), s2);
      }
    }
    const float m1 = __fmul_rn(warp_sum(s1), inv_d);
    const float m2 = __fmul_rn(warp_sum(s2), inv_d);
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = (lane + 32 * k) * 4;
      if (c >= d) continue;
      float out[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float dyv = dv[k][t];
        const float xhat = __fmul_rn(__fsub_rn(xv[k][t], mean), rstd);
        const float dxl = __fmul_rn(rstd, __fmaf_rn(-xhat, m2, __fmaf_rn(dyv, sg[c + t], -m1)));
        out[t] = R != nullptr ? __fadd_rn(rv[k][t], to_float(from_float<TX>(dxl))) : dxl;
        ag[k][t] = __fmaf_rn(dyv, xhat, ag[k][t]);
        ab[k][t] = __fadd_rn(ab[k][t], dyv);
      }
      store4(dx + base + c, out);
    }
  }

#pragma unroll
  for (int half = kWarps / 2; half >= 1; half /= 2) {
    if (warp >= half && warp < 2 * half) {
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int c = (lane + 32 * k) * 4;
        if (c >= d) continue;
        store4(&red[warp - half][0][c], ag[k]);
        store4(&red[warp - half][1][c], ab[k]);
      }
    }
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int c = (lane + 32 * k) * 4;
        if (c >= d) continue;
        float g[4], b[4];
        load4(&red[warp][0][c], g);
        load4(&red[warp][1][c], b);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          ag[k][t] = __fadd_rn(ag[k][t], g[t]);
          ab[k][t] = __fadd_rn(ab[k][t], b[t]);
        }
      }
    }
    __syncthreads();
  }
  if (warp == 0) {
    float* pg = part + static_cast<size_t>(blockIdx.x) * d;
    float* pb = part + static_cast<size_t>(gridDim.x + blockIdx.x) * d;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = (lane + 32 * k) * 4;
      if (c >= d) continue;
      store4(pg + c, ag[k]);
      store4(pb + c, ab[k]);
    }
  }
}

constexpr int kLnFinalCols = 16;   // columns a block of the final pass
constexpr int kLnFinalLanes = 16;  // threads a column

// dγ (blockIdx.y 0) and dβ (1) of the partial rows of layer_norm_bwd_reg_kernel:
// lane l of a column adds the partial rows of its contiguous range of blocks
// in block order, the loads four at a time; the 16 lanes' sums are added in
// lane order. Columns spread over d / 16 blocks.
template <int kDummy = 0>
__global__ void __launch_bounds__(kLnFinalCols * kLnFinalLanes)
    layer_norm_bwd_final_kernel(const float* __restrict__ part, int blocks, int d,
                                float* __restrict__ dgamma, float* __restrict__ dbeta) {
  __shared__ float acc[kLnFinalLanes][kLnFinalCols + 1];
  const int tx = threadIdx.x % kLnFinalCols;
  const int ty = threadIdx.x / kLnFinalCols;
  const int j = blockIdx.x * kLnFinalCols + tx;
  const float* p = part + static_cast<size_t>(blockIdx.y) * blocks * d;
  const int per = (blocks + kLnFinalLanes - 1) / kLnFinalLanes;
  const int b1 = min(blocks, (ty + 1) * per);
  float s = 0.f;
  if (j < d) {
    int b = min(blocks, ty * per);
    for (; b + 4 <= b1; b += 4) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = p[static_cast<size_t>(b + u) * d + j];
#pragma unroll
      for (int u = 0; u < 4; ++u) s = __fadd_rn(s, v[u]);
    }
    for (; b < b1; ++b) s = __fadd_rn(s, p[static_cast<size_t>(b) * d + j]);
  }
  acc[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && j < d) {
    float t = 0.f;
#pragma unroll
    for (int l = 0; l < kLnFinalLanes; ++l) t = __fadd_rn(t, acc[l][tx]);
    (blockIdx.y == 0 ? dgamma : dbeta)[j] = t;
  }
}

// The loop form of the LN backward's row half for d > kLnRegMaxD (the first
// design): the same dx, with each row's mean and rstd written for
// colsum.cuh's dγ/dβ pass. One warp per row, four values a lane, four passes
// over the row; the re-reads hit L1.
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

// Partial rows of one register-path LN backward over n rows: one a block,
// at most kLnBwdBlocksPerSm blocks an SM.
inline int ln_bwd_max_blocks(int n, int sms) {
  const int need = (n + kLnThreads / 32 - 1) / (kLnThreads / 32);
  return std::min(need, kLnBwdBlocksPerSm * sms);
}

// fp32 workspace of one LN backward: up to kLnRegMaxD, the dγ and dβ
// partial rows; beyond, per-row mean and rstd, then colsum.cuh's dβ and dγ
// partials.
inline size_t layer_norm_bwd_workspace(int n, int d) {
  if (d > kLnRegMaxD) return 2 * static_cast<size_t>(n) + 2 * colsum_workspace(n, d);
  int sms = 0;
  if (ln_sm_count(&sms) != cudaSuccess) return 0;  // the launch reports the error
  return 2 * static_cast<size_t>(ln_bwd_max_blocks(n, sms)) * d;
}

template <typename TX, typename TD, int NC>
cudaError_t launch_layer_norm_bwd_reg(const TX* x, const float* gamma, const TD* dy, const TX* R,
                                      TX* dx, float* dgamma, float* dbeta, float* ws, int n,
                                      int d, float eps, cudaStream_t stream) {
  static const int per_sm = ln_blocks_per_sm(layer_norm_bwd_reg_kernel<TX, TD, NC>);
  if (per_sm == 0) return cudaErrorLaunchOutOfResources;
  int sms = 0;
  cudaError_t e = ln_sm_count(&sms);
  if (e != cudaSuccess) return e;
  // a block owns a contiguous range of rows; per_sm caps the grid at the
  // resident blocks, within the workspace's ln_bwd_max_blocks
  int blocks = std::min(ln_bwd_max_blocks(n, sms), std::min(per_sm, kLnBwdBlocksPerSm) * sms);
  const int rows_per_block = (n + blocks - 1) / blocks;
  blocks = (n + rows_per_block - 1) / rows_per_block;
  layer_norm_bwd_reg_kernel<TX, TD, NC><<<blocks, kLnThreads, 0, stream>>>(
      x, gamma, dy, R, dx, ws, n, d, rows_per_block, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  layer_norm_bwd_final_kernel<0>
      <<<dim3((d + kLnFinalCols - 1) / kLnFinalCols, 2), kLnFinalCols * kLnFinalLanes, 0,
         stream>>>(ws, blocks, d, dgamma, dbeta);
  return cudaGetLastError();
}

// dx (TX), dγ = Σ dy·x̂ and dβ = Σ dy (fp32 [d]) of a row LN over x [n, d];
// R (optional) is added to dx in TX. d % 4 == 0, d <= 8192; ws holds
// layer_norm_bwd_workspace(n, d) floats.
template <typename TX, typename TD>
cudaError_t launch_layer_norm_bwd(const TX* x, const float* gamma, const TD* dy, const TX* R,
                                  TX* dx, float* dgamma, float* dbeta, float* ws, int n, int d,
                                  float eps, cudaStream_t stream) {
  if (n == 0) {
    cudaError_t e = cudaMemsetAsync(dgamma, 0, sizeof(float) * d, stream);
    if (e == cudaSuccess) e = cudaMemsetAsync(dbeta, 0, sizeof(float) * d, stream);
    return e;
  }
  if (d <= kLnRegMaxD) {
    switch ((d + 255) / 256) {  // 4-wide chunks a lane: 2, 4, ..., 10
      case 1:
        return launch_layer_norm_bwd_reg<TX, TD, 2>(x, gamma, dy, R, dx, dgamma, dbeta, ws, n, d,
                                                    eps, stream);
      case 2:
        return launch_layer_norm_bwd_reg<TX, TD, 4>(x, gamma, dy, R, dx, dgamma, dbeta, ws, n, d,
                                                    eps, stream);
      case 3:
        return launch_layer_norm_bwd_reg<TX, TD, 6>(x, gamma, dy, R, dx, dgamma, dbeta, ws, n, d,
                                                    eps, stream);
      case 4:
        return launch_layer_norm_bwd_reg<TX, TD, 8>(x, gamma, dy, R, dx, dgamma, dbeta, ws, n, d,
                                                    eps, stream);
      default:
        return launch_layer_norm_bwd_reg<TX, TD, 10>(x, gamma, dy, R, dx, dgamma, dbeta, ws, n,
                                                     d, eps, stream);
    }
  }
  float* mean = ws;
  float* rstd = ws + n;
  constexpr int kRowsPerBlock = kLnThreads / 32;
  layer_norm_bwd_rows_kernel<TX, TD><<<(n + kRowsPerBlock - 1) / kRowsPerBlock, kLnThreads, 0,
                                       stream>>>(x, gamma, dy, R, dx, mean, rstd, n, d, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
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
