// Per-row symmetric quantization of activations, the W8A8 and A4W4 tiers'
// only quantization inside a kernel: vitax's _quant_rows / _pack_i8 and
// _quant_rows4 / _pack_i4 (vitax/ops/pallas_kernels.py:659-680, :917-937),
// with their grids so that the integer products are the same integers:
//   amax = max(max|x|, 1e-12), s = amax * (1/L), r = L / amax,
//   q = clip(rint(x * r), -L, L)
// for L = 127 (int8) or 7 (int4; the codes live in int8, as in vitax's
// interpret mode, _i4_dtype :917: an s8 product of values in [-7, 7] gives
// the int32 sums of an int4 one). 1/L is the fp32 rounding of the double
// quotient, as vitax's Python float reaches its fp32 arrays. rint rounds
// half to even, as jnp.round; r is one IEEE division a row and the codes a
// multiply by it, as the TPU kernels write it. The files that include this
// header are built without --use_fast_math (kernels/build.py), which would
// turn the division into an approximate reciprocal.
//
// quant_rows_kernel quantizes rows of an fp32 or bf16 matrix [n, w] (attn,
// gelu_q(a1), do, dqkv, dh1): one warp a row, an amax pass and a quantize
// pass over the row (the re-read hits L1; a row is at most 12 KB).
// Bound on the H100: device memory (read 2-4 bytes, write 1 byte an
// element). Every quantization group is one row, so no reduction crosses a
// block.
#pragma once

#include "common.cuh"

namespace vitax {

constexpr int kQ8 = 127;  // the int8 grid's limit
constexpr int kQ4 = 7;    // the int4 grid's

// (scale, reciprocal) of a row from its max |x|, on the grid of limit L.
template <int L = kQ8>
__device__ __forceinline__ float2 quant_scale(float amax) {
  amax = fmaxf(amax, 1e-12f);
  return make_float2(amax * static_cast<float>(1.0 / L), static_cast<float>(L) / amax);
}

template <int L = kQ8>
__device__ __forceinline__ int8_t quant_i8(float v, float r) {
  return static_cast<int8_t>(
      fminf(fmaxf(rintf(v * r), -static_cast<float>(L)), static_cast<float>(L)));
}

// Eight neighbouring values -> fp32 (element offset a multiple of 8).
template <typename T>
__device__ __forceinline__ void load8(const T* p, float v[8]) {
  load4(p, v);
  load4(p + 4, v + 4);
}

template <typename T, int L>
__global__ void __launch_bounds__(256)
    quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s,
                      int n, int w) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const T* xr = x + static_cast<size_t>(row) * w;
  float amax = 0.f;
  for (int i = lane * 8; i < w; i += 256) {
    float v[8];
    load8(xr + i, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
  const float2 sr = quant_scale<L>(warp_max(amax));
  int8_t* qr = q + static_cast<size_t>(row) * w;
  for (int i = lane * 8; i < w; i += 256) {
    float v[8];
    load8(xr + i, v);
    __align__(8) int8_t o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = quant_i8<L>(v[e], sr.y);
    *reinterpret_cast<uint2*>(qr + i) = *reinterpret_cast<const uint2*>(o);
  }
  if (lane == 0) s[row] = sr.x;
}

// Codes q [n, w] and scales s [n] of the rows of x on the grid of limit L;
// w % 8 == 0.
template <int L = kQ8, typename T>
cudaError_t launch_quant_rows(const T* x, int8_t* q, float* s, int n, int w,
                              cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  if (w % 8) return cudaErrorInvalidValue;
  constexpr int kRowsPerBlock = 8;
  quant_rows_kernel<T, L><<<(n + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0,
                         stream>>>(x, q, s, n, w);
  return cudaGetLastError();
}

// -----------------------------------------------------------------------------
// Weights, once a call: vitax's _quant_cols_host / _quant_rows_host
// (pallas_kernels.py:888-904) and their int4 forms _quant_cols_host4 /
// _quant_rows_host4 (:941-957), run in XLA outside the TPU kernels:
//   s = max(amax, 1e-12) / L,  q = clip(rint(w / s), -L, L)
// both IEEE divisions, as the port's torch quantizer (ops/quant.py) writes
// them, so the codes are the same bits. Per output column of a [K, N]
// weight, written transposed [N, K] (the s8 GEMM's B layout), or per row,
// as it is. Bound: launches, not bytes (a ViT-B/16 weight is 1.2-4.7 MB);
// three small kernels replace the ~10 torch ops a weight would take.

template <int L>
__device__ __forceinline__ float weight_scale(float amax) {
  return fmaxf(amax, 1e-12f) / static_cast<float>(L);
}

template <int L>
__device__ __forceinline__ int8_t weight_code(float w, float s) {
  return static_cast<int8_t>(
      fminf(fmaxf(rintf(w / s), -static_cast<float>(L)), static_cast<float>(L)));
}

// s[n] of each column of w [K, N]: a block covers 32 columns with 8 row
// lanes, the lanes' maxima combined in shared memory.
template <int L>
__global__ void __launch_bounds__(256)
    weight_col_scale_kernel(const bf16* __restrict__ w, float* __restrict__ s, int K, int N) {
  __shared__ float part[8][32];
  const int n = blockIdx.x * 32 + threadIdx.x;
  float amax = 0.f;
  if (n < N)
    for (int k = threadIdx.y; k < K; k += 8)
      amax = fmaxf(amax, fabsf(__bfloat162float(w[static_cast<size_t>(k) * N + n])));
  part[threadIdx.y][threadIdx.x] = amax;
  __syncthreads();
  if (threadIdx.y == 0 && n < N) {
#pragma unroll
    for (int l = 1; l < 8; ++l) amax = fmaxf(amax, part[l][threadIdx.x]);
    s[n] = weight_scale<L>(amax);
  }
}

// qt[n][k] = code of w[k][n] with s[n]: 32x32 tiles through shared memory so
// that both the read and the transposed write are coalesced.
template <int L>
__global__ void __launch_bounds__(256)
    weight_cols_t_kernel(const bf16* __restrict__ w, const float* __restrict__ s,
                         int8_t* __restrict__ qt, int K, int N) {
  __shared__ int8_t tile[32][33];
  const int n0 = blockIdx.x * 32;
  const int k0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int k = k0 + r;
    const int n = n0 + threadIdx.x;
    if (k < K && n < N)
      tile[r][threadIdx.x] =
          weight_code<L>(__bfloat162float(w[static_cast<size_t>(k) * N + n]), s[n]);
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int n = n0 + r;
    const int k = k0 + threadIdx.x;
    if (n < N && k < K) qt[static_cast<size_t>(n) * K + k] = tile[threadIdx.x][r];
  }
}

// q[k][:] and s[k] of each row of w [K, N] (row stride ld): one warp a row;
// N % 8 == 0.
template <int L>
__global__ void __launch_bounds__(256)
    weight_rows_kernel(const bf16* __restrict__ w, int8_t* __restrict__ q,
                       float* __restrict__ s, int K, int N, int ld) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= K) return;
  const bf16* wr = w + static_cast<size_t>(row) * ld;
  float amax = 0.f;
  for (int i = lane * 8; i < N; i += 256) {
    float v[8];
    load8(wr + i, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
  const float sc = weight_scale<L>(warp_max(amax));
  int8_t* qr = q + static_cast<size_t>(row) * N;
  for (int i = lane * 8; i < N; i += 256) {
    float v[8];
    load8(wr + i, v);
    __align__(8) int8_t o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = weight_code<L>(v[e], sc);
    *reinterpret_cast<uint2*>(qr + i) = *reinterpret_cast<const uint2*>(o);
  }
  if (lane == 0) s[row] = sc;
}

// Per-column codes of w [K, N] on the grid of limit L, transposed to qt
// [N, K], and s [N].
template <int L = kQ8>
cudaError_t launch_quant_weight_cols_t(const bf16* w, int8_t* qt, float* s, int K, int N,
                                              cudaStream_t stream) {
  if (K == 0 || N == 0) return cudaSuccess;
  weight_col_scale_kernel<L><<<(N + 31) / 32, dim3(32, 8), 0, stream>>>(w, s, K, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  weight_cols_t_kernel<L><<<dim3((N + 31) / 32, (K + 31) / 32), dim3(32, 8), 0, stream>>>(
      w, s, qt, K, N);
  return cudaGetLastError();
}

// Per-row codes q [K, N] and s [K] of w [K, N] on the grid of limit L;
// N % 8 == 0. ld is w's row
// stride (0: N), so w may be a column slice of a wider weight (K8's Wq and
// Wkv, whose row codes are their own, not those of Wqkv's whole rows).
template <int L = kQ8>
cudaError_t launch_quant_weight_rows(const bf16* w, int8_t* q, float* s, int K, int N,
                                            cudaStream_t stream, int ld = 0) {
  if (K == 0) return cudaSuccess;
  if (ld == 0) ld = N;
  if (N % 8 || ld % 8 || ld < N) return cudaErrorInvalidValue;
  weight_rows_kernel<L><<<(K + 7) / 8, 256, 0, stream>>>(w, q, s, K, N, ld);
  return cudaGetLastError();
}

}  // namespace vitax
