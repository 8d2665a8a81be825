// Shared device helpers for the vitax_torch Hopper kernels.
//
// Every entry point in this directory has a plain C interface (loaded with
// ctypes by vitax_torch/kernels/build.py), launches on the stream it is
// given, allocates nothing and returns cudaGetLastError() as an int.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vitax {

// Launches of four first-design pieces, one added where each launches
// (every translation unit shares the one array; read and reset through
// gemm_sm90_s8.cu's vitax_first_design_launches): [0] gemm.cuh's mma.sync s8
// products, [1] attention.cuh's whole-row forward core, [2] attention_bwd.cuh's
// whole-row backward core, [3] gemm.cuh's bf16 WMMA products. A card run
// reads that a path on the Hopper halves launched none of them.
constexpr int kFirstDesignPieces = 4;
inline long long first_design_launches[kFirstDesignPieces] = {};

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype(bf16)
}
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

// Four neighbouring values <-> fp32 (8-byte bf16 or 16-byte fp32 vectors;
// the element offset must be a multiple of 4).
__device__ __forceinline__ void load4(const bf16* p, float v[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const bf16* b = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int t = 0; t < 4; ++t) v[t] = __bfloat162float(b[t]);
}
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 raw = *reinterpret_cast<const float4*>(p);
  v[0] = raw.x, v[1] = raw.y, v[2] = raw.z, v[3] = raw.w;
}
__device__ __forceinline__ void store4(bf16* p, const float v[4]) {
  uint2 raw;
  bf16* b = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int t = 0; t < 4; ++t) b[t] = __float2bfloat16(v[t]);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16-byte global -> shared copy; src_bytes == 0 zero-fills the destination
// (used to mask the ragged edge of a tile without branching around the copy).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace vitax
