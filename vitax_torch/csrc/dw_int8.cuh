// int8_dw: the per-group int8 weight grads of K3's and K4's backwards, the
// Jetfire-style branch of _ln_mlp_bwd_int8_kernel (vitax/ops/pallas_kernels.py:
// 1173-1197) and of _ln_qkvo_bwd_int8_kernel (:3041-3049, :3077-3084), with
// row-scale folding:
//
//   dW = sum over row groups z of f32(quant_cols(A_z * u_z)^T @ Q_z) * s_z
//
// Q [n, wb] are the per-row int8 codes that the dx-path products already made
// (do, dh1, dqkv) and u [n] their row scales; the scales ride the contraction
// axis, so they are folded into the co-operand A [n, wa] (h1, xn, attn, xn32)
// before its per-column quantization over the group's rows (_quant_cols :907,
// a reciprocal multiply, as _quant_rows); s_z [wa] are those column scales.
// int32 sums inside a group, fp32 across groups in group order.
//
// The TPU kernel's group is one grid step's row chunk. This port picks its
// own (ops/cuda_kernels.py: K4 fixed 128-row groups, the last one ragged; K3
// whole images, tile*spq rows with vitax's tile rule) and passes it in.
//
// Three launches a weight grad (steps 1 and 2 are launch_dw_int8_operands;
// K3's, K4's and K8's int8 backwards run step 3 on gemm_sm90.cuh's s8 wgmma
// path, kEpiS8Group, and K12-int8's on gemm.cuh's; each group's rows are
// padded to kDwPad, gemm_sm90.cuh's 128-code K tile, which gemm.cuh's
// 64-deep stages divide):
//   1. dw_quant_cols_t_kernel: a block per (group, 64 columns) takes the
//      columns' amax over the group's rows, then writes the codes transposed,
//      At [wa, kp], through a shared tile of 64 rows; each group's rows are
//      zero-padded to gp (a whole number of the s8 GEMM's K tiles), kp =
//      groups * gp;
//   2. dw_codes_t_kernel: the byte transpose of Q into Qt [wb, kp], with the
//      same padding (the s8 GEMM takes one layout, K contiguous), 4-byte
//      words in and out of a 64 × 128 shared tile;
//   3. the s8 GEMM with the group epilogue (gemm.cuh kS8GroupF32, or
//      gemm_sm90.cuh kEpiS8Group): each output tile walks all groups in
//      order, folding its int32 accumulator into fp32 at each group's end.
//      No partials in device memory, no atomics: the same bits each run,
//      and the same bits on either GEMM.
// Bound on the H100: the s8 product, 2*wa*wb*n operations (1979 TOP/s);
// the two transposes move 2-3 bytes an element of A and Q. A 768x768 grad
// is 36 output tiles for 132 SMs, and K is not split (the fold's order).
//
// The int4_grad backwards' int8_dw (K11, pallas_kernels.py:1057-1074,
// :3033-3040, :3071-3076) cannot fold: their row codes are int4, and vitax
// packs both dW operands fresh, per column over the group, at int8:
//
//   dW = sum over z of f32(quant_cols(A_z)^T @ quant_cols(B_z)) * sa_z * sb_z
//
// launch_dw_cols_operands runs step 1 on each operand (no row scale); the
// s8 GEMM with both scale vectors is gemm_sm90.cuh's kEpiS8GroupRC (K11-B,
// K11-D, G-B, R-B), in the order of gemm.cuh's kS8GroupF32RC, which stays
// as the fold's second implementation (vitax_gemm_s8_groups_rc).
#pragma once

#include "gemm.cuh"
#include "quant.cuh"

namespace vitax {

// a group's rows zero-padded to whole K tiles of the s8 GEMMs: gemm_sm90.cuh's
// kBK8, a whole number of gemm.cuh's kS8BK
constexpr int kDwPad = 128;
static_assert(kDwPad % kS8BK == 0, "gemm.cuh's stages divide the pad");
inline int dw_group_pad(int group) { return (group + kDwPad - 1) / kDwPad * kDwPad; }

inline int dw_groups(int n, int group) { return (n + group - 1) / group; }

// Two neighbouring values -> fp32 (element offset even)
__device__ __forceinline__ void load2(const bf16* p, float v[2]) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  v[0] = f.x, v[1] = f.y;
}
__device__ __forceinline__ void load2(const float* p, float v[2]) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  v[0] = f.x, v[1] = f.y;
}

// At[c][z*gp + r] = code of A[z*group + r][c] * u[z*group + r] (u null:
// of A itself) with the column's scale over group z, sc[z*wa + c] = that
// scale; 0 for r past the group's rows. A block takes 64 columns of a group,
// a lane two neighbouring ones (4- or 8-byte loads, 128 or 256 bytes a warp
// a row), 8 row lanes: the columns' amax over the group's rows, then the
// codes of 64 rows at a time into a shared tile held column-major, written
// out as 64-byte runs of At's rows. grid (ceil(wa/64), groups), block (32,
// 8); wa % 2 == 0, gp % 64 == 0.
template <typename T>
__global__ void __launch_bounds__(256)
    dw_quant_cols_t_kernel(const T* __restrict__ a, const float* __restrict__ u,
                           int8_t* __restrict__ at, float* __restrict__ sc, int n, int wa,
                           int group, int gp, int kp) {
  __shared__ float part[8][64];
  __shared__ uint32_t tile[64][17];  // [column][64 rows of codes], one pad word
  const int z = blockIdx.y;
  const int c0 = blockIdx.x * 64;
  const int col = c0 + 2 * threadIdx.x;  // this lane's columns col, col + 1
  const bool ok = col < wa;
  const int r0 = z * group;
  const int rows = min(group, n - r0);
  auto val2 = [&](int r, float v[2]) {
    load2(a + static_cast<size_t>(r0 + r) * wa + col, v);
    if (u != nullptr) v[0] = v[0] * u[r0 + r], v[1] = v[1] * u[r0 + r];
  };
  float amax[2] = {0.f, 0.f};
  if (ok)
    for (int r = threadIdx.y; r < rows; r += 8) {
      float v[2];
      val2(r, v);
      amax[0] = fmaxf(amax[0], fabsf(v[0])), amax[1] = fmaxf(amax[1], fabsf(v[1]));
    }
  part[threadIdx.y][2 * threadIdx.x] = amax[0];
  part[threadIdx.y][2 * threadIdx.x + 1] = amax[1];
  __syncthreads();
  float2 sr[2];  // (scale, reciprocal) of columns col and col + 1
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float m = part[0][2 * threadIdx.x + e];
#pragma unroll
    for (int l = 1; l < 8; ++l) m = fmaxf(m, part[l][2 * threadIdx.x + e]);
    sr[e] = quant_scale(m);
  }
  if (threadIdx.y == 0 && ok) {
    sc[static_cast<size_t>(z) * wa + col] = sr[0].x;
    sc[static_cast<size_t>(z) * wa + col + 1] = sr[1].x;
  }
  int8_t* tb = reinterpret_cast<int8_t*>(tile);
  constexpr int kColBytes = 17 * 4;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  for (int t0 = 0; t0 < gp; t0 += 64) {
    for (int rr = threadIdx.y; rr < 64; rr += 8) {
      const int r = t0 + rr;
      int8_t q[2] = {0, 0};
      if (r < rows && ok) {
        float v[2];
        val2(r, v);
        q[0] = quant_i8(v[0], sr[0].y), q[1] = quant_i8(v[1], sr[1].y);
      }
      tb[(2 * threadIdx.x) * kColBytes + rr] = q[0];
      tb[(2 * threadIdx.x + 1) * kColBytes + rr] = q[1];
    }
    __syncthreads();
    for (int i = tid; i < 64 * 16; i += 256) {
      const int cl = i / 16, w = i % 16;
      if (c0 + cl < wa)
        *reinterpret_cast<uint32_t*>(at + static_cast<size_t>(c0 + cl) * kp + z * gp + t0 +
                                     4 * w) = tile[cl][w];
    }
    __syncthreads();
  }
}

// Qt[c][z*gp + r] = Q[z*group + r][c], 0 past the group's rows: a block
// moves 64 rows of a group by 128 columns through a shared tile, 4-byte
// words in (a warp a 128-byte row) and out (64-byte runs of Qt's rows).
// grid (ceil(wb/128), groups * gp/64), block 256; wb % 4 == 0, gp % 64 == 0.
template <int kDummy = 0>
__global__ void __launch_bounds__(256)
    dw_codes_t_kernel(const int8_t* __restrict__ q, int8_t* __restrict__ qt, int n, int wb,
                      int group, int gp, int kp) {
  __shared__ uint32_t tile[64][33];  // [64 rows][128 bytes], one pad word
  const int tiles = gp / 64;
  const int z = blockIdx.y / tiles;
  const int t0 = (blockIdx.y % tiles) * 64;
  const int c0 = blockIdx.x * 128;
  const int rows = min(group, n - z * group);
  const int lane = threadIdx.x % 32;
  for (int rr = threadIdx.x / 32; rr < 64; rr += 8) {
    const int r = t0 + rr;
    const int c = c0 + 4 * lane;
    tile[rr][lane] = r < rows && c < wb
                         ? *reinterpret_cast<const uint32_t*>(
                               q + static_cast<size_t>(z * group + r) * wb + c)
                         : 0u;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 128 * 16; i += 256) {
    const int cc = i / 16, w = i % 16;  // Qt's row c0 + cc, its word w
    if (c0 + cc >= wb) continue;
    uint32_t out = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      out |= ((tile[4 * w + b][cc / 4] >> (8 * (cc % 4))) & 0xffu) << (8 * b);
    *reinterpret_cast<uint32_t*>(qt + static_cast<size_t>(c0 + cc) * kp + z * gp + t0 + 4 * w) =
        out;
  }
}

// Steps 1 and 2 of the int8_dw weight grad of A [n, wa] (T: bf16 or fp32)
// with row scales u [n] against the row codes Q [n, wb], each group's rows
// zero-padded to gp (a multiple of 64): at int8 [wa, kp], sc fp32 [groups,
// wa], qt int8 [wb, kp], kp = groups * gp; wa % 2 == 0, wb % 4 == 0. The
// product is the caller's (gemm.cuh's launch_gemm_s8_groups, or
// gemm_sm90.cuh's gemm_s8_groups).
template <typename T>
cudaError_t launch_dw_int8_operands(const T* a, const float* u, const int8_t* q, int n, int wa,
                                    int wb, int group, int gp, int8_t* at, float* sc, int8_t* qt,
                                    cudaStream_t stream) {
  if (group <= 0 || gp < group || gp % 64 || wa % 2 || wb % 4) return cudaErrorInvalidValue;
  const int groups = dw_groups(n, group);
  const int kp = groups * gp;
  if (groups == 0) return cudaSuccess;
  dw_quant_cols_t_kernel<T><<<dim3((wa + 63) / 64, groups), dim3(32, 8), 0, stream>>>(
      a, u, at, sc, n, wa, group, gp, kp);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dw_codes_t_kernel<0><<<dim3((wb + 127) / 128, groups * (gp / 64)), 256, 0, stream>>>(
      q, qt, n, wb, group, gp, kp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw_int8(const T* a, const float* u, const int8_t* q, int n, int wa, int wb,
                           int group, int8_t* at, float* sc, int8_t* qt, float* F,
                           cudaStream_t stream, bool transpose = false) {
  if (group <= 0) return cudaErrorInvalidValue;
  const int gp = dw_group_pad(group);
  const cudaError_t e = launch_dw_int8_operands(a, u, q, n, wa, wb, group, gp, at, sc, qt, stream);
  if (e != cudaSuccess) return e;
  return launch_gemm_s8_groups(at, qt, sc, F, wa, wb, dw_groups(n, group) * gp, gp, stream,
                               transpose);
}

// The two operands of the int4_grad int8_dw weight grad of A [n, wa]
// against B [n, wb] (TA, TB: bf16 or fp32), both quantized per column over
// each group with no row scale, each group's rows zero-padded to gp (a
// multiple of 64): at int8 [wa, kp], sa fp32 [groups, wa], bt int8 [wb, kp],
// sb fp32 [groups, wb], kp = groups * gp. wa % 2 == 0, wb % 2 == 0.
template <typename TA, typename TB>
cudaError_t launch_dw_cols_operands(const TA* a, const TB* b, int n, int wa, int wb, int group,
                                    int gp, int8_t* at, float* sa, int8_t* bt, float* sb,
                                    cudaStream_t stream) {
  if (group <= 0 || gp < group || gp % 64 || wa % 2 || wb % 2) return cudaErrorInvalidValue;
  const int groups = dw_groups(n, group);
  const int kp = groups * gp;
  if (groups == 0) return cudaSuccess;
  dw_quant_cols_t_kernel<TA><<<dim3((wa + 63) / 64, groups), dim3(32, 8), 0, stream>>>(
      a, nullptr, at, sa, n, wa, group, gp, kp);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dw_quant_cols_t_kernel<TB><<<dim3((wb + 63) / 64, groups), dim3(32, 8), 0, stream>>>(
      b, nullptr, bt, sb, n, wb, group, gp, kp);
  return cudaGetLastError();
}

}  // namespace vitax
