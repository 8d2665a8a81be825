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
// Design of this first version, three launches a weight grad:
//   1. dw_quant_cols_t_kernel: a block per (group, 32 columns) takes the
//      columns' amax over the group's rows, then writes the codes transposed,
//      At [wa, kp], through a 32x32 shared tile; each group's rows are
//      zero-padded to gp = round_up(group, 64) (a whole number of the s8
//      GEMM's 64-deep K stages), kp = groups * gp;
//   2. dw_codes_t_kernel: the byte transpose of Q into Qt [wb, kp], with the
//      same padding (the s8 GEMM takes one layout, K contiguous);
//   3. the s8 GEMM with the group epilogue (gemm.cuh kS8GroupF32): each
//      output tile walks all groups in order, folding its int32 accumulator
//      into fp32 at each group's end. No partials in device memory, no
//      atomics: the same bits each run.
// Bound on the H100: the s8 product, 2*wa*wb*n operations (1979 TOP/s);
// the two transposes move 2-3 bytes an element of A and Q. Nothing here is
// tuned: a 768x768 grad is 36 output tiles for 132 SMs.
//
// The int4_grad backwards' int8_dw (K11, pallas_kernels.py:1057-1074,
// :3033-3040, :3071-3076) cannot fold: their row codes are int4, and vitax
// packs both dW operands fresh, per column over the group, at int8:
//
//   dW = sum over z of f32(quant_cols(A_z)^T @ quant_cols(B_z)) * sa_z * sb_z
//
// launch_dw_int8_cols runs step 1 on each operand (no row scale) and the s8
// GEMM with both scale vectors (gemm.cuh kS8GroupF32RC).
#pragma once

#include "gemm.cuh"
#include "quant.cuh"

namespace vitax {

// a group's rows zero-padded to whole K stages of the s8 GEMM
inline int dw_group_pad(int group) { return (group + kS8BK - 1) / kS8BK * kS8BK; }

inline int dw_groups(int n, int group) { return (n + group - 1) / group; }

// At[c][z*gp + r] = code of A[z*group + r][c] * u[z*group + r] (u null:
// of A itself) with the column's scale over group z, sc[z*wa + c] = that
// scale; 0 for r past the group's rows. grid (ceil(wa/32), groups), block
// (32, 8).
template <typename T>
__global__ void __launch_bounds__(256)
    dw_quant_cols_t_kernel(const T* __restrict__ a, const float* __restrict__ u,
                           int8_t* __restrict__ at, float* __restrict__ sc, int n, int wa,
                           int group, int gp, int kp) {
  __shared__ float part[8][32];
  __shared__ int8_t tile[32][33];
  const int z = blockIdx.y;
  const int c0 = blockIdx.x * 32;
  const int col = c0 + threadIdx.x;
  const int r0 = z * group;
  const int rows = min(group, n - r0);
  auto val = [&](int r) {
    const float v = to_float(a[static_cast<size_t>(r0 + r) * wa + col]);
    return u != nullptr ? v * u[r0 + r] : v;
  };
  float amax = 0.f;
  if (col < wa)
    for (int r = threadIdx.y; r < rows; r += 8) amax = fmaxf(amax, fabsf(val(r)));
  part[threadIdx.y][threadIdx.x] = amax;
  __syncthreads();
  amax = part[0][threadIdx.x];
#pragma unroll
  for (int l = 1; l < 8; ++l) amax = fmaxf(amax, part[l][threadIdx.x]);
  const float2 sr = quant_scale(amax);  // (scale, reciprocal) of column col
  if (threadIdx.y == 0 && col < wa) sc[static_cast<size_t>(z) * wa + col] = sr.x;
  for (int t0 = 0; t0 < gp; t0 += 32) {
    for (int rr = threadIdx.y; rr < 32; rr += 8) {
      const int r = t0 + rr;
      int8_t q = 0;
      if (r < rows && col < wa) q = quant_i8(val(r), sr.y);
      tile[rr][threadIdx.x] = q;
    }
    __syncthreads();
    for (int cc = threadIdx.y; cc < 32; cc += 8) {
      const int c = c0 + cc;
      if (c < wa) at[static_cast<size_t>(c) * kp + z * gp + t0 + threadIdx.x] = tile[threadIdx.x][cc];
    }
    __syncthreads();
  }
}

// Qt[c][z*gp + r] = Q[z*group + r][c], 0 past the group's rows. grid
// (ceil(wb/32), groups * gp/32), block (32, 8).
template <int kDummy = 0>
__global__ void __launch_bounds__(256)
    dw_codes_t_kernel(const int8_t* __restrict__ q, int8_t* __restrict__ qt, int n, int wb,
                      int group, int gp, int kp) {
  __shared__ int8_t tile[32][33];
  const int tiles = gp / 32;
  const int z = blockIdx.y / tiles;
  const int t0 = (blockIdx.y % tiles) * 32;
  const int c0 = blockIdx.x * 32;
  const int rows = min(group, n - z * group);
  for (int rr = threadIdx.y; rr < 32; rr += 8) {
    const int r = t0 + rr;
    const int c = c0 + threadIdx.x;
    tile[rr][threadIdx.x] =
        r < rows && c < wb ? q[static_cast<size_t>(z * group + r) * wb + c] : int8_t(0);
  }
  __syncthreads();
  for (int cc = threadIdx.y; cc < 32; cc += 8) {
    const int c = c0 + cc;
    if (c < wb) qt[static_cast<size_t>(c) * kp + z * gp + t0 + threadIdx.x] = tile[threadIdx.x][cc];
  }
}

// F [wa, wb] = the int8_dw weight grad of A [n, wa] (T: bf16 or fp32) with
// row scales u [n] against the row codes Q [n, wb], or with `transpose` its
// transpose F [wb, wa] (the save-acts backward's dW2 = h1q^T quant_cols(sh do),
// where the codes are h1's, not do's). Scratch: at int8 [wa, kp], sc fp32
// [groups, wa], qt int8 [wb, kp], kp = groups * gp. wa % 2 == 0, wb % 2 == 0.
template <typename T>
cudaError_t launch_dw_int8(const T* a, const float* u, const int8_t* q, int n, int wa, int wb,
                           int group, int8_t* at, float* sc, int8_t* qt, float* F,
                           cudaStream_t stream, bool transpose = false) {
  if (group <= 0) return cudaErrorInvalidValue;
  const int gp = dw_group_pad(group);
  const int groups = dw_groups(n, group);
  const int kp = groups * gp;
  if (groups > 0) {
    dw_quant_cols_t_kernel<T><<<dim3((wa + 31) / 32, groups), dim3(32, 8), 0, stream>>>(
        a, u, at, sc, n, wa, group, gp, kp);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    dw_codes_t_kernel<0><<<dim3((wb + 31) / 32, groups * (gp / 32)), dim3(32, 8), 0, stream>>>(
        q, qt, n, wb, group, gp, kp);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return launch_gemm_s8_groups(at, qt, sc, F, wa, wb, kp, gp, stream, transpose);
}

// F [wa, wb] = the int8_dw weight grad of A [n, wa] against B [n, wb] (TA,
// TB: bf16 or fp32), both quantized per column over each group with no row
// scale. Scratch: at int8 [wa, kp], sa fp32 [groups, wa], bt int8 [wb, kp],
// sb fp32 [groups, wb]. wb % 2 == 0.
template <typename TA, typename TB>
cudaError_t launch_dw_int8_cols(const TA* a, const TB* b, int n, int wa, int wb, int group,
                                int8_t* at, float* sa, int8_t* bt, float* sb, float* F,
                                cudaStream_t stream) {
  if (group <= 0) return cudaErrorInvalidValue;
  const int gp = dw_group_pad(group);
  const int groups = dw_groups(n, group);
  const int kp = groups * gp;
  if (groups > 0) {
    dw_quant_cols_t_kernel<TA><<<dim3((wa + 31) / 32, groups), dim3(32, 8), 0, stream>>>(
        a, nullptr, at, sa, n, wa, group, gp, kp);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    dw_quant_cols_t_kernel<TB><<<dim3((wb + 31) / 32, groups), dim3(32, 8), 0, stream>>>(
        b, nullptr, bt, sb, n, wb, group, gp, kp);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return launch_gemm_s8_groups(at, bt, sa, F, wa, wb, kp, gp, stream, false, sb);
}

}  // namespace vitax
