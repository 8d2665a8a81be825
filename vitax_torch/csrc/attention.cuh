// The whole-row attention core of K1's first design (per image and head:
// scores, exact fp32 softmax over the whole row, P·V); K1 now runs K13's
// core (attention_core.cuh) with kv_heads == heads. Shared by K7's forward
// (the GQA branch of ln_qkvo_attention.cu) and the recompute in its
// backward, and by K3 (the int8 tier), whose forward takes
// the fp32 P·V (OutT = float: vitax never rounds the int8 kernel's attn to
// bf16 before quantizing it, pallas_kernels.py:2732-2737). Design notes:
// ln_qkvo_attention.cu.
//
// One core serves two geometries (AttnGeom): GQA (K7), where the
// packed row is [q (H·hd) | k (Hkv·hd) | v (Hkv·hd)] and query head h reads
// kv group g = h·Hkv/H (vitax's _kv_off, pallas_kernels.py:2803), and the rect core
// (K8), whose q_rows query rows per image (the compacted cpq) come from their
// own buffer and attend over kv_rows key rows (spq) of another. Each query
// row's result depends only on its own Q row and the image's K and V, so the
// rect core gives the square core's bits on the same rows.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace vitax {

constexpr int kSmemLimit = 232448;  // 227 KB, the most a block may opt into

__host__ __device__ inline int attn_rows_padded(int spq) { return (spq + 15) / 16 * 16; }

__host__ __device__ inline size_t attn_smem_bytes(int spq, int hd, int warps) {
  const size_t L = attn_rows_padded(spq);
  const size_t sw = L > static_cast<size_t>(hd) ? L : hd;
  return 2 * L * hd * 2 + warps * (16 * hd * 2 + 16 * sw * 4 + 16 * L * 2);
}

// Stage K and V of one head ([rows, HD] slices at column k_col of the rows
// at kbase and v_col of those at vbase, one image each, both of row stride
// row_stride) into shared memory as [L, HD], zero past rows.
template <int HD>
__device__ __forceinline__ void attn_stage_kv(const bf16* __restrict__ kbase,
                                              const bf16* __restrict__ vbase, size_t row_stride,
                                              int k_col, int v_col, int rows, int L, bf16* Ks,
                                              bf16* Vs) {
  constexpr int kVecs = HD / 8;  // 16-byte vectors per head row
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < L * kVecs; i += blockDim.x) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    uint4 kv = zero, vv = zero;
    if (r < rows) {
      kv = *reinterpret_cast<const uint4*>(kbase + r * row_stride + k_col + c);
      vv = *reinterpret_cast<const uint4*>(vbase + r * row_stride + v_col + c);
    }
    *reinterpret_cast<uint4*>(Ks + r * HD + c) = kv;
    *reinterpret_cast<uint4*>(Vs + r * HD + c) = vv;
  }
}

// Copy 16 rows [q0, q0+16) of a [.., ld]-strided bf16 matrix, columns
// [col, col+HD), into a warp's [16, HD] tile, zero past spq.
template <int HD>
__device__ __forceinline__ void attn_load_tile16(const bf16* __restrict__ src, size_t ld, int col,
                                                 int q0, int spq, bf16* dst) {
  constexpr int kVecs = HD / 8;
  const int lane = threadIdx.x % 32;
  for (int i = lane; i < 16 * kVecs; i += 32) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (q0 + r < spq) v = *reinterpret_cast<const uint4*>(src + (q0 + r) * ld + col + c);
    *reinterpret_cast<uint4*>(dst + r * HD + c) = v;
  }
}

// S[16, L] = (Q K^T) for a warp's 16 query rows over all L key rows (fp32,
// row stride sw), on the tensor cores.
template <int HD>
__device__ __forceinline__ void attn_scores(const bf16* Qs, const bf16* Ks, int L, float* S,
                                            int sw) {
  using namespace nvcuda;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[HD / 16];
#pragma unroll
  for (int k = 0; k < HD / 16; ++k) wmma::load_matrix_sync(qa[k], Qs + k * 16, HD);
  for (int j = 0; j < L / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
      wmma::load_matrix_sync(kb, Ks + j * 16 * HD + k * 16, HD);
      wmma::mma_sync(acc, qa[k], kb, acc);
    }
    wmma::store_matrix_sync(S + j * 16, acc, sw, wmma::mem_row_major);
  }
  __syncwarp();
}

// Row r of S becomes the exact fp32 softmax of scale*S over columns
// < seq_len (columns >= seq_len get -1e30 before the max, so exactly 0):
// p = e * (1/sum), as the TPU's _softmax_rows.
__device__ __forceinline__ void attn_softmax_row(float* srow, int L, int seq_len, float scale) {
  const int lane = threadIdx.x % 32;
  float mx = -INFINITY;
  for (int c = lane; c < L; c += 32) {
    const float v = c < seq_len ? srow[c] * scale : -1e30f;
    srow[c] = v;
    mx = fmaxf(mx, v);
  }
  mx = warp_max(mx);
  float sum = 0.f;
  for (int c = lane; c < L; c += 32) {
    const float e = expf(srow[c] - mx);
    srow[c] = e;
    sum += e;
  }
  const float inv = 1.0f / warp_sum(sum);
  for (int c = lane; c < L; c += 32) srow[c] *= inv;
}

// Where the core reads: Q rows [b·q_rows + r] of q (row stride q_ld, head h
// at column h·HD), K and V rows [b·kv_rows + r] of kv (row stride kv_ld, kv
// group g at columns k_off + g·HD and v_off + g·HD); out [b·q_rows, H·HD].
// V's rows come from their own tensor v where it is set (K13, whose K and V
// are two tensors of one layout, row stride kv_ld), else from kv.
struct AttnGeom {
  const bf16* q;
  size_t q_ld;
  int q_rows;
  const bf16* kv;
  size_t kv_ld;
  int kv_rows;
  int k_off, v_off;
  int heads, kv_heads;
  int b, seq_len;
  float scale;
  const bf16* v = nullptr;
};

// The rows of image b of K and of V.
__host__ __device__ inline const bf16* attn_k_rows(const AttnGeom& g, int b) {
  return g.kv + static_cast<size_t>(b) * g.kv_rows * g.kv_ld;
}
__host__ __device__ inline const bf16* attn_v_rows(const AttnGeom& g, int b) {
  return (g.v ? g.v : g.kv) + static_cast<size_t>(b) * g.kv_rows * g.kv_ld;
}

// The square core over a packed qkv [b·spq, (H + 2·Hkv)·HD]: [q | k | v],
// MHA at kv_heads == heads (3·H·HD wide), GQA below.
inline AttnGeom attn_geom_packed(const bf16* qkv, int b, int spq, int seq_len, int heads,
                                 int kv_heads, int head_dim, float scale) {
  const int hhd = heads * head_dim;
  const int kvw = kv_heads * head_dim;
  const size_t width = static_cast<size_t>(hhd + 2 * kvw);
  return AttnGeom{qkv, width, spq, qkv, width, spq, hhd, hhd + kvw,
                  heads, kv_heads, b, seq_len, scale};
}

template <int HD, typename OutT>
__global__ void attention_core_kernel(AttnGeom g, OutT* __restrict__ out) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = attn_rows_padded(g.kv_rows);
  const int sw = L > HD ? L : HD;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int grp = h * g.kv_heads / g.heads;
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hhd = g.heads * HD;
  const bf16* qbase = g.q + static_cast<size_t>(b) * g.q_rows * g.q_ld;

  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + L * HD;
  unsigned char* mine = smem + 2 * static_cast<size_t>(L) * HD * 2 +
                        warp * static_cast<size_t>(16 * HD * 2 + 16 * sw * 4 + 16 * L * 2);
  bf16* Qs = reinterpret_cast<bf16*>(mine);
  float* S = reinterpret_cast<float*>(mine + 16 * HD * 2);
  bf16* P = reinterpret_cast<bf16*>(mine + 16 * HD * 2 + 16 * static_cast<size_t>(sw) * 4);

  attn_stage_kv<HD>(attn_k_rows(g, b), attn_v_rows(g, b), g.kv_ld, g.k_off + grp * HD,
                    g.v_off + grp * HD, g.kv_rows, L, Ks, Vs);
  const int q0 = (blockIdx.x * warps + warp) * 16;
  attn_load_tile16<HD>(qbase, g.q_ld, h * HD, q0, g.q_rows, Qs);
  __syncthreads();
  if (q0 >= g.q_rows) return;  // no block-wide barrier follows

  attn_scores<HD>(Qs, Ks, L, S, sw);
  for (int r = 0; r < 16; ++r) {
    attn_softmax_row(S + r * sw, L, g.seq_len, g.scale);
    for (int c = lane; c < L; c += 32) P[r * L + c] = __float2bfloat16(S[r * sw + c]);
  }
  __syncwarp();

  // o = P V, staged through S (free now) as fp32 [16, HD]
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < L / 16; ++k) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
      wmma::load_matrix_sync(pa, P + k * 16, L);
      wmma::load_matrix_sync(vb, Vs + k * 16 * HD + n * 16, HD);
      wmma::mma_sync(acc, pa, vb, acc);
    }
    wmma::store_matrix_sync(S + n * 16, acc, HD, wmma::mem_row_major);
  }
  __syncwarp();

  constexpr int kVecs = HD / 8;
  for (int i = lane; i < 16 * kVecs; i += 32) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    if (q0 + r >= g.q_rows) continue;
    OutT* dst = out + (static_cast<size_t>(b) * g.q_rows + q0 + r) * hhd + h * HD + c;
    store4(dst, S + r * HD + c);
    store4(dst + 4, S + r * HD + c + 4);
  }
}

// Query tiles (warps) per block: as many as fit in shared memory, up to 4.
template <typename SmemFn>
inline int attn_pick_warps(int q_rows, SmemFn smem_bytes) {
  int w = 4;
  while (w > 1 && smem_bytes(w) > kSmemLimit) w /= 2;
  const int tiles = (q_rows + 15) / 16;
  while (w > 1 && w / 2 >= tiles) w /= 2;
  return w;
}

template <int HD, typename OutT>
cudaError_t launch_attention_core(const AttnGeom& g, OutT* out, cudaStream_t stream) {
  if (g.b == 0 || g.q_rows == 0) return cudaSuccess;
  if (g.kv_heads <= 0 || g.heads % g.kv_heads) return cudaErrorInvalidValue;
  const int warps =
      attn_pick_warps(g.q_rows, [&](int w) { return attn_smem_bytes(g.kv_rows, HD, w); });
  const size_t smem = attn_smem_bytes(g.kv_rows, HD, warps);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attention_core_kernel<HD, OutT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int tiles = (g.q_rows + 15) / 16;
  const dim3 grid((tiles + warps - 1) / warps, g.heads, g.b);
  attention_core_kernel<HD, OutT><<<grid, 32 * warps, smem, stream>>>(g, out);
  const cudaError_t launched = cudaGetLastError();
  if (launched == cudaSuccess) ++first_design_launches[1];
  return launched;
}

// The core for head_dim 32, 64 or 128 at geometry g; out is bf16 or fp32
// [b·q_rows, heads·hd].
template <typename OutT>
cudaError_t launch_attention_core_geom(const AttnGeom& g, int head_dim, OutT* out,
                                       cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch_attention_core<32>(g, out, stream);
    case 64:
      return launch_attention_core<64>(g, out, stream);
    case 128:
      return launch_attention_core<128>(g, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace vitax
