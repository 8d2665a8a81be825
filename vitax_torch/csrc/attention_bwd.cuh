// The whole-row attention-core backward of the first design (K7's bf16
// backward: vitax's _attn_core_grads, pallas_kernels.py:2846-2895), in two
// passes, query tiles then key tiles. Design notes:
// ln_qkvo_attention_bwd.cu.
//
// It takes the forward core's geometry (AttnGeom, attention.cuh) and where
// the grads go (AttnBwdGeom): the square core on packed rows, MHA or GQA
// (query head h reads kv group h·Hkv/H, and dK, dV of a group sum over its
// H/Hkv query heads). The geometry also spans the rect core (q_rows query
// rows per image against kv_rows key rows; dq on the query row set, dK and
// dV on the key row set), which no backward runs since K8's tiers and R-B
// took K13's passes. P and ds are staged in device memory as [b, heads, Lq,
// Lk] bf16, Lq and Lk the two row counts rounded up to 16.
#pragma once

#include "attention.cuh"

namespace vitax {

// Where the backward reads and writes, beside the forward's geometry f: the
// bf16 head outputs o and their cotangent dO, both [b·q_rows, H·HD]; dq of
// head h at column h·HD of row b·q_rows + r of dq (row stride dq_ld); dK and
// dV of kv group g at columns dk_off + g·HD and dv_off + g·HD of row
// b·kv_rows + r of dkv (row stride dkv_ld), dV in its own tensor dv where
// that is set (K13); P and DS [b, heads, Lq, Lk].
struct AttnBwdGeom {
  AttnGeom f;
  const bf16* o;
  const bf16* dO;
  bf16* dq;
  size_t dq_ld;
  bf16* dkv;
  size_t dkv_ld;
  int dk_off, dv_off;
  bf16* P;
  bf16* DS;
  bf16* dv = nullptr;
};

__host__ __device__ inline size_t attn_bwd_warp_bytes(int kv_rows, int hd) {
  const size_t L = attn_rows_padded(kv_rows);
  const size_t sw = L > static_cast<size_t>(hd) ? L : hd;
  // Qs, dOs bf16 [16, hd]; S fp32 [16, sw]; Ds bf16 [16, L]; stage fp32
  // [16, 16]; dd fp32 [16]
  return 2 * 16 * hd * 2 + 16 * sw * 4 + 16 * L * 2 + 16 * 16 * 4 + 16 * 4;
}

__host__ __device__ inline size_t attn_bwd_smem_bytes(int kv_rows, int hd, int warps) {
  const size_t L = attn_rows_padded(kv_rows);
  return 2 * L * hd * 2 + warps * attn_bwd_warp_bytes(kv_rows, hd);
}

// Pass 1, one block per (query tiles, head, image): P, ds and dq of a warp's
// 16 query rows.
template <int HD>
__global__ void attention_bwd_q_kernel(AttnBwdGeom g) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnGeom& f = g.f;
  const int Lq = attn_rows_padded(f.q_rows);
  const int L = attn_rows_padded(f.kv_rows);
  const int sw = L > HD ? L : HD;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int grp = h * f.kv_heads / f.heads;
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hhd = f.heads * HD;
  const size_t qrow0 = static_cast<size_t>(b) * f.q_rows;
  const bf16* qbase = f.q + qrow0 * f.q_ld;

  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + L * HD;
  unsigned char* mine = smem + 2 * static_cast<size_t>(L) * HD * 2 +
                        warp * attn_bwd_warp_bytes(f.kv_rows, HD);
  bf16* Qs = reinterpret_cast<bf16*>(mine);
  bf16* dOs = Qs + 16 * HD;
  float* S = reinterpret_cast<float*>(dOs + 16 * HD);
  bf16* Ds = reinterpret_cast<bf16*>(S + 16 * sw);
  float* stage = reinterpret_cast<float*>(Ds + 16 * L);
  float* dd = stage + 256;

  attn_stage_kv<HD>(attn_k_rows(f, b), attn_v_rows(f, b), f.kv_ld, f.k_off + grp * HD,
                    f.v_off + grp * HD, f.kv_rows, L, Ks, Vs);
  const int q0 = (blockIdx.x * warps + warp) * 16;
  attn_load_tile16<HD>(qbase, f.q_ld, h * HD, q0, f.q_rows, Qs);
  attn_load_tile16<HD>(g.dO + qrow0 * hhd, hhd, h * HD, q0, f.q_rows, dOs);
  __syncthreads();
  if (q0 >= f.q_rows) return;  // no block-wide barrier follows

  // P: exact fp32 softmax rows, as the forward; dd = rowsum(fp32(dO) fp32(O))
  attn_scores<HD>(Qs, Ks, L, S, sw);
  const size_t o_off = qrow0 * hhd + h * HD;
  for (int r = 0; r < 16; ++r) {
    attn_softmax_row(S + r * sw, L, f.seq_len, f.scale);
    float acc = 0.f;
    if (q0 + r < f.q_rows) {
      const size_t row = o_off + static_cast<size_t>(q0 + r) * hhd;
      for (int c = lane; c < HD; c += 32)
        acc += __bfloat162float(dOs[r * HD + c]) * __bfloat162float(g.o[row + c]);
    }
    acc = warp_sum(acc);
    if (lane == 0) dd[r] = acc;
  }
  __syncwarp();

  // dp = dO V^T one 16x16 key tile at a time; ds = bf16(P (dp - dd))
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> da[HD / 16];
#pragma unroll
  for (int k = 0; k < HD / 16; ++k) wmma::load_matrix_sync(da[k], dOs + k * 16, HD);
  for (int j = 0; j < L / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> vb;
      wmma::load_matrix_sync(vb, Vs + j * 16 * HD + k * 16, HD);
      wmma::mma_sync(acc, da[k], vb, acc);
    }
    wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      const int r = i / 16;
      const int c = j * 16 + i % 16;
      const float ds = q0 + r < f.q_rows ? S[r * sw + c] * (stage[i] - dd[r]) : 0.f;
      Ds[r * L + c] = __float2bfloat16(ds);
    }
    __syncwarp();
  }

  // bf16 P and ds rows of this tile (pad rows zero) for the key-tile pass
  const size_t tile_off = (static_cast<size_t>(b * f.heads + h) * Lq + q0) * L;
  for (int i = lane; i < 16 * (L / 8); i += 32) {
    const int r = i / (L / 8);
    const int c = (i % (L / 8)) * 8;
    uint4 pv;
    bf16* pp = reinterpret_cast<bf16*>(&pv);
#pragma unroll
    for (int t = 0; t < 8; ++t)
      pp[t] = __float2bfloat16(q0 + r < f.q_rows ? S[r * sw + c + t] : 0.f);
    *reinterpret_cast<uint4*>(g.P + tile_off + r * L + c) = pv;
    *reinterpret_cast<uint4*>(g.DS + tile_off + r * L + c) =
        *reinterpret_cast<const uint4*>(Ds + r * L + c);
  }
  __syncwarp();

  // dq = bf16((ds K) scale), staged through S (free now) as fp32 [16, HD]
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < L / 16; ++k) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> sa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> kb;
      wmma::load_matrix_sync(sa, Ds + k * 16, L);
      wmma::load_matrix_sync(kb, Ks + k * 16 * HD + n * 16, HD);
      wmma::mma_sync(acc, sa, kb, acc);
    }
    wmma::store_matrix_sync(S + n * 16, acc, HD, wmma::mem_row_major);
  }
  __syncwarp();
  constexpr int kVecs = HD / 8;
  for (int i = lane; i < 16 * kVecs; i += 32) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    if (q0 + r >= f.q_rows) continue;
    uint4 o_u;
    bf16* o = reinterpret_cast<bf16*>(&o_u);
#pragma unroll
    for (int t = 0; t < 8; ++t) o[t] = __float2bfloat16(S[r * HD + c + t] * f.scale);
    *reinterpret_cast<uint4*>(g.dq + (qrow0 + q0 + r) * g.dq_ld + h * HD + c) = o_u;
  }
}

constexpr int kKvWarps = 4;

// Pass 2, one block per (key tiles, kv group, image): each warp owns 16 key
// rows and walks the group's query heads in order, and each head's query
// chunks, accumulating dk = ds^T Q and dv = P^T dO in fp32 WMMA fragments;
// one cast at the end (for GQA the fp32 sum over the group's heads that
// vitax takes before its cast, :2884-2894). No atomics: each dK/dV row has
// one owner.
template <int HD>
__global__ void __launch_bounds__(32 * kKvWarps) attention_bwd_kv_kernel(AttnBwdGeom g) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 Qs[16 * HD];
  __shared__ __align__(128) bf16 dOs[16 * HD];
  __shared__ __align__(128) float stage[kKvWarps][256];
  const AttnGeom& f = g.f;
  const int Lq = attn_rows_padded(f.q_rows);
  const int L = attn_rows_padded(f.kv_rows);
  const int b = blockIdx.z;
  const int grp = blockIdx.y;
  const int nrep = f.heads / f.kv_heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hhd = f.heads * HD;
  const size_t qrow0 = static_cast<size_t>(b) * f.q_rows;
  const size_t krow0 = static_cast<size_t>(b) * f.kv_rows;
  const int k0 = (blockIdx.x * kKvWarps + warp) * 16;
  const bool active = k0 < L;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk[HD / 16], dv[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
    wmma::fill_fragment(dk[n], 0.0f);
    wmma::fill_fragment(dv[n], 0.0f);
  }
  constexpr int kVecs = HD / 8;
  for (int hr = 0; hr < nrep; ++hr) {
    const int h = grp * nrep + hr;
    const bf16* Pg = g.P + static_cast<size_t>(b * f.heads + h) * Lq * L;
    const bf16* Dg = g.DS + static_cast<size_t>(b * f.heads + h) * Lq * L;
    for (int qc = 0; qc < Lq; qc += 16) {
      __syncthreads();  // the previous chunk has been consumed
      for (int i = threadIdx.x; i < 2 * 16 * kVecs; i += blockDim.x) {
        const int which = i / (16 * kVecs);
        const int r = (i % (16 * kVecs)) / kVecs;
        const int c = (i % kVecs) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (qc + r < f.q_rows) {
          const bf16* src = which == 0 ? f.q + (qrow0 + qc + r) * f.q_ld + h * HD + c
                                       : g.dO + (qrow0 + qc + r) * hhd + h * HD + c;
          v = *reinterpret_cast<const uint4*>(src);
        }
        *reinterpret_cast<uint4*>((which == 0 ? Qs : dOs) + r * HD + c) = v;
      }
      __syncthreads();
      if (active) {
        // ds^T and P^T tiles [16 keys, 16 queries], read column-major
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> dsT, pT;
        wmma::load_matrix_sync(dsT, Dg + static_cast<size_t>(qc) * L + k0, L);
        wmma::load_matrix_sync(pT, Pg + static_cast<size_t>(qc) * L + k0, L);
#pragma unroll
        for (int n = 0; n < HD / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> qb, ob;
          wmma::load_matrix_sync(qb, Qs + n * 16, HD);
          wmma::load_matrix_sync(ob, dOs + n * 16, HD);
          wmma::mma_sync(dk[n], dsT, qb, dk[n]);
          wmma::mma_sync(dv[n], pT, ob, dv[n]);
        }
      }
    }
  }
  if (!active) return;
  float* st = stage[warp];
  const int r = lane / 2;
  const int c0 = (lane % 2) * 8;
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      if (which == 0)
        wmma::store_matrix_sync(st, dk[n], 16, wmma::mem_row_major);
      else
        wmma::store_matrix_sync(st, dv[n], 16, wmma::mem_row_major);
      __syncwarp();
      if (k0 + r < f.kv_rows) {
        uint4 o_u;
        bf16* o = reinterpret_cast<bf16*>(&o_u);
#pragma unroll
        for (int t = 0; t < 8; ++t)
          o[t] = __float2bfloat16(which == 0 ? st[r * 16 + c0 + t] * f.scale
                                             : st[r * 16 + c0 + t]);
        bf16* dst = which == 0 ? g.dkv + g.dk_off : (g.dv ? g.dv : g.dkv) + g.dv_off;
        *reinterpret_cast<uint4*>(dst + (krow0 + k0 + r) * g.dkv_ld + grp * HD + n * 16 + c0) =
            o_u;
      }
      __syncwarp();
    }
  }
}

template <int HD>
cudaError_t launch_attention_bwd(const AttnBwdGeom& g, cudaStream_t stream) {
  const AttnGeom& f = g.f;
  if (f.b == 0 || f.q_rows == 0) return cudaSuccess;
  if (f.kv_heads <= 0 || f.heads % f.kv_heads) return cudaErrorInvalidValue;
  const int warps =
      attn_pick_warps(f.q_rows, [&](int w) { return attn_bwd_smem_bytes(f.kv_rows, HD, w); });
  const size_t smem = attn_bwd_smem_bytes(f.kv_rows, HD, warps);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attention_bwd_q_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int q_tiles = (f.q_rows + 15) / 16;
  attention_bwd_q_kernel<HD>
      <<<dim3((q_tiles + warps - 1) / warps, f.heads, f.b), 32 * warps, smem, stream>>>(g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int k_tiles = (f.kv_rows + 15) / 16;  // the key-tile pass over the P and DS just written
  attention_bwd_kv_kernel<HD>
      <<<dim3((k_tiles + kKvWarps - 1) / kKvWarps, f.kv_heads, f.b), 32 * kKvWarps, 0, stream>>>(
          g);
  const cudaError_t launched = cudaGetLastError();
  if (launched == cudaSuccess) ++first_design_launches[2];
  return launched;
}

// The backward core for head_dim 32, 64 or 128 at geometry g.
inline cudaError_t launch_attention_bwd_geom(const AttnBwdGeom& g, int head_dim,
                                             cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch_attention_bwd<32>(g, stream);
    case 64:
      return launch_attention_bwd<64>(g, stream);
    case 128:
      return launch_attention_bwd<128>(g, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The square core over a packed qkv [b·spq, (H + 2·Hkv)·hd] (MHA at
// kv_heads == heads, GQA below), its grads into dqkv of the same layout.
inline cudaError_t launch_attention_bwd_packed(const bf16* qkv, const bf16* attn,
                                               const bf16* dattn, bf16* P, bf16* DS, bf16* dqkv,
                                               int b, int spq, int seq_len, int heads,
                                               int kv_heads, int head_dim, float scale,
                                               cudaStream_t stream) {
  const AttnGeom f = attn_geom_packed(qkv, b, spq, seq_len, heads, kv_heads, head_dim, scale);
  const AttnBwdGeom g{f, attn, dattn, dqkv, f.q_ld, dqkv, f.q_ld, f.k_off, f.v_off, P, DS};
  return launch_attention_bwd_geom(g, head_dim, stream);
}

}  // namespace vitax
