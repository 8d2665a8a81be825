// The KV-chunked attention core of K6 (vitax's _flash_head_fwd,
// pallas_kernels.py:3391-3416, and the core grads of
// _ln_qkvo_bwd_flash_kernel :3466-3513): an online softmax over tiles of
// kFlashKv keys, so shared memory does not grow with the sequence. Design
// notes: ln_qkvo_attention_flash.cu and ln_qkvo_attention_flash_bwd.cu.
//
// Per head, at vitax's rounding points (only the key tiles differ from the
// TPU's KV chunks, so m_new, and with it the bf16 rounding of p, moves by
// tile; the result is the same function within a bf16 band):
//   s = (q kᵀ) · scale, key columns >= seq_len set to -1e30
//   m_new = max(m, rowmax s), α = exp(m − m_new), p = exp(s − m_new)
//   l = l α + Σ p (fp32), acc = acc α + bf16(p) v (fp32), m = m_new
//   out = acc / l                                   (m starts at -1e30, l at 0)
// Backward, with (m, l) and out recomputed by the same recurrence:
//   dd = Σ fp32(dO) · out (out in fp32), p = exp(s − m) / l,
//   ds = bf16(p (dO vᵀ − dd)), dq = bf16(Σ_tiles (ds k) · scale);
//   dk = bf16((dsᵀ q) · scale), dv = bf16(bf16(p)ᵀ dO) by the key-tile pass
//   of attention_bwd.cuh over the bf16 P and ds rows this pass writes.
//
// One block per (group of kFlashWarps 16-row query tiles, head, image); each
// warp owns a query tile. The block stages one key tile of K and V at a time
// in shared memory (zero past the rows), and each warp keeps its tile's
// scores, p, running (m, l) and fp32 accumulator in its own slice; scores,
// P·V, dO·Vᵀ and ds·K run on the tensor cores (WMMA bf16, fp32 accumulate).
// Key tiles wholly past seq_len are skipped in the recurrence: their p is
// exactly 0 and α exactly 1, so skipping them changes no bit.
#pragma once

#include "attention_bwd.cuh"

namespace vitax {

constexpr int kFlashKv = 64;    // keys a tile
constexpr int kFlashWarps = 4;  // query tiles (warps) a block

// Shared memory: K and V tiles [kFlashKv, HD] bf16, then one slice a warp.
// Forward slice: Qs bf16 [16, HD] | S fp32 [16, kSw] | P bf16 [16, kFlashKv]
// | O fp32 [16, HD] | m, l, α, dd fp32 [16] each. The backward slice adds
// dOs bf16 [16, HD] and DP fp32 [16, kFlashKv]. Every offset is a multiple
// of 32 bytes, as WMMA's loads and stores need.
template <int HD>
struct FlashLayout {
  static constexpr int kSw = kFlashKv > HD ? kFlashKv : HD;
  static constexpr size_t kKv = 2 * kFlashKv * HD * 2;
  static constexpr size_t kS = 16 * HD * 2;
  static constexpr size_t kP = kS + 16 * kSw * 4;
  static constexpr size_t kO = kP + 16 * kFlashKv * 2;
  static constexpr size_t kVec = kO + 16 * HD * 4;
  static constexpr size_t kFwdWarp = kVec + 4 * 16 * 4;
  static constexpr size_t kDOs = kFwdWarp;
  static constexpr size_t kDP = kDOs + 16 * HD * 2;
  static constexpr size_t kBwdWarp = kDP + 16 * kFlashKv * 4;
  static constexpr size_t kFwdSmem = kKv + kFlashWarps * kFwdWarp;
  static constexpr size_t kBwdSmem = kKv + kFlashWarps * kBwdWarp;
};

// A warp's view of its slice.
template <int HD>
struct FlashWarp {
  bf16* Qs;
  float* S;
  bf16* P;
  float* O;
  float *m, *l, *alpha, *dd;
  bf16* dOs;
  float* DP;
  __device__ FlashWarp(unsigned char* slice) {
    using Lay = FlashLayout<HD>;
    Qs = reinterpret_cast<bf16*>(slice);
    S = reinterpret_cast<float*>(slice + Lay::kS);
    P = reinterpret_cast<bf16*>(slice + Lay::kP);
    O = reinterpret_cast<float*>(slice + Lay::kO);
    m = reinterpret_cast<float*>(slice + Lay::kVec);
    l = m + 16;
    alpha = l + 16;
    dd = alpha + 16;
    dOs = reinterpret_cast<bf16*>(slice + Lay::kDOs);
    DP = reinterpret_cast<float*>(slice + Lay::kDP);
  }
};

// One key tile of the recurrence for a warp's 16 rows: S holds q·kᵀ of keys
// [k0, k0 + kFlashKv) (row stride kSw). Writes bf16(p) to P and α per row,
// and updates m and l.
__device__ __forceinline__ void flash_softmax_tile(const float* S, int sw, bf16* P, float* m,
                                                   float* l, float* alpha, int k0, int seq_len,
                                                   float scale) {
  constexpr int kPer = kFlashKv / 32;
  const int lane = threadIdx.x % 32;
  for (int r = 0; r < 16; ++r) {
    const float m_old = m[r];
    float v[kPer];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = lane + 32 * j;
      v[j] = k0 + c < seq_len ? S[r * sw + c] * scale : -1e30f;
      mx = fmaxf(mx, v[j]);
    }
    const float m_new = fmaxf(m_old, warp_max(mx));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float p = expf(v[j] - m_new);
      P[r * kFlashKv + lane + 32 * j] = __float2bfloat16(p);
      sum += p;
    }
    sum = warp_sum(sum);  // every lane has read m[r] before this shuffle
    if (lane == 0) {
      const float a = expf(m_old - m_new);
      alpha[r] = a;
      l[r] = l[r] * a + sum;
      m[r] = m_new;
    }
  }
  __syncwarp();
}

// dst [16, HD] fp32 (row stride HD) = A [16, kFlashKv] bf16 @ B [kFlashKv, HD]
// bf16, both row-major: P·V, and ds·K in the backward.
template <int HD>
__device__ __forceinline__ void flash_tile_times_kv(const bf16* A, const bf16* B, float* dst) {
  using namespace nvcuda;
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int k = 0; k < kFlashKv / 16; ++k) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, A + k * 16, kFlashKv);
      wmma::load_matrix_sync(b, B + k * 16 * HD + n * 16, HD);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(dst + n * 16, acc, HD, wmma::mem_row_major);
  }
  __syncwarp();
}

// The recurrence over the key tiles below seq_len for the block's query
// tiles: on return each active warp's O holds out = acc / l (fp32) and m, l
// the row statistics. Every warp of the block must call it (it stages the
// key tiles together); `active` is false for a warp past the query rows.
template <int HD>
__device__ void flash_forward_rows(const AttnGeom& g, int b, int grp, bf16* Ks, bf16* Vs,
                                   const FlashWarp<HD>& w, bool active) {
  constexpr int kSw = FlashLayout<HD>::kSw;
  const int lane = threadIdx.x % 32;
  for (int i = lane; i < 16 * HD; i += 32) w.O[i] = 0.f;
  if (lane < 16) {
    w.m[lane] = -1e30f;
    w.l[lane] = 0.f;
  }
  __syncwarp();
  const int kv_end = g.seq_len < g.kv_rows ? g.seq_len : g.kv_rows;
  const bf16* kbase = attn_k_rows(g, b);
  const bf16* vbase = attn_v_rows(g, b);
  for (int k0 = 0; k0 < kv_end; k0 += kFlashKv) {
    __syncthreads();  // the previous tile has been consumed
    const size_t off = static_cast<size_t>(k0) * g.kv_ld;
    attn_stage_kv<HD>(kbase + off, vbase + off, g.kv_ld, g.k_off + grp * HD, g.v_off + grp * HD,
                      g.kv_rows - k0, kFlashKv, Ks, Vs);
    __syncthreads();
    if (!active) continue;
    attn_scores<HD>(w.Qs, Ks, kFlashKv, w.S, kSw);
    flash_softmax_tile(w.S, kSw, w.P, w.m, w.l, w.alpha, k0, g.seq_len, g.scale);
    flash_tile_times_kv<HD>(w.P, Vs, w.S);  // P·V into S, row stride HD
    for (int i = lane; i < 16 * HD; i += 32) w.O[i] = w.O[i] * w.alpha[i / HD] + w.S[i];
    __syncwarp();
  }
  if (!active) return;
  for (int i = lane; i < 16 * HD; i += 32) w.O[i] = w.O[i] / w.l[i / HD];
  __syncwarp();
}

// The row statistics alone: the recurrence's (m, l) over the key tiles below
// seq_len, without P·V (K13's first pass, and its backward's recompute).
// Every warp of the block must call it, as flash_forward_rows.
template <int HD>
__device__ void flash_stats_rows(const AttnGeom& g, int b, int grp, bf16* Ks, bf16* Vs,
                                 const FlashWarp<HD>& w, bool active) {
  constexpr int kSw = FlashLayout<HD>::kSw;
  const int lane = threadIdx.x % 32;
  if (lane < 16) {
    w.m[lane] = -1e30f;
    w.l[lane] = 0.f;
  }
  __syncwarp();
  const int kv_end = g.seq_len < g.kv_rows ? g.seq_len : g.kv_rows;
  const bf16* kbase = attn_k_rows(g, b);
  const bf16* vbase = attn_v_rows(g, b);
  for (int k0 = 0; k0 < kv_end; k0 += kFlashKv) {
    __syncthreads();  // the previous tile has been consumed
    const size_t off = static_cast<size_t>(k0) * g.kv_ld;
    attn_stage_kv<HD>(kbase + off, vbase + off, g.kv_ld, g.k_off + grp * HD, g.v_off + grp * HD,
                      g.kv_rows - k0, kFlashKv, Ks, Vs);
    __syncthreads();
    if (!active) continue;
    attn_scores<HD>(w.Qs, Ks, kFlashKv, w.S, kSw);
    flash_softmax_tile(w.S, kSw, w.P, w.m, w.l, w.alpha, k0, g.seq_len, g.scale);
  }
}

// Forward, one block per (query tiles, head, image): out [b·q_rows, H·HD]
// = bf16(out) of each head.
template <int HD>
__global__ void __launch_bounds__(32 * kFlashWarps) flash_fwd_kernel(AttnGeom g, bf16* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int grp = h * g.kv_heads / g.heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hhd = g.heads * HD;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kFlashKv * HD;
  const FlashWarp<HD> w(smem + FlashLayout<HD>::kKv + warp * FlashLayout<HD>::kFwdWarp);
  const int q0 = (blockIdx.x * kFlashWarps + warp) * 16;
  attn_load_tile16<HD>(g.q + static_cast<size_t>(b) * g.q_rows * g.q_ld, g.q_ld, h * HD, q0,
                       g.q_rows, w.Qs);
  flash_forward_rows<HD>(g, b, grp, Ks, Vs, w, q0 < g.q_rows);
  if (q0 >= g.q_rows) return;
  constexpr int kVecs = HD / 8;
  for (int i = lane; i < 16 * kVecs; i += 32) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    if (q0 + r >= g.q_rows) continue;
    bf16* dst = out + (static_cast<size_t>(b) * g.q_rows + q0 + r) * hhd + h * HD + c;
    store4(dst, w.O + r * HD + c);
    store4(dst + 4, w.O + r * HD + c + 4);
  }
}

// Backward, the query-tile pass, one block per (query tiles, head, image):
// recomputes out, m and l, then dd, then walks every key tile of the padded
// rows: p, dp = dO vᵀ, ds; the bf16 P and ds rows of the tile go to g.P and
// g.DS ([b, H, Lq, L], zero on pad query rows and on masked keys) for the
// key-tile pass, and dq = Σ ds k accumulates in WMMA fragments, scaled and
// cast once. With attn set (K6) it writes bf16(out) there, the
// out-projection's operand, and takes dd from the fp32 out; with attn null
// (K13, whose VJP saves its output) it recomputes (m, l) alone and takes dd
// from the saved bf16 outputs g.o, as vitax's _attn_bwd_kernel does
// (pallas_kernels.py:119-120, 146).
template <int HD>
__global__ void __launch_bounds__(32 * kFlashWarps)
    flash_bwd_q_kernel(AttnBwdGeom g, bf16* attn) {
  using namespace nvcuda;
  using Lay = FlashLayout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnGeom& f = g.f;
  const int Lq = attn_rows_padded(f.q_rows);
  const int L = attn_rows_padded(f.kv_rows);
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int grp = h * f.kv_heads / f.heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hhd = f.heads * HD;
  const size_t qrow0 = static_cast<size_t>(b) * f.q_rows;
  const bf16* kbase = attn_k_rows(f, b);
  const bf16* vbase = attn_v_rows(f, b);
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kFlashKv * HD;
  const FlashWarp<HD> w(smem + Lay::kKv + warp * Lay::kBwdWarp);
  const int q0 = (blockIdx.x * kFlashWarps + warp) * 16;
  const bool active = q0 < f.q_rows;
  attn_load_tile16<HD>(f.q + qrow0 * f.q_ld, f.q_ld, h * HD, q0, f.q_rows, w.Qs);
  attn_load_tile16<HD>(g.dO + qrow0 * hhd, hhd, h * HD, q0, f.q_rows, w.dOs);
  if (attn)
    flash_forward_rows<HD>(f, b, grp, Ks, Vs, w, active);
  else
    flash_stats_rows<HD>(f, b, grp, Ks, Vs, w, active);

  constexpr int kVecs = HD / 8;
  if (active) {
    for (int i = lane; attn && i < 16 * kVecs; i += 32) {
      const int r = i / kVecs;
      const int c = (i % kVecs) * 8;
      if (q0 + r >= f.q_rows) continue;
      bf16* dst = attn + (qrow0 + q0 + r) * hhd + h * HD + c;
      store4(dst, w.O + r * HD + c);
      store4(dst + 4, w.O + r * HD + c + 4);
    }
    const bf16* o_rows = g.o + qrow0 * hhd + h * HD;
    for (int r = 0; r < 16; ++r) {
      float acc = 0.f;
      if (attn) {
        for (int c = lane; c < HD; c += 32)
          acc += __bfloat162float(w.dOs[r * HD + c]) * w.O[r * HD + c];
      } else if (q0 + r < f.q_rows) {  // dOs is zero on the pad rows
        for (int c = lane; c < HD; c += 32)
          acc += __bfloat162float(w.dOs[r * HD + c]) *
                 __bfloat162float(o_rows[static_cast<size_t>(q0 + r) * hhd + c]);
      }
      acc = warp_sum(acc);
      if (lane == 0) w.dd[r] = acc;
    }
    __syncwarp();
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) wmma::fill_fragment(dq[n], 0.0f);
  const size_t tile_row0 = (static_cast<size_t>(b * f.heads + h) * Lq + q0) * L;
  for (int k0 = 0; k0 < L; k0 += kFlashKv) {
    __syncthreads();  // the previous tile has been consumed
    const size_t off = static_cast<size_t>(k0) * f.kv_ld;
    attn_stage_kv<HD>(kbase + off, vbase + off, f.kv_ld, f.k_off + grp * HD, f.v_off + grp * HD,
                      f.kv_rows - k0, kFlashKv, Ks, Vs);
    __syncthreads();
    if (!active) continue;
    attn_scores<HD>(w.Qs, Ks, kFlashKv, w.S, Lay::kSw);
    // dp = dO vᵀ, [16, kFlashKv] fp32
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> da[HD / 16];
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) wmma::load_matrix_sync(da[k], w.dOs + k * 16, HD);
#pragma unroll
    for (int j = 0; j < kFlashKv / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> vb;
        wmma::load_matrix_sync(vb, Vs + j * 16 * HD + k * 16, HD);
        wmma::mma_sync(acc, da[k], vb, acc);
      }
      wmma::store_matrix_sync(w.DP + j * 16, acc, kFlashKv, wmma::mem_row_major);
    }
    __syncwarp();
    // p = exp(s − m) / l, ds = bf16(p (dp − dd)); ds into P (free now)
    for (int i = lane; i < 16 * kFlashKv; i += 32) {
      const int r = i / kFlashKv;
      const int c = i % kFlashKv;
      const int col = k0 + c;
      const float s = col < f.seq_len ? w.S[r * Lay::kSw + c] * f.scale : -1e30f;
      const float p = expf(s - w.m[r]) / w.l[r];
      const bf16 dsb = __float2bfloat16(p * (w.DP[i] - w.dd[r]));
      w.P[i] = dsb;
      if (col < L) {
        const bool real = q0 + r < f.q_rows;
        const size_t off = tile_row0 + static_cast<size_t>(r) * L + col;
        g.P[off] = __float2bfloat16(real ? p : 0.f);
        g.DS[off] = real ? dsb : __float2bfloat16(0.f);
      }
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
#pragma unroll
      for (int k = 0; k < kFlashKv / 16; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> sa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> kb;
        wmma::load_matrix_sync(sa, w.P + k * 16, kFlashKv);
        wmma::load_matrix_sync(kb, Ks + k * 16 * HD + n * 16, HD);
        wmma::mma_sync(dq[n], sa, kb, dq[n]);
      }
    }
    __syncwarp();
  }
  if (!active) return;
#pragma unroll
  for (int n = 0; n < HD / 16; ++n)
    wmma::store_matrix_sync(w.S + n * 16, dq[n], HD, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * kVecs; i += 32) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    if (q0 + r >= f.q_rows) continue;
    uint4 o_u;
    bf16* o = reinterpret_cast<bf16*>(&o_u);
#pragma unroll
    for (int t = 0; t < 8; ++t) o[t] = __float2bfloat16(w.S[r * HD + c + t] * f.scale);
    *reinterpret_cast<uint4*>(g.dq + (qrow0 + q0 + r) * g.dq_ld + h * HD + c) = o_u;
  }
}

template <int HD>
cudaError_t launch_flash_fwd(const AttnGeom& g, bf16* out, cudaStream_t stream) {
  if (g.b == 0 || g.q_rows == 0) return cudaSuccess;
  if (g.kv_heads <= 0 || g.heads % g.kv_heads || g.seq_len <= 0) return cudaErrorInvalidValue;
  constexpr size_t smem = FlashLayout<HD>::kFwdSmem;
  static_assert(smem <= kSmemLimit, "flash forward shared memory");
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int tiles = (g.q_rows + 15) / 16;
  const dim3 grid((tiles + kFlashWarps - 1) / kFlashWarps, g.heads, g.b);
  flash_fwd_kernel<HD><<<grid, 32 * kFlashWarps, smem, stream>>>(g, out);
  return cudaGetLastError();
}

// Both passes of the core backward: this query-tile pass, then the key-tile
// pass of attention_bwd.cuh; attn as flash_bwd_q_kernel's (null for K13).
template <int HD>
cudaError_t launch_flash_bwd(const AttnBwdGeom& g, bf16* attn, cudaStream_t stream) {
  const AttnGeom& f = g.f;
  if (f.b == 0 || f.q_rows == 0) return cudaSuccess;
  if (f.kv_heads <= 0 || f.heads % f.kv_heads || f.seq_len <= 0) return cudaErrorInvalidValue;
  constexpr size_t smem = FlashLayout<HD>::kBwdSmem;
  static_assert(smem <= kSmemLimit, "flash backward shared memory");
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_q_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int tiles = (f.q_rows + 15) / 16;
  flash_bwd_q_kernel<HD><<<dim3((tiles + kFlashWarps - 1) / kFlashWarps, f.heads, f.b),
                           32 * kFlashWarps, smem, stream>>>(g, attn);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_attention_bwd_kv<HD>(g, stream);
}

#define VITAX_FLASH_HEAD_DIMS(X) X(32) X(64) X(80) X(128)

// The forward core for head_dim 32, 64, 80 or 128 at geometry g.
inline cudaError_t launch_flash_fwd_hd(const AttnGeom& g, int head_dim, bf16* out,
                                       cudaStream_t stream) {
  switch (head_dim) {
#define VITAX_CASE(HD) \
  case HD:             \
    return launch_flash_fwd<HD>(g, out, stream);
    VITAX_FLASH_HEAD_DIMS(VITAX_CASE)
#undef VITAX_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// The core backward for head_dim 32, 64, 80 or 128 at geometry g; attn
// receives the recomputed bf16 head outputs [b·q_rows, H·HD].
inline cudaError_t launch_flash_bwd_hd(const AttnBwdGeom& g, int head_dim, bf16* attn,
                                       cudaStream_t stream) {
  switch (head_dim) {
#define VITAX_CASE(HD) \
  case HD:             \
    return launch_flash_bwd<HD>(g, attn, stream);
    VITAX_FLASH_HEAD_DIMS(VITAX_CASE)
#undef VITAX_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace vitax
