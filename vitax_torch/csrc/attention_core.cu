// K13, the standalone attention core, forward: replaces _attn_fwd_kernel
// (vitax/ops/pallas_kernels.py:83), the body of _attn_fwd (:168, pallas_call
// at :172), which flash_attention_bhsd (:228) and flash_attention (:248)
// reach from multi_head_attention{,_bhsd} (vitax/ops/attention.py:50-84)
// wherever a fused attention half is off (--no-fused-qkv: ViT's unfused
// _attention, Res-ViT's attention).
//
//   per (image, head): out = bf16(softmax(q kᵀ · scale) v), the softmax in
//   fp32 over the seq_len keys
//
// At vitax's rounding points, in two passes over 64-key tiles (the pieces of
// K6's core, attention_flash.cuh): the first takes the row statistics (m, l)
// by the online recurrence, the second p = exp(s − m)·(1/l), normalised in
// fp32 as _softmax_rows (:75-80), rounds it to bf16 once and sums P·V in
// fp32, cast once at the end. (A one-pass core that rounds the unnormalised
// p of each tile, as K6 does, is the same function within a bf16 band, but
// it does not round where the plain path does: at ViT-B/16 b32 its model
// grads moved 6.0e-2 from the plain path's, past the 5e-2 band that paths
// rounding alike hold. The second pass costs one more q·kᵀ.)
//
// Layout: q, k, v and out are [images, seq, heads, head_dim] in memory, one
// layout for all four. vitax's [B, S, H, Hd] (Res-ViT) is images = B; its
// kernel-native [B, H, S, Hd] (ViT) is images = B·H, heads = 1, whose rows of
// one (image, head) are contiguous: neither takes a transposing copy. The
// rows are exactly seq, not padded: the last 16-row query tile and the last
// 64-key tile of the last image read zeros past the tensor's end (the loads
// are guarded) and store nothing there. head_dim is a multiple of 16 up to
// 128; the wrapper zero-pads a head_dim ≡ 8 (mod 16) to the next 16 (zero
// columns add nothing to q·kᵀ, and scale stays 1/√ of the real head_dim).
//
// Bound on the H100: the bytes. An (image, head) moves 4·seq·head_dim·2
// bytes (q, k, v in, out) for 4·seq²·head_dim tensor-core operations, ~98
// operations a byte at ViT's seq 197 and head_dim 64, below the bf16 ridge
// of 295. This first version is far from either term: its time is the WMMA
// products on 16-row tiles (three with the statistics pass) and the
// softmax's exp. Shared memory holds one key tile of K and V and each
// warp's [16, 64] scores whatever seq is, so one kernel serves every seq up
// to vitax's gate (1024).
#include "attention_flash.cuh"

namespace {

using vitax::AttnGeom;
using vitax::bf16;
using vitax::FlashLayout;
using vitax::FlashWarp;
using vitax::kFlashKv;
using vitax::kFlashWarps;

// One block per (query tiles, head, image), a warp a 16-row query tile.
template <int HD>
__global__ void __launch_bounds__(32 * kFlashWarps) core_fwd_kernel(AttnGeom g, bf16* out) {
  using Lay = FlashLayout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int grp = h * g.kv_heads / g.heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hhd = g.heads * HD;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kFlashKv * HD;
  const FlashWarp<HD> w(smem + Lay::kKv + warp * Lay::kFwdWarp);
  const int q0 = (blockIdx.x * kFlashWarps + warp) * 16;
  const bool active = q0 < g.q_rows;
  vitax::attn_load_tile16<HD>(g.q + static_cast<size_t>(b) * g.q_rows * g.q_ld, g.q_ld, h * HD,
                              q0, g.q_rows, w.Qs);
  vitax::flash_stats_rows<HD>(g, b, grp, Ks, Vs, w, active);
  if (lane < 16) w.alpha[lane] = 1.0f / w.l[lane];  // 1/l, as _softmax_rows
  for (int i = lane; i < 16 * HD; i += 32) w.O[i] = 0.f;
  __syncwarp();
  const int kv_end = g.seq_len < g.kv_rows ? g.seq_len : g.kv_rows;
  const bf16* kbase = vitax::attn_k_rows(g, b);
  const bf16* vbase = vitax::attn_v_rows(g, b);
  for (int k0 = 0; k0 < kv_end; k0 += kFlashKv) {
    __syncthreads();  // the previous tile has been consumed
    const size_t off = static_cast<size_t>(k0) * g.kv_ld;
    vitax::attn_stage_kv<HD>(kbase + off, vbase + off, g.kv_ld, g.k_off + grp * HD,
                             g.v_off + grp * HD, g.kv_rows - k0, kFlashKv, Ks, Vs);
    __syncthreads();
    if (!active) continue;
    vitax::attn_scores<HD>(w.Qs, Ks, kFlashKv, w.S, Lay::kSw);
    // p = exp(s·scale − m)·(1/l), 0 on the keys past seq_len, rounded once
    for (int i = lane; i < 16 * kFlashKv; i += 32) {
      const int r = i / kFlashKv;
      const int c = i % kFlashKv;
      const float p =
          k0 + c < g.seq_len ? expf(w.S[r * Lay::kSw + c] * g.scale - w.m[r]) * w.alpha[r] : 0.f;
      w.P[i] = __float2bfloat16(p);
    }
    __syncwarp();
    vitax::flash_tile_times_kv<HD>(w.P, Vs, w.S);  // P·V into S, row stride HD
    for (int i = lane; i < 16 * HD; i += 32) w.O[i] += w.S[i];
    __syncwarp();
  }
  if (!active) return;
  constexpr int kVecs = HD / 8;
  for (int i = lane; i < 16 * kVecs; i += 32) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    if (q0 + r >= g.q_rows) continue;
    bf16* dst = out + (static_cast<size_t>(b) * g.q_rows + q0 + r) * hhd + h * HD + c;
    vitax::store4(dst, w.O + r * HD + c);
    vitax::store4(dst + 4, w.O + r * HD + c + 4);
  }
}

template <int HD>
cudaError_t launch_core_fwd(const AttnGeom& g, bf16* out, cudaStream_t stream) {
  if (g.b == 0 || g.q_rows == 0) return cudaSuccess;
  constexpr size_t smem = FlashLayout<HD>::kFwdSmem;
  cudaError_t e = cudaFuncSetAttribute(core_fwd_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int tiles = (g.q_rows + 15) / 16;
  const dim3 grid((tiles + kFlashWarps - 1) / kFlashWarps, g.heads, g.b);
  core_fwd_kernel<HD><<<grid, 32 * kFlashWarps, smem, stream>>>(g, out);
  return cudaGetLastError();
}

// The head dims of the K13 instances: every multiple of 16 up to 128
#define VITAX_CORE_HEAD_DIMS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

cudaError_t core_fwd(const AttnGeom& g, int head_dim, bf16* out, cudaStream_t st) {
  switch (head_dim) {
#define VITAX_CASE(HD) \
  case HD:             \
    return launch_core_fwd<HD>(g, out, st);
    VITAX_CORE_HEAD_DIMS(VITAX_CASE)
#undef VITAX_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out bf16 [images, seq, heads, head_dim]. The grid's z dimension
// takes at most 65535 images, so larger batches run in chunks of images.
extern "C" int vitax_attention_core_fwd(const void* q, const void* k, const void* v, void* out,
                                        int images, int seq, int heads, int head_dim, float scale,
                                        void* stream) {
  constexpr int kMaxImages = 65535;
  const auto st = static_cast<cudaStream_t>(stream);
  if (seq <= 0 || heads <= 0) return cudaErrorInvalidValue;
  const size_t ld = static_cast<size_t>(heads) * head_dim;
  for (int i0 = 0; i0 < images; i0 += kMaxImages) {
    const int n = images - i0 < kMaxImages ? images - i0 : kMaxImages;
    const size_t off = static_cast<size_t>(i0) * seq * ld;
    const AttnGeom g{static_cast<const bf16*>(q) + off,
                     ld,
                     seq,
                     static_cast<const bf16*>(k) + off,
                     ld,
                     seq,
                     0,
                     0,
                     heads,
                     heads,
                     n,
                     seq,
                     scale,
                     static_cast<const bf16*>(v) + off};
    const cudaError_t e = core_fwd(g, head_dim, static_cast<bf16*>(out) + off, st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}
