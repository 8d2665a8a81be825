// K13, the standalone attention core, forward: replaces _attn_fwd_kernel
// (vitax/ops/pallas_kernels.py:83), the body of _attn_fwd (:168, pallas_call
// at :172), which flash_attention_bhsd (:228) and flash_attention (:248)
// reach from multi_head_attention{,_bhsd} (vitax/ops/attention.py:50-84)
// wherever a fused attention half is off (--no-fused-qkv: ViT's unfused
// _attention, Res-ViT's plain layers, ViT-H/14's half on gathered weights
// under --n-model).
//
//   per (image, head): out = bf16(softmax(q kᵀ · scale) v), the softmax in
//   fp32 over the seq keys
//
// At vitax's rounding points: s = fp32(q·kᵀ)·scale, p normalised in fp32
// (_softmax_rows :75-80: e·(1/Σe)) and rounded to bf16 once, out =
// bf16(Σ bf16(p)·v in fp32). Hence two passes over 64-key tiles
// (core_rows_kernel, attention_core.cuh): the first takes the row
// statistics (m, l) by the online recurrence, staging K only; the second
// forms p = exp2(s·scale·log2e − m)·(1/l), rounds it once and sums P·V.
// (A one-pass online softmax rounds the unnormalised p of each tile, which
// the plain path does not: at ViT-B/16 b32 such a core put the model's
// grads 6.0e-2 from the plain path's, past the 5e-2 band. The second pass
// costs one more q·kᵀ.)
//
// Layout: q, k, v and out are [images, seq, heads, head_dim] in memory.
// vitax's [B, S, H, Hd] (Res-ViT, the einsums) is images = B; its
// kernel-native [B, H, S, Hd] (ViT) is images = B·H, heads = 1: neither
// takes a copy. The rows are exactly seq: the last query and key tiles
// zero-fill past seq (cp.async with a source size of 0) and store nothing
// there; keys >= seq get p exactly 0. head_dim is a multiple of 16 up to 128
// (the wrapper zero-pads a head_dim ≡ 8 (mod 16)); seq up to vitax's gate
// (1024), though nothing here depends on it.
//
// Bound on the H100: the bytes at ViT's shapes. An (image, head) moves
// 4·seq·head_dim·2 bytes (q, k, v in, out) for 4·seq²·head_dim operations
// of the function (~98 a byte at seq 197, head_dim 64, ~290 at seq 577,
// under the bf16 ridge of 295); the two passes do 6·seq²·head_dim on the
// tensor cores and 2·seq² exp2. The design (attention_core.cuh): a block of
// two warpgroups owns two 64-row query tiles, each Q tile in shared memory
// for the whole kernel, and the two share a ring of K tiles (pass 1) and K
// and V tiles (pass 2) filled by cp.async two tiles ahead (pass 2's first
// tiles are fetched during pass 1's last); q·kᵀ as m64n64k16 wgmma from
// shared memory, P·V as wgmma with P from registers, issued after the next
// tile's q·kᵀ so that it runs under that tile's softmax; the scores, p and
// the output accumulator stay in registers (32 + head_dim/2 fp32 a thread).
// A block, by head_dim (ptxas's registers; shared memory (2 + 2·stages)
// tiles of 64·head_dim bf16, 4 stages up to 80 and 3 above; blocks an SM
// are the lower of what registers and shared memory allow):
//   head_dim        16   32   48   64   80   96  112  128
//   registers       90   98  114  106  126  128  156  162
//   shared KB       20   40   60   80  100   96  112  128
//   blocks an SM     2    2    2    2    2    2    1    1
// What holds it back on the card (PERF.md): at b64 seq 577 it takes about
// twice scaled_dot_product_attention's time, which does one pass; removing
// the exp2 or the second softmax moves it by 1–2 %, removing the copies by
// about 28 %: the waits on copies and on each step's products, with four
// warpgroups an SM to hide them, not the special-function unit.
// K1's backward recomputes its attention output with this forward
// (launch_core_fwd) on the packed qkv rows, query rows to spq.
#include "attention_core.cuh"

namespace vitax {
namespace k13 {

cudaError_t launch_core_fwd(const CoreArgs& a, int head_dim, int images, cudaStream_t st) {
  return launch_core_rows<kRowsFwd>(a, head_dim, images, st);
}

}  // namespace k13
}  // namespace vitax

using vitax::bf16;
using vitax::k13::CoreArgs;

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
    CoreArgs a{};
    a.q = static_cast<const bf16*>(q) + off;
    a.k = static_cast<const bf16*>(k) + off;
    a.v = static_cast<const bf16*>(v) + off;
    a.o = static_cast<bf16*>(out) + off;
    vitax::k13::dense_geometry(a, seq, heads, head_dim);
    a.scale = scale;
    const cudaError_t e = vitax::k13::launch_core_fwd(a, head_dim, n, st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}
