// K13 backward, the standalone attention core: replaces _attn_bwd_kernel
// (vitax/ops/pallas_kernels.py:112), the body of _attn_bwd (:189,
// pallas_call at :194), the custom VJP of flash_attention{,_bhsd} (:215-225),
// which saves (q, k, v, out).
//
//   per (image, head): p = softmax(q kᵀ · scale) (fp32), dd = Σ fp32(dO) ·
//   fp32(out) over the head dim, ds = bf16(p (dO vᵀ − dd)),
//   dq = bf16((ds k) · scale), dk = bf16((dsᵀ q) · scale),
//   dv = bf16(bf16(p)ᵀ dO)
//
// Two passes, K6's core backward (attention_flash.cuh, attention_bwd.cuh):
// the query-tile pass recomputes (m, l) by the forward's statistics pass over
// 64-key tiles, takes dd from the saved bf16 out as vitax does, writes the
// bf16 P and ds rows of each (image, head) to device memory (p and ds,
// [images, heads, L, L] with L = seq rounded up to 16: 33 MB each at ViT's
// b32 seq 197, 12 heads) and dq; the key-tile pass then sums dk and dv over
// the query tiles in fp32 fragments, one owner a row, no atomics: two runs
// give the same bits. Layouts and the unpadded rows as the forward's
// (attention_core.cu); dk and dv land in their own tensors.
//
// Bound on the H100: the function needs 10·seq²·head_dim operations an
// (image, head) on the tensor cores (q·kᵀ recomputed, dO·vᵀ, ds·k, dsᵀ·q,
// pᵀ·dO) against the bytes of q, k, v, out, dO in and dq, dk, dv out; at
// seq 197 the bytes term is the larger. This version does 12: the
// statistics pass runs q·kᵀ once more before the key tiles are walked
// again. The P and ds rows go through device memory, which the TPU kernel
// keeps in VMEM.
#include "attention_flash.cuh"

namespace {

using vitax::AttnBwdGeom;
using vitax::AttnGeom;
using vitax::bf16;

#define VITAX_CORE_HEAD_DIMS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

cudaError_t core_bwd(const AttnBwdGeom& g, int head_dim, cudaStream_t st) {
  switch (head_dim) {
#define VITAX_CASE(HD) \
  case HD:             \
    return vitax::launch_flash_bwd<HD>(g, nullptr, st);
    VITAX_CORE_HEAD_DIMS(VITAX_CASE)
#undef VITAX_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out, dout and the grads dq, dk, dv bf16 [images, seq, heads,
// head_dim]; scratch p and ds bf16 [images, heads, L, L], L = round_up(seq,
// 16). Chunks of at most 65535 images, as the forward.
extern "C" int vitax_attention_core_bwd(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, void* dq, void* dk,
                                        void* dv, void* p, void* ds, int images, int seq,
                                        int heads, int head_dim, float scale, void* stream) {
  constexpr int kMaxImages = 65535;
  const auto st = static_cast<cudaStream_t>(stream);
  if (seq <= 0 || heads <= 0) return cudaErrorInvalidValue;
  const size_t ld = static_cast<size_t>(heads) * head_dim;
  const size_t L = vitax::attn_rows_padded(seq);
  for (int i0 = 0; i0 < images; i0 += kMaxImages) {
    const int n = images - i0 < kMaxImages ? images - i0 : kMaxImages;
    const size_t off = static_cast<size_t>(i0) * seq * ld;
    const size_t poff = static_cast<size_t>(i0) * heads * L * L;
    const AttnGeom f{static_cast<const bf16*>(q) + off,
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
    const AttnBwdGeom g{f,
                        static_cast<const bf16*>(out) + off,
                        static_cast<const bf16*>(dout) + off,
                        static_cast<bf16*>(dq) + off,
                        ld,
                        static_cast<bf16*>(dk) + off,
                        ld,
                        0,
                        0,
                        static_cast<bf16*>(p) + poff,
                        static_cast<bf16*>(ds) + poff,
                        static_cast<bf16*>(dv) + off};
    const cudaError_t e = core_bwd(g, head_dim, st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}
