// The attention half after its LN on Hopper, kv_heads == heads: the QKV
// projection, K13's core on the packed rows and the out-projection, forward
// and backward. K1 (ln_qkvo_attention.cu, ln_qkvo_attention_bwd.cu) runs it
// after its LN launch and before its LN tail; K9 (qkvo_attention.cu,
// qkvo_attention_bwd.cu) runs it on the caller's x̂. One sequence, so K9 on
// x̂ = LN(x) gives K1's output and weight grads to the bit. K10
// (qkv_attention.cu, qkv_attention_bwd.cu: no out-projection) runs its
// first two launches (`qkv_core`) as its forward, and its backward ends in
// the same QKV projection grads (`proj_bwd`).
//
// Forward, three launches:
//   1. qkv = bf16(xn·Wqkv + bqkv) on gemm_sm90.cuh (kEpiBias: the fp32 bias
//      added to the fp32 product, one rounding);
//   2. K13's core (attention_core.cuh, launch_core_fwd) with strided
//      operands: q, k, v the column blocks 0, hhd, 2·hhd of the packed rows
//      (row stride 3·hhd), the head outputs into attn (row stride hhd),
//      query rows to spq (the pad rows computed as vitax computes them) and
//      keys masked at seq_len; p normalised in fp32 and rounded to bf16 once
//      before p·v, as vitax's _softmax_rows then .astype(v.dtype);
//   3. out = bf16(attn·Wo + bo) on gemm_sm90.cuh (kEpiBias).
// Backward: the forward's launches 1 and 2 (the recompute); the
// out-projection's grads (dattn = bf16(dY·Woᵀ), dWo = attnᵀ·dY in fp32 on
// the split-K kTN product, dbo a two-pass column sum); K13's three passes
// (a row pass writing m·scale·log2e, 1/l and dd from the bf16 head output,
// 12 bytes a row, to `stats`; a key pass for dk, dv; a query pass for dq)
// into dqkv's packed columns; the QKV projection's grads (`proj_bwd`):
// dxn = dqkv·Wqkvᵀ in fp32 (K1, whose LN tail follows) or dx =
// bf16(dqkv·Wqkvᵀ) (K9, K10), dWqkv = xnᵀ·dqkv in fp32, dbqkv a column
// sum. Neither P nor ds reaches device memory; no float atomics, so two
// runs give the same bits.
#pragma once

#include "attention_core.cuh"
#include "colsum.cuh"
#include "gemm_sm90.cuh"

namespace vitax {
namespace qkvo {

// The shapes the sequence takes (the caller's gate holds the rest: K13's
// head dims and sequence limit, d % 16)
inline bool shapes_ok(int b, int spq, int seq_len) {
  return b <= 65535 && seq_len > 0 && seq_len <= spq;
}

// K13's arguments for the packed qkv rows [b·spq, 3·hhd] and the head
// outputs attn [b·spq, hhd]
inline k13::CoreArgs packed_args(const bf16* qkv, bf16* attn, int spq, int seq_len, int heads,
                                 int head_dim, float scale) {
  const int hhd = heads * head_dim;
  k13::CoreArgs a{};
  a.q = qkv, a.k = qkv + hhd, a.v = qkv + 2 * hhd, a.o = attn;
  a.seq = seq_len, a.rows = a.kv_rows = spq, a.img_rows = a.kv_img_rows = spq, a.heads = heads;
  a.kv_heads = heads;
  a.scale = scale;
  a.ld_q = a.ld_k = a.ld_v = 3 * hhd;
  a.ld_o = hhd;
  return a;
}

// Launches 1 and 2: qkv and the head outputs attn from xn [b·spq, d] (K10's
// forward, attn its output)
inline cudaError_t qkv_core(const bf16* xn, const bf16* wqkv, const float* bqkv, bf16* qkv,
                            bf16* attn, int b, int spq, int d, int seq_len, int heads,
                            int head_dim, float scale, cudaStream_t st) {
  const int n = b * spq;
  const int w = 3 * heads * head_dim;
  cudaError_t e = sm90::gemm_nn<sm90::kEpiBias>(xn, wqkv, bqkv, qkv, nullptr, n, w, d, st);
  if (e != cudaSuccess) return e;
  return k13::launch_core_fwd(packed_args(qkv, attn, spq, seq_len, heads, head_dim, scale),
                              head_dim, b, st);
}

// The forward: out [b·spq, d] bf16 from xn; qkv [b·spq, 3·hhd] and attn
// [b·spq, hhd] bf16 scratch
inline cudaError_t fwd(const bf16* xn, const bf16* wqkv, const float* bqkv, const bf16* wo,
                       const float* bo, bf16* qkv, bf16* attn, bf16* out, int b, int spq, int d,
                       int seq_len, int heads, int head_dim, float scale, cudaStream_t st) {
  if (!shapes_ok(b, spq, seq_len)) return cudaErrorInvalidValue;
  cudaError_t e = qkv_core(xn, wqkv, bqkv, qkv, attn, b, spq, d, seq_len, heads, head_dim,
                           scale, st);
  if (e != cudaSuccess) return e;
  return sm90::gemm_nn<sm90::kEpiBias>(attn, wo, bo, out, nullptr, b * spq, d,
                                       heads * head_dim, st);
}

// fp32 workspace of `proj_bwd` over n rows, d inputs and qkv width w
inline size_t proj_bwd_workspace(int n, int d, int w) {
  const size_t a = colsum_workspace(n, w), c = gemm_tn_workspace(d, w, n);
  return a > c ? a : c;
}

// fp32 workspace of `bwd` over n rows, d inputs, hhd head columns and qkv
// width w (3·hhd)
inline size_t bwd_workspace(int n, int d, int hhd, int w) {
  const size_t sizes[] = {colsum_workspace(n, d), gemm_tn_workspace(hhd, d, n),
                          proj_bwd_workspace(n, d, w)};
  size_t m = 0;
  for (size_t s : sizes) m = s > m ? s : m;
  return m;
}

// The QKV projection's grads from xn and dqkv [n, w] (the backward's last
// three launches in K1, K9 and K10): dxn = dqkv·Wqkvᵀ in fp32 where dxn is
// given, else dx = bf16(dqkv·Wqkvᵀ), one rounding; dWqkv [d, w] = xnᵀ·dqkv
// in fp32 on the split-K kTN product; dbqkv [w] a two-pass column sum. ws
// fp32 proj_bwd_workspace(n, d, w).
inline cudaError_t proj_bwd(const bf16* xn, const bf16* wqkv, const bf16* dqkv, bf16* dx,
                            float* dxn, float* dwqkv, float* dbqkv, float* ws, int n, int d,
                            int w, cudaStream_t st) {
  cudaError_t e = dxn != nullptr
                      ? sm90::gemm_nt<sm90::kEpiF32>(dqkv, wqkv, nullptr, dxn, n, d, w, st)
                      : sm90::gemm_nt<sm90::kEpiStore>(dqkv, wqkv, dx, nullptr, n, d, w, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_tn(xn, dqkv, dwqkv, ws, d, w, n, st);
  if (e != cudaSuccess) return e;
  return launch_colsum(dqkv, dbqkv, ws, n, w, st);
}

// The backward from xn and dY [b·spq, d]: dWqkv [d, w], dbqkv [w], dWo
// [hhd, d], dbo [d] in fp32, and the input grad, dxn fp32 [b·spq, d] where
// dxn is given, else dx bf16. Scratch (bf16 unless noted): qkv [n, w],
// attn and dattn [n, hhd], stats fp32 vitax_attention_core_bwd_ws(b, spq,
// heads), dqkv [n, w], ws fp32 bwd_workspace(n, d, hhd, w).
inline cudaError_t bwd(const bf16* xn, const bf16* wqkv, const float* bqkv, const bf16* wo,
                       const bf16* dout, bf16* dx, float* dxn, float* dwqkv, float* dbqkv,
                       float* dwo, float* dbo, bf16* qkv, bf16* attn, bf16* dattn, float* stats,
                       bf16* dqkv, float* ws, int b, int spq, int d, int seq_len, int heads,
                       int head_dim, float scale, cudaStream_t st) {
  const int n = b * spq;
  if (n == 0 || !shapes_ok(b, spq, seq_len)) return cudaErrorInvalidValue;
  const int hhd = heads * head_dim;
  const int w = 3 * hhd;

  // the recompute: the forward's own launches
  cudaError_t e = qkv_core(xn, wqkv, bqkv, qkv, attn, b, spq, d, seq_len, heads, head_dim,
                           scale, st);
  if (e != cudaSuccess) return e;

  // out-projection grads
  e = sm90::gemm_nt<sm90::kEpiStore>(dout, wo, dattn, nullptr, n, hhd, d, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_tn(attn, dout, dwo, ws, hhd, d, n, st);
  if (e != cudaSuccess) return e;
  e = launch_colsum(dout, dbo, ws, n, d, st);
  if (e != cudaSuccess) return e;

  // attention-core grads -> dqkv (K13's three passes)
  k13::CoreArgs a = packed_args(qkv, attn, spq, seq_len, heads, head_dim, scale);
  a.out = attn, a.dout = dattn;
  a.dq = dqkv, a.dk = dqkv + hhd, a.dv = dqkv + 2 * hhd;
  a.stats = stats;
  a.seq_pad = (spq + k13::kRows - 1) / k13::kRows * k13::kRows;
  a.ld_dq = a.ld_dk = a.ld_dv = w;
  a.ld_do = hhd;
  e = k13::launch_core_bwd(a, head_dim, b, st);
  if (e != cudaSuccess) return e;

  // QKV projection grads
  return proj_bwd(xn, wqkv, dqkv, dx, dxn, dwqkv, dbqkv, ws, n, d, w, st);
}

}  // namespace qkvo
}  // namespace vitax
