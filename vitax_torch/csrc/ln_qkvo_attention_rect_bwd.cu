// K8 backward, the rect (compacted-Q) fused attention half: replaces
// _ln_qkvo_rect_bwd_kernel (vitax/ops/pallas_kernels.py:4155), the bf16
// branch of _fused_ln_qkvo_rect_bwd (:4491, pallas_call at :4555), with
// _rect_core_recompute (:3949) and _rect_core_grads (:3977). The query rows
// are the cpq gathered rows xc, the key rows all spq rows x (:4168-4228):
//
//   recompute: xnc = bf16(LN(xc)), xn = bf16(LN(x))
//              q = bf16(xnc Wq + bq), kv = bf16(xn Wkv + bkv)  (column slices)
//              attn: K8's core over the spq keys, bf16
//   dattn = bf16(do Wo^T), dWo = attn^T do, dbo = Σ do          (xc rows)
//   per (image, head), P the fp32 softmax [cpq, spq]:
//     ds = bf16(P (dO V^T - rowsum(dO O))), dq = bf16((ds K) scale)   xc rows
//     dk = bf16((ds^T Q) scale), dv = bf16(bf16(P)^T dO)               x rows
//   dxnc = dq Wq^T, dxn = dkv Wkv^T (fp32), each into its own LN backward:
//     dxc = bf16(LN'(dxnc)), dx = bf16(LN'(dxn)); dγ, dβ summed over both sets
//   dWq = xnc^T dq, dWkv = xn^T dkv, dbq = Σ dq, dbkv = Σ dkv (fp32)
// dWqkv = [dWq | dWkv] is concatenated by the caller, as vitax's wrapper does.
//
// xc's pad rows (cpq - cap, zero-filled by the caller) are query rows like
// any other: vitax computes them, and whatever their dO (zero as the caller
// cuts it) enters dk, dv, dWq, dWo and dbq. x's pad rows (spq - seq_len)
// are masked key columns, so their P and ds are exactly 0 and their dk, dv
// rows add nothing to dWkv, dbkv.
//
// Bound on the H100: at b32, cpq 128 of spq 200 (Res-ViT b16's compaction at
// C 0.625), ~77 GFLOP on the tensor cores, 0.08 ms at 989 TFLOP/s: the Q-side
// products and the core shrink with cpq, the KV-side ones do not.
//
// The Hopper design: K1's backward sequence (ln_qkvo_attention_bwd.cu,
// kv_heads == heads) on K8's two row sets, on one stream:
//   1. the recompute of K8's forward (ln_qkvo_attention_rect.cu): the two
//      LNs, q and kv on gemm_sm90.cuh over the column slices of Wqkv read in
//      place by row stride 3·hhd, K13's forward core in its rect geometry
//      (attn bf16);
//   2. dattn = bf16(do·Woᵀ) (kNT), dWo = attnᵀ·do (kTN) and dbo, over the
//      cpq rows;
//   3. the core grads through K13's three passes in the rect geometry
//      (attention_core_bwd.cu): the row pass over the cpq query rows
//      (m·scale·log2e, 1/l and dd from the bf16 attn, 12 bytes a row, into
//      `stats`), the key pass over the spq key rows (dk, dv into kv's packed
//      columns of dkv, 0 on the keys >= seq_len), the query pass (dq).
//      Neither P nor ds reaches device memory (the first design kept
//      2·B·H·cpq·spq bf16 of them, 41 MB at b32 cpq 128 spq 200);
//   4. dxnc = dq·Wqᵀ and dxn = dkv·Wkvᵀ in fp32 (kNT through the slices);
//   5. dWq = xncᵀ·dq over xc's rows and dWkv = xnᵀ·dkv over x's (kTN, split
//      K with its ordered second pass), dbq and dbkv as two-pass column sums;
//   6. the two LN backwards (launch_layer_norm_bwd_two), dγ and dβ summed
//      over both row sets.
// No float atomics: two runs give the same bits.
#include "gemm_sm90.cuh"
#include "layernorm.cuh"

namespace {

size_t rect_bwd_ws(int nc, int n, int d, int hhd) {
  using namespace vitax;
  const size_t sizes[] = {layer_norm_bwd_workspace(nc, d),
                          layer_norm_bwd_workspace(n, d),
                          colsum_workspace(nc, d),
                          colsum_workspace(nc, hhd),
                          colsum_workspace(n, 2 * hhd),
                          gemm_tn_workspace(hhd, d, nc),
                          gemm_tn_workspace(d, hhd, nc),
                          gemm_tn_workspace(d, 2 * hhd, n)};
  size_t m = 0;
  for (size_t s : sizes) m = s > m ? s : m;
  return m;
}

}  // namespace

// fp32 workspace of K8's backward (both tiers) over nc query rows and n key
// rows.
extern "C" long long vitax_ln_qkvo_attention_rect_bwd_ws(int nc, int n, int d, int hhd) {
  return static_cast<long long>(rect_bwd_ws(nc, n, d, hhd));
}

// Inputs xc, dout bf16 [b·cpq, d], x bf16 [b·spq, d], gamma, beta fp32 [d],
// wqkv bf16 [d, 3hhd], bqkv fp32 [3hhd], wo bf16 [hhd, d]. Outputs dxc bf16
// [b·cpq, d], dx bf16 [b·spq, d], fp32 dgamma, dbeta [d], dwq [d, hhd], dwkv
// [d, 2hhd], dbq [hhd], dbkv [2hhd], dwo [hhd, d], dbo [d]. Scratch (bf16
// unless noted): xnc [b·cpq, d], xn [b·spq, d], q [b·cpq, hhd], kv
// [b·spq, 2hhd], attn, dattn, dq [b·cpq, hhd], stats fp32
// vitax_attention_core_bwd_ws(b, cpq, heads), dkv [b·spq, 2hhd], dxnc fp32
// [b·cpq, d], dxn fp32 [b·spq, d], g2, b2 fp32 [d], ws fp32
// vitax_ln_qkvo_attention_rect_bwd_ws(b·cpq, b·spq, d, hhd).
extern "C" int vitax_ln_qkvo_attention_rect_bwd(
    const void* xc, const void* x, const void* gamma, const void* beta, const void* wqkv,
    const void* bqkv, const void* wo, const void* dout, void* dxc, void* dx, void* dgamma,
    void* dbeta, void* dwq, void* dwkv, void* dbq, void* dbkv, void* dwo, void* dbo, void* xnc,
    void* xn, void* q, void* kv, void* attn, void* dattn, void* stats, void* dq, void* dkv,
    void* dxnc, void* dxn, void* g2, void* b2, void* ws, int b, int cpq, int spq, int d,
    int seq_len, int heads, int head_dim, float eps, float scale, void* stream) {
  using vitax::bf16;
  namespace sm90 = vitax::sm90;
  const auto st = static_cast<cudaStream_t>(stream);
  const int nc = b * cpq;
  const int n = b * spq;
  const int hhd = heads * head_dim;
  if (nc == 0 || n == 0 || b > 65535 || seq_len <= 0 || seq_len > spq)
    return cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  const auto* w = static_cast<const bf16*>(wqkv);
  const auto* bias = static_cast<const float*>(bqkv);
  const auto* xcb = static_cast<const bf16*>(xc);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* dob = static_cast<const bf16*>(dout);
  auto* xncb = static_cast<bf16*>(xnc);
  auto* xnb = static_cast<bf16*>(xn);
  auto* qb = static_cast<bf16*>(q);
  auto* kvb = static_cast<bf16*>(kv);
  auto* attnb = static_cast<bf16*>(attn);
  auto* dattnb = static_cast<bf16*>(dattn);
  auto* dqb = static_cast<bf16*>(dq);
  auto* dkvb = static_cast<bf16*>(dkv);
  auto* dxncf = static_cast<float*>(dxnc);
  auto* dxnf = static_cast<float*>(dxn);
  auto* wsf = static_cast<float*>(ws);

  // recompute both LNs, q, kv and the core (K13's forward, rect geometry)
  cudaError_t e = vitax::launch_layer_norm(xcb, g, be, xncb, nc, d, eps, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_layer_norm(xb, g, be, xnb, n, d, eps, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_nn<sm90::kEpiBias>(xncb, w, bias, qb, nullptr, nc, hhd, d, st, nullptr, nullptr,
                                    3 * hhd);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_nn<sm90::kEpiBias>(xnb, w + hhd, bias + hhd, kvb, nullptr, n, 2 * hhd, d, st,
                                    nullptr, nullptr, 3 * hhd);
  if (e != cudaSuccess) return e;
  vitax::k13::CoreArgs a{};
  a.q = qb, a.k = kvb, a.v = kvb + hhd;
  a.o = attnb, a.out = attnb, a.dout = dattnb;
  a.dq = dqb, a.dk = dkvb, a.dv = dkvb + hhd;
  a.stats = static_cast<float*>(stats);
  a.seq = seq_len, a.rows = a.img_rows = cpq, a.kv_rows = a.kv_img_rows = spq, a.heads = heads;
  a.kv_heads = heads;
  a.seq_pad = (cpq + vitax::k13::kRows - 1) / vitax::k13::kRows * vitax::k13::kRows;
  a.scale = scale;
  a.ld_q = a.ld_o = a.ld_do = a.ld_dq = hhd;
  a.ld_k = a.ld_v = a.ld_dk = a.ld_dv = 2 * hhd;
  e = vitax::k13::launch_core_fwd(a, head_dim, b, st);
  if (e != cudaSuccess) return e;

  // out-projection grads over the xc rows
  e = sm90::gemm_nt<sm90::kEpiStore>(dob, static_cast<const bf16*>(wo), dattnb, nullptr, nc, hhd,
                                     d, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_tn(attnb, dob, static_cast<float*>(dwo), wsf, hhd, d, nc, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_colsum(dob, static_cast<float*>(dbo), wsf, nc, d, st);
  if (e != cudaSuccess) return e;

  // the core grads: dq on the xc rows, dk and dv on the x rows (K13's passes)
  e = vitax::k13::launch_core_bwd(a, head_dim, b, st);
  if (e != cudaSuccess) return e;

  // projection grads of the two row sets and the two LN tails
  e = sm90::gemm_nt<sm90::kEpiF32>(dqb, w, nullptr, dxncf, nc, d, hhd, st, 3 * hhd);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_nt<sm90::kEpiF32>(dkvb, w + hhd, nullptr, dxnf, n, d, 2 * hhd, st, 3 * hhd);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_tn(xncb, dqb, static_cast<float*>(dwq), wsf, d, hhd, nc, st);
  if (e != cudaSuccess) return e;
  e = sm90::gemm_tn(xnb, dkvb, static_cast<float*>(dwkv), wsf, d, 2 * hhd, n, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_colsum(static_cast<const bf16*>(dqb), static_cast<float*>(dbq), wsf, nc, hhd,
                           st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_colsum(static_cast<const bf16*>(dkvb), static_cast<float*>(dbkv), wsf, n,
                           2 * hhd, st);
  if (e != cudaSuccess) return e;
  return vitax::launch_layer_norm_bwd_two<bf16, float>(
      xcb, dxncf, static_cast<bf16*>(dxc), nc, xb, dxnf, static_cast<bf16*>(dx), n, g,
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), static_cast<float*>(g2),
      static_cast<float*>(b2), wsf, d, eps, st);
}
