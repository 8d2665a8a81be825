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
// Three passes on 64-row tiles with their products as wgmma
// (attention_core.cuh); neither P nor ds ever reaches device memory:
//   1. the row pass (core_rows_kernel<HD, true>, two warpgroups a block):
//      per query tile, the forward's statistics pass (vitax's VJP saves no
//      (m, l)) and dd; it writes m·scale·log2e, 1/l and dd, 12 bytes a row,
//      to the [images, heads, 3, seq_pad] scratch the wrapper allocates
//      (vitax_attention_core_bwd_ws; 0 on the rows >= seq);
//   2. the key pass (core_dkv_kernel, one warpgroup a block): a block owns
//      a 64-key tile with K and V in shared memory and dK, dV in fp32
//      registers, and walks the query tiles, Q, dO and their rows'
//      statistics in a three-stage cp.async ring: Sᵀ = k·qᵀ and
//      dPᵀ = v·dOᵀ (both operands in shared memory), p =
//      exp2(s·scale·log2e − m)·(1/l), dV += bf16(p)ᵀ·dO,
//      ds = bf16(p·(dP − dd)), dK += dsᵀ·q (A from registers);
//   3. the query pass (core_dq_kernel, one warpgroup a block): a block owns
//      a 64-row query tile with Q and dO in shared memory and walks the key
//      tiles, K and V in the ring: S, dP, p and ds again, dQ += ds·k.
// Each output row has one owner and sums in a fixed order: no atomics, and
// two runs give the same bits. dq and dk are scaled in fp32 and cast once.
//
// Bound on the H100: the bytes at ViT's shapes. The function moves q, k, v,
// out, dO in and dq, dk, dv out (8·seq·head_dim·2 bytes an (image, head))
// for 10·seq²·head_dim operations (q·kᵀ recomputed, dO·vᵀ, ds·k, dsᵀ·q,
// pᵀ·dO); these passes do 16·seq²·head_dim on the tensor cores (q·kᵀ three
// times, dO·vᵀ twice) and read 12 bytes a row more. A block, by head_dim
// (ptxas's registers; shared memory: the key pass 8 tiles of 64·head_dim
// bf16 and 3·768 bytes of statistics, the query pass 8 tiles, the row pass
// 2 + 4 (3 above 80); blocks an SM the lower of what registers and shared
// memory allow; the key pass spills 16 bytes at 128):
//   head_dim             16   32   48   64   80   96  112  128
//   key pass registers  156  165  197  221  240  252  255  255
//   key pass blocks       3    3    2    2    2    2    1    1
//   query pass registers 114 124  130  141  154  164  180  194
//   query pass blocks     4    4    3    3    2    2    2    1
//   row pass registers    58   60   60   60   61   64   66   67
// Layouts, the unpadded rows and the head dims as the forward's
// (attention_core.cu).
//
// K1's backward (ln_qkvo_attention_bwd.cu) runs the same three passes
// through launch_core_bwd on its packed qkv rows (CoreArgs with a row
// stride per tensor): query rows to spq, keys masked at seq_len, dq, dk, dv
// written into dqkv's columns; the key pass writes the rows seq_len..spq of
// dk and dv as zeros, since p is 0 on those keys. K6's backward
// (ln_qkvo_attention_flash_bwd.cu) runs its own row pass, the online
// forward's (attention_core.cuh, kRowsOnlineStats: dd from the fp32 out,
// vitax's :3479), then the key and query passes alone
// (launch_core_bwd_passes), which read its statistics as they read these.
// K8's int8 backward (ln_qkvo_attention_rect_int8_bwd.cu) runs them in the
// rect geometry (attention_core.cuh's CoreArgs): the row and query passes
// over the cpq query rows of q and dO (xc's zero pad rows [cap, cpq)
// included, as vitax computes them), the key pass over the spq key rows of
// k and v, which walks the query tiles and writes dk, dv on every key row,
// 0 on the rows seq_len..spq. K7's int8 backward (ln_qkvo_attention_int8_bwd.cu
// with kv_heads < heads) runs them in the GQA geometry (CoreArgs::kv_heads):
// the row and query passes per query head, reading k and v of its group
// h·kv_heads/heads; the key pass one block per (64-key tile, kv group,
// image), kv_heads·tiles·images blocks where the square geometry has
// heads·tiles·images, each walking heads/kv_heads times as many query
// tiles, so its grid shrinks and its blocks lengthen by that factor.
#include "attention_core.cuh"

namespace vitax {
namespace k13 {

constexpr int kStatTile = 3 * kRows;  // m, 1/l, dd of a 64-row tile (floats)
// Stages of the rings: step t reads tile t and tile t − 1, while the copies
// of tile t + 1 are in flight
constexpr int kBwdStages = 3;

// Resident tiles, then kBwdStages stages of two tiles (and the key pass's
// statistics)
template <int HD>
constexpr size_t kDkvSmem = (2 + 2 * kBwdStages) * kTileBytes<HD> + kBwdStages * kStatTile * sizeof(float);
template <int HD>
constexpr size_t kDqSmem = (2 + 2 * kBwdStages) * kTileBytes<HD>;

// One block a (64-key tile, key head, image): dk, dv of its keys. The
// block walks the query tiles of each of the key head's heads/kv_heads
// query heads in turn (one head where kv_heads = heads), as one sequence of
// steps through the ring, with dK and dV in fp32 registers across the
// whole walk: a group's sum over its query heads in fp32, scaled and cast
// once (vitax's _attn_core_grads :2884-2892). Step j issues Sᵀ and dPᵀ of
// query tile j, then dV and dK of tile j − 1, and forms tile j's p and ds
// while the tensor cores run the latter.
template <int HD>
__global__ void __launch_bounds__(kThreads) core_dkv_kernel(CoreArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kT = kRows * HD;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kT;
  bf16* ring = Vs + kT;  // [kBwdStages] × (Q tile, dO tile)
  float* rstats = reinterpret_cast<float*>(ring + kBwdStages * 2 * kT);  // [kBwdStages] × kStatTile
  const int img = blockIdx.z;
  const int g = blockIdx.y;
  const int k0 = blockIdx.x * kRows;
  const int group = a.heads / a.kv_heads;
  const int nt = (a.rows + kRows - 1) / kRows;  // query tiles a query head
  const int steps = group * nt;
  const float c = a.scale * kLog2e;

  // key rows >= seq (a tile of them past seq in K1's and K8's padded rows)
  // stage zeros
  stage<HD, kThreads>(Ks,
                      a.k + kv_head_off(a, a.ld_k, img, g, HD) + static_cast<size_t>(k0) * a.ld_k,
                      a.ld_k, a.seq - k0, threadIdx.x);
  stage<HD, kThreads>(Vs,
                      a.v + kv_head_off(a, a.ld_v, img, g, HD) + static_cast<size_t>(k0) * a.ld_v,
                      a.ld_v, a.seq - k0, threadIdx.x);
  // step j: query tile j % nt of query head g·group + j / nt
  auto issue = [&](int j) {
    if (j < steps) {
      const int h = g * group + j / nt;
      const int qt = j % nt;
      const size_t r0 = static_cast<size_t>(qt) * kRows;
      bf16* dst = ring + j % kBwdStages * 2 * kT;
      stage<HD, kThreads>(dst, a.q + head_off(a, a.ld_q, img, h, HD) + r0 * a.ld_q, a.ld_q,
                          a.rows - qt * kRows, threadIdx.x);
      stage<HD, kThreads>(dst + kT, a.dout + head_off(a, a.ld_do, img, h, HD) + r0 * a.ld_do,
                          a.ld_do, a.rows - qt * kRows, threadIdx.x);
      if (threadIdx.x < kStatTile / 4) {  // 16-byte chunks of the three rows
        const float* stats = a.stats + (static_cast<size_t>(img) * a.heads + h) * 3 * a.seq_pad;
        const int plane = threadIdx.x / (kRows / 4);
        const int part = threadIdx.x % (kRows / 4) * 4;
        cp_async16(rstats + j % kBwdStages * kStatTile + plane * kRows + part,
                   stats + static_cast<size_t>(plane) * a.seq_pad + qt * kRows + part, 16);
      }
    }
    cp_async_commit();
  };
  issue(0);

  float st[32];
  float dp[32];
  float dk[HD / 2];
  float dv[HD / 2];
  uint32_t pf[16];
  uint32_t df[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int j = 0; j < steps; ++j) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();  // tile j has landed; tile j − 2's buffers are free
    issue(j + 1);
    const bf16* Qt = ring + j % kBwdStages * 2 * kT;
    const float* rs = rstats + j % kBwdStages * kStatTile;
    wg_fence();
    mma_abt<HD>(st, Ks, Qt);       // Sᵀ: rows keys, columns queries
    mma_abt<HD>(dp, Vs, Qt + kT);  // dPᵀ
    wg_commit();
    if (j > 0) {
      const bf16* Qp = ring + (j - 1) % kBwdStages * 2 * kT;
      mma_pb<HD>(dv, pf, Qp + kT);
      mma_pb<HD>(dk, df, Qp);
      wg_commit();
      wg_wait<1>();
    } else {
      wg_wait();
    }
    fence_regs<32>(st);
    fence_regs<32>(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {  // queries >= seq: 1/l and dd are 0 (the row pass)
      const int col = acc_col(i);
      st[i] = ex2(fmaf(st[i], c, -rs[col])) * rs[kRows + col];
      dp[i] = st[i] * (dp[i] - rs[2 * kRows + col]);
    }
    wg_wait();  // the previous dV, dK have read pf, df
    fence_regs<HD / 2>(dv);
    fence_regs<HD / 2>(dk);
    to_frags(st, pf);  // bf16(p)ᵀ
    to_frags(dp, df);  // dsᵀ = bf16(p (dP − dd))ᵀ
  }
  {  // the last tile's dV, dK
    const bf16* Qp = ring + (steps - 1) % kBwdStages * 2 * kT;
    wg_fence();
    mma_pb<HD>(dv, pf, Qp + kT);
    mma_pb<HD>(dk, df, Qp);
    wg_commit();
    wg_wait();
    fence_regs<HD / 2>(dv);
    fence_regs<HD / 2>(dk);
  }
  if (k0 + kRows > a.seq) {  // keys >= seq (stored only past seq_len): p is 0, so are dk, dv
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      if (k0 + acc_row(i) >= a.seq) dk[i] = dv[i] = 0.f;
    }
  }
  store_rows<HD>(dk, a.scale, ring,
                 a.dk + kv_head_off(a, a.ld_dk, img, g, HD) + static_cast<size_t>(k0) * a.ld_dk,
                 a.ld_dk, a.kv_rows - k0);
  store_rows<HD>(dv, 1.f, ring,
                 a.dv + kv_head_off(a, a.ld_dv, img, g, HD) + static_cast<size_t>(k0) * a.ld_dv,
                 a.ld_dv, a.kv_rows - k0);
}

// One block a (64-row query tile, head, image): dq of its rows, with dQ of
// key tile t − 1 under the ds of tile t as in the key pass.
template <int HD>
__global__ void __launch_bounds__(kThreads) core_dq_kernel(CoreArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kT = kRows * HD;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kT;
  bf16* ring = dOs + kT;  // [kBwdStages] × (K tile, V tile)
  const int img = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const bf16* kh = a.k + kv_head_off(a, a.ld_k, img, kv_group(a, h), HD);
  const bf16* vh = a.v + kv_head_off(a, a.ld_v, img, kv_group(a, h), HD);
  const float* stats =
      a.stats + (static_cast<size_t>(img) * a.heads + h) * 3 * a.seq_pad + q0;
  const int nt = (a.seq + kRows - 1) / kRows;  // key tiles
  const float c = a.scale * kLog2e;

  stage<HD, kThreads>(Qs, a.q + head_off(a, a.ld_q, img, h, HD) + static_cast<size_t>(q0) * a.ld_q,
                      a.ld_q, a.rows - q0, threadIdx.x);
  stage<HD, kThreads>(dOs,
                      a.dout + head_off(a, a.ld_do, img, h, HD) + static_cast<size_t>(q0) * a.ld_do,
                      a.ld_do, a.rows - q0, threadIdx.x);
  auto issue = [&](int kt) {
    if (kt < nt) {
      const size_t r0 = static_cast<size_t>(kt) * kRows;
      bf16* dst = ring + kt % kBwdStages * 2 * kT;
      stage<HD, kThreads>(dst, kh + r0 * a.ld_k, a.ld_k, a.seq - kt * kRows, threadIdx.x);
      stage<HD, kThreads>(dst + kT, vh + r0 * a.ld_v, a.ld_v, a.seq - kt * kRows, threadIdx.x);
    }
    cp_async_commit();
  };
  issue(0);
  float m[2];
  float il[2];
  float dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // rows >= seq hold zeros (the row pass)
    const int row = acc_row(2 * r);
    m[r] = stats[row];
    il[r] = stats[a.seq_pad + row];
    dd[r] = stats[2 * a.seq_pad + row];
  }

  float s[32];
  float dp[32];
  float dq[HD / 2];
  uint32_t df[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

  for (int kt = 0; kt < nt; ++kt) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();  // tile kt has landed; tile kt − 2's buffers are free
    issue(kt + 1);
    const bf16* Kt = ring + kt % kBwdStages * 2 * kT;
    wg_fence();
    mma_abt<HD>(s, Qs, Kt);
    mma_abt<HD>(dp, dOs, Kt + kT);
    wg_commit();
    if (kt > 0) {
      mma_pb<HD>(dq, df, ring + (kt - 1) % kBwdStages * 2 * kT);
      wg_commit();
      wg_wait<1>();
    } else {
      wg_wait();
    }
    fence_regs<32>(s);
    fence_regs<32>(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      dp[i] = ex2(fmaf(s[i], c, -m[r])) * il[r] * (dp[i] - dd[r]);
    }
    if (kt * kRows + kRows > a.seq) {  // the last tile: keys >= seq
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (kt * kRows + acc_col(i) >= a.seq) dp[i] = 0.f;
    }
    wg_wait();  // the previous dQ has read df
    fence_regs<HD / 2>(dq);
    to_frags(dp, df);  // ds = bf16(p (dP − dd))
  }
  wg_fence();  // the last tile's dQ
  mma_pb<HD>(dq, df, ring + (nt - 1) % kBwdStages * 2 * kT);
  wg_commit();
  wg_wait();
  fence_regs<HD / 2>(dq);
  store_rows<HD>(dq, a.scale, ring,
                 a.dq + head_off(a, a.ld_dq, img, h, HD) + static_cast<size_t>(q0) * a.ld_dq,
                 a.ld_dq, a.rows - q0);
}

// The key pass over the key side's rows, then the query pass over the
// query rows
template <int HD>
cudaError_t launch_passes(const CoreArgs& a, int images, cudaStream_t st) {
  if (!geometry_ok(a)) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      core_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kDkvSmem<HD>));
  if (e != cudaSuccess) return e;
  core_dkv_kernel<HD><<<dim3((a.kv_rows + kRows - 1) / kRows, a.kv_heads, images), kThreads,
                        kDkvSmem<HD>, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(core_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kDqSmem<HD>));
  if (e != cudaSuccess) return e;
  core_dq_kernel<HD><<<dim3((a.rows + kRows - 1) / kRows, a.heads, images), kThreads, kDqSmem<HD>,
                       st>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd(const CoreArgs& a, int images, cudaStream_t st) {
  const cudaError_t e = launch_rows<HD, kRowsStats>(a, images, st);
  return e != cudaSuccess ? e : launch_passes<HD>(a, images, st);
}

cudaError_t launch_core_bwd(const CoreArgs& a, int head_dim, int images, cudaStream_t st) {
  switch (head_dim) {
#define VITAX_CASE(HD) \
  case HD:             \
    return launch_bwd<HD>(a, images, st);
    VITAX_K13_HEAD_DIMS(VITAX_CASE)
#undef VITAX_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_core_bwd_passes(const CoreArgs& a, int head_dim, int images, cudaStream_t st) {
  switch (head_dim) {
#define VITAX_CASE(HD) \
  case HD:             \
    return launch_passes<HD>(a, images, st);
    VITAX_K13_HEAD_DIMS(VITAX_CASE)
#undef VITAX_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace k13
}  // namespace vitax

namespace {

using vitax::bf16;
using vitax::k13::CoreArgs;

long long seq_pad(int seq) { return (static_cast<long long>(seq) + 63) / 64 * 64; }

}  // namespace

// fp32 elements of the backward's row-statistics scratch
extern "C" long long vitax_attention_core_bwd_ws(int images, int seq, int heads) {
  return 3LL * images * heads * seq_pad(seq);
}

// q, k, v, out, dout and the grads dq, dk, dv bf16 [images, seq, heads,
// head_dim]; stats fp32 vitax_attention_core_bwd_ws(images, seq, heads).
// Chunks of at most 65535 images, as the forward.
extern "C" int vitax_attention_core_bwd(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, void* dq, void* dk,
                                        void* dv, void* stats, int images, int seq, int heads,
                                        int head_dim, float scale, void* stream) {
  constexpr int kMaxImages = 65535;
  const auto st = static_cast<cudaStream_t>(stream);
  if (seq <= 0 || heads <= 0) return cudaErrorInvalidValue;
  const size_t ld = static_cast<size_t>(heads) * head_dim;
  const size_t per_image = static_cast<size_t>(3) * heads * seq_pad(seq);
  for (int i0 = 0; i0 < images; i0 += kMaxImages) {
    const int n = images - i0 < kMaxImages ? images - i0 : kMaxImages;
    const size_t off = static_cast<size_t>(i0) * seq * ld;
    CoreArgs a{};
    a.q = static_cast<const bf16*>(q) + off;
    a.k = static_cast<const bf16*>(k) + off;
    a.v = static_cast<const bf16*>(v) + off;
    a.out = static_cast<const bf16*>(out) + off;
    a.dout = static_cast<const bf16*>(dout) + off;
    a.dq = static_cast<bf16*>(dq) + off;
    a.dk = static_cast<bf16*>(dk) + off;
    a.dv = static_cast<bf16*>(dv) + off;
    a.stats = static_cast<float*>(stats) + i0 * per_image;
    vitax::k13::dense_geometry(a, seq, heads, head_dim);
    a.seq_pad = static_cast<int>(seq_pad(seq));
    a.scale = scale;
    const cudaError_t e = vitax::k13::launch_core_bwd(a, head_dim, n, st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}
