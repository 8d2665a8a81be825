// K1, fused LN-QKVO attention forward: replaces _ln_qkvo_fwd_kernel
// (vitax/ops/pallas_kernels.py:2640), the bf16 branch of
// fused_ln_qkvo_attention (:3111, pallas_call at :3186).
//
//   xn   = bf16(LN1(x))                                   (:2646-2652)
//   qkv  = bf16(xn @ Wqkv + bqkv)                         (:2653-2654)
//   per head: s = (q k^T) * 1/sqrt(hd), cols >= seq_len -> -1e30,
//             p = bf16(softmax_fp32(s)), o = bf16(p @ v)  (:2662-2681)
//   attn = heads side by side, head-major columns         (:2682-2684)
//   out  = bf16(attn @ Wo + bo)                            (:2685-2686)
//
// x is [B, spq, D] with the padded-stream pad rows; the residual is not
// added (the caller adds it in bf16).
//
// Bound on the H100: the two projections are tensor-core bound (gemm.cuh).
// The attention core is small in flops (4*spq^2*hd per head) but, done
// naively, bound by re-reading K and V and by the [spq, spq] score matrix.
// Design of the core: one block per (image, head, group of query tiles); K
// and V of that head are staged once into shared memory, zero-filled past
// spq; each warp owns a 16-row query tile and keeps its whole fp32 score rows
// in shared memory, so the softmax is exact over the full row (no online
// rescaling) and matches the TPU's rounding points. Scores and P @ V run on
// the tensor cores (WMMA bf16, fp32 accumulate). At spq 584 a 64-row tile's
// scores plus K and V exceed the 227 KB a block may use, so the host picks the
// number of warps (query tiles) a block holds from the shared memory it needs:
// 4 at spq 200, 1 at spq 584. The scores never reach device memory; xn, qkv
// and attn do (the multi-launch form of this first version).
#include <mma.h>

#include "gemm.cuh"
#include "layernorm.cuh"

namespace vitax {

constexpr int kSmemLimit = 232448;  // 227 KB, the most a block may opt into

__host__ __device__ inline int attn_rows_padded(int spq) { return (spq + 15) / 16 * 16; }

__host__ __device__ inline size_t attn_smem_bytes(int spq, int hd, int warps) {
  const size_t L = attn_rows_padded(spq);
  const size_t sw = L > static_cast<size_t>(hd) ? L : hd;
  return 2 * L * hd * 2 + warps * (16 * hd * 2 + 16 * sw * 4 + 16 * L * 2);
}

template <int HD>
__global__ void attention_core_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                                      int spq, int seq_len, int heads, float scale) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = attn_rows_padded(spq);
  const int sw = L > HD ? L : HD;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hhd = heads * HD;
  const size_t row_stride = 3 * static_cast<size_t>(hhd);
  const bf16* base = qkv + static_cast<size_t>(b) * spq * row_stride;

  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + L * HD;
  unsigned char* mine = smem + 2 * static_cast<size_t>(L) * HD * 2 +
                        warp * static_cast<size_t>(16 * HD * 2 + 16 * sw * 4 + 16 * L * 2);
  bf16* Qs = reinterpret_cast<bf16*>(mine);
  float* S = reinterpret_cast<float*>(mine + 16 * HD * 2);
  bf16* P = reinterpret_cast<bf16*>(mine + 16 * HD * 2 + 16 * static_cast<size_t>(sw) * 4);

  constexpr int kVecs = HD / 8;  // 16-byte vectors per head row
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < L * kVecs; i += blockDim.x) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    uint4 kv = zero, vv = zero;
    if (r < spq) {
      const bf16* row = base + r * row_stride + h * HD + c;
      kv = *reinterpret_cast<const uint4*>(row + hhd);
      vv = *reinterpret_cast<const uint4*>(row + 2 * hhd);
    }
    *reinterpret_cast<uint4*>(Ks + r * HD + c) = kv;
    *reinterpret_cast<uint4*>(Vs + r * HD + c) = vv;
  }
  const int q0 = (blockIdx.x * warps + warp) * 16;
  for (int i = lane; i < 16 * kVecs; i += 32) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    uint4 qv = zero;
    if (q0 + r < spq) qv = *reinterpret_cast<const uint4*>(base + (q0 + r) * row_stride + h * HD + c);
    *reinterpret_cast<uint4*>(Qs + r * HD + c) = qv;
  }
  __syncthreads();
  if (q0 >= spq) return;  // no block-wide barrier follows

  // scores S = Q K^T for the warp's 16 query rows over all L key rows
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

  // exact fp32 softmax over each whole row; p = e * (1/sum), cast to bf16
  for (int r = 0; r < 16; ++r) {
    float* srow = S + r * sw;
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
    for (int c = lane; c < L; c += 32) P[r * L + c] = __float2bfloat16(srow[c] * inv);
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

  for (int i = lane; i < 16 * kVecs; i += 32) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    if (q0 + r >= spq) continue;
    uint4 o_u;
    bf16* o = reinterpret_cast<bf16*>(&o_u);
#pragma unroll
    for (int t = 0; t < 8; ++t) o[t] = __float2bfloat16(S[r * HD + c + t]);
    *reinterpret_cast<uint4*>(out + (static_cast<size_t>(b) * spq + q0 + r) * hhd + h * HD + c) =
        o_u;
  }
}

// Query tiles (warps) per block: as many as fit in shared memory, up to 4.
inline int attn_warps(int spq, int hd) {
  int w = 4;
  while (w > 1 && attn_smem_bytes(spq, hd, w) > kSmemLimit) w /= 2;
  const int tiles = (spq + 15) / 16;
  while (w > 1 && w / 2 >= tiles) w /= 2;
  return w;
}

template <int HD>
cudaError_t launch_attention_core(const bf16* qkv, bf16* out, int b, int spq, int seq_len,
                                  int heads, float scale, cudaStream_t stream) {
  const int warps = attn_warps(spq, HD);
  const size_t smem = attn_smem_bytes(spq, HD, warps);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attention_core_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int tiles = (spq + 15) / 16;
  const dim3 grid((tiles + warps - 1) / warps, heads, b);
  attention_core_kernel<HD><<<grid, 32 * warps, smem, stream>>>(qkv, out, spq, seq_len, heads,
                                                                scale);
  return cudaGetLastError();
}

}  // namespace vitax

extern "C" int vitax_ln_qkvo_attention_fwd(const void* x, const void* gamma, const void* beta,
                                           const void* wqkv, const void* bqkv, const void* wo,
                                           const void* bo, void* xn, void* qkv, void* attn,
                                           void* out, int b, int spq, int d, int seq_len,
                                           int heads, int head_dim, float eps, float scale,
                                           void* stream) {
  using vitax::bf16;
  const auto st = static_cast<cudaStream_t>(stream);
  const int n = b * spq;
  const int hhd = heads * head_dim;
  auto* xnb = static_cast<bf16*>(xn);
  auto* qkvb = static_cast<bf16*>(qkv);
  auto* attnb = static_cast<bf16*>(attn);
  cudaError_t e = vitax::launch_layer_norm(static_cast<const bf16*>(x),
                                           static_cast<const float*>(gamma),
                                           static_cast<const float*>(beta), xnb, n, d, eps, st);
  if (e != cudaSuccess) return e;
  e = vitax::launch_gemm<vitax::kBias>(xnb, static_cast<const bf16*>(wqkv),
                                       static_cast<const float*>(bqkv), nullptr, qkvb, n,
                                       3 * hhd, d, st);
  if (e != cudaSuccess) return e;
  if (n > 0) {
    switch (head_dim) {
      case 32:
        e = vitax::launch_attention_core<32>(qkvb, attnb, b, spq, seq_len, heads, scale, st);
        break;
      case 64:
        e = vitax::launch_attention_core<64>(qkvb, attnb, b, spq, seq_len, heads, scale, st);
        break;
      case 128:
        e = vitax::launch_attention_core<128>(qkvb, attnb, b, spq, seq_len, heads, scale, st);
        break;
      default:
        return cudaErrorInvalidValue;
    }
    if (e != cudaSuccess) return e;
  }
  return vitax::launch_gemm<vitax::kBias>(attnb, static_cast<const bf16*>(wo),
                                          static_cast<const float*>(bo), nullptr,
                                          static_cast<bf16*>(out), n, d, hhd, st);
}
