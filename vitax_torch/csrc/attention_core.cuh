// K13's attention core for Hopper: the pieces of the forward
// (attention_core.cu) and of the backward's three passes
// (attention_core_bwd.cu), which replace vitax's _attn_fwd_kernel and
// _attn_bwd_kernel (vitax/ops/pallas_kernels.py:83 and :112). The .cu files'
// notes say what bounds each on the H100 and what each block holds.
//
// Design. A warpgroup (128 threads) owns a 64-row tile: query rows in the
// forward and in the row and query passes, key rows in the key pass. The
// forward and the row pass put two warpgroups in a block, which share each
// K (and V) tile they stage. A block's resident operands sit in shared
// memory for the whole kernel; the operands it walks (K and V tiles, or Q,
// dO and their rows' statistics) arrive in a ring of tiles filled by
// cp.async, the next tiles' copies in flight while the current tile's
// products run. Every product is a warpgroup MMA (wgmma.mma_async,
// m64nNk16, bf16 in, fp32 accumulators in registers):
//   - the 64×64 scores (q·kᵀ, dO·vᵀ, k·qᵀ, v·dOᵀ) with both operands in
//     shared memory (N 64: 32 fp32 registers a thread);
//   - the products whose N is head_dim (P·V, pᵀ·dO, dsᵀ·q, ds·k) with A,
//     the bf16 p or ds, packed straight from the score registers and B in
//     shared memory read transposed, in N chunks of 64, 32 or 16 (head_dim/2
//     fp32 accumulator registers a thread).
// Each step issues the scores of tile t and then the head_dim product of
// tile t − 1, and forms tile t's p (and ds) while the tensor cores run the
// latter; the ring therefore holds tile t − 1 as well as tile t.
// The softmax runs on the score registers: a thread holds 2 rows × 16
// columns of a tile, so a row's max and sum take two quad shuffles, and exp
// is one ex2.approx on fma(s, scale·log2e, −m); only the last key tile
// masks the keys >= seq.
//
// Why two passes over the keys (the forward's and the backward's row
// statistics before any p): vitax normalises p in fp32 over the whole row
// and rounds it to bf16 once (_softmax_rows :75-80), so the kernel needs m
// and l of the row before it forms the p that P·V consumes; a one-pass
// online softmax would round the unnormalised p of each tile instead.
// K6 (vitax's _flash_head_fwd, pallas_kernels.py:3391-3416) does just that:
// it rounds the unnormalised p = exp(s − m_new) of each key chunk, rescales
// its fp32 accumulator by α = exp(m − m_new) and divides by l at the end.
// Its core is the online mode of core_rows_kernel: one pass over the keys.
//
// Shared memory tiles are [64 rows, HD] bf16 in wgmma's no-swizzle layout:
// 8×8 core matrices of 128 contiguous bytes, core (row group rg, column
// group cg) at (rg·HD/8 + cg)·128 bytes, so the 16-byte chunk c of a tile
// (row 8·(c / 8 / (HD/8)) + c % 8, columns 8·((c / 8) % (HD/8)) + 0..7)
// lands at byte 16·c: eight consecutive threads fill one core matrix (no
// bank conflict) from eight rows of global memory. One layout serves both
// readings: K-major (rows are M or N, HD the depth: core stride 128 bytes
// along the depth, HD·16 along the rows) and MN-major (rows are the depth,
// HD is N: HD·16 bytes along the depth, 128 along N).
#pragma once

#include "common.cuh"

namespace vitax {
namespace k13 {

constexpr int kRows = 64;      // rows of a tile: a warpgroup's M
constexpr int kThreads = 128;  // a warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// Everything a K13 kernel reads or writes. Head h of image img of each of
// the query side's tensors (q, out (o, o32), dout, dq) starts at row
// img·img_rows, and of the key side's (k, v, dk, dv) at row img·kv_img_rows,
// column h·HD, each with its own row stride (ld_*, in elements): K13's own
// tensors are [images, seq, heads, HD] (every ld heads·HD, rows = kv_rows =
// img_rows = kv_img_rows = seq, the dense_geometry below); K1's backward
// reads q, k, v as column blocks of its packed qkv rows and writes dq, dk,
// dv into dqkv's (every row count spq). Query rows run to `rows`; the key
// side holds kv_rows rows an image, of which the keys < `seq` attend (keys
// >= seq masked, and their dk, dv written as 0): the square geometry has
// kv_rows = rows; K8's rect one (ln_qkvo_attention_rect_int8*.cu) has
// rows = cpq query rows against kv_rows = spq key rows, seq <= spq, and
// seq may pass rows. stats is the backward's [images, heads, 3, seq_pad]
// fp32 scratch: m·scale·log2e, 1/l and dd of every query row, seq_pad =
// rows rounded up to 64. o32 is the fp32 out of the kRowsFwdF32 mode (K3's
// and K8's int8 forwards), with o's row stride ld_o. The key side holds
// kv_heads heads (heads a multiple of it): query head h reads key head
// h·kv_heads/heads (vitax's _kv_off, pallas_kernels.py:2803), and the key
// pass sums dk, dv of a key head over its heads/kv_heads query heads
// (attention_core_bwd.cu); every geometry but K7's GQA one (kv_heads <
// heads, ln_qkvo_attention_int8_bwd.cu) has kv_heads = heads.
struct CoreArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* out;
  const bf16* dout;
  bf16* o;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* stats;
  float* o32;
  int seq;
  int heads;
  int kv_heads;
  int seq_pad;
  float scale;
  int rows;
  int img_rows;
  int kv_rows;
  int kv_img_rows;
  int ld_q, ld_k, ld_v, ld_o, ld_do, ld_dq, ld_dk, ld_dv;
};

// K13's own layout: every tensor [images, seq, heads, head_dim]
inline void dense_geometry(CoreArgs& a, int seq, int heads, int head_dim) {
  a.seq = a.rows = a.img_rows = a.kv_rows = a.kv_img_rows = seq;
  a.heads = a.kv_heads = heads;
  a.ld_q = a.ld_k = a.ld_v = a.ld_o = a.ld_do = a.ld_dq = a.ld_dk = a.ld_dv = heads * head_dim;
}

// The element offset of head h of image img in a query-side tensor of row
// stride ld
__device__ __forceinline__ size_t head_off(const CoreArgs& a, int ld, int img, int h, int hd) {
  return static_cast<size_t>(img) * a.img_rows * ld + static_cast<size_t>(h) * hd;
}
// ... and of key head g in a key-side tensor (k, v, dk, dv)
__device__ __forceinline__ size_t kv_head_off(const CoreArgs& a, int ld, int img, int g, int hd) {
  return static_cast<size_t>(img) * a.kv_img_rows * ld + static_cast<size_t>(g) * hd;
}
// The key head that query head h reads
__device__ __forceinline__ int kv_group(const CoreArgs& a, int h) {
  return h * a.kv_heads / a.heads;
}

// A geometry the kernels take: rows on both sides, keys to at most the key
// side's rows, whole groups of query heads a key head
inline bool geometry_ok(const CoreArgs& a) {
  return a.rows > 0 && a.seq > 0 && a.seq <= a.kv_rows && a.kv_rows <= a.kv_img_rows &&
         a.rows <= a.img_rows && a.kv_heads > 0 && a.heads % a.kv_heads == 0;
}

// The forward (attention_core.cu) and the backward's three passes
// (attention_core_bwd.cu) on any geometry of CoreArgs, head_dim one of
// VITAX_K13_HEAD_DIMS, images <= 65535: the forward writes a.o, the
// backward a.dq, a.dk, a.dv with a.stats as scratch. launch_core_bwd_passes
// runs the backward's key and query passes alone, on the a.stats that a
// row pass wrote (K6's online one, launch_core_online below).
cudaError_t launch_core_fwd(const CoreArgs& a, int head_dim, int images, cudaStream_t st);
cudaError_t launch_core_bwd(const CoreArgs& a, int head_dim, int images, cudaStream_t st);
cudaError_t launch_core_bwd_passes(const CoreArgs& a, int head_dim, int images, cudaStream_t st);

// ---------------------------------------------------------------- wgmma

__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;  // no swizzle, base offset 0
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups of the warpgroup are pending
template <int N = 0>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// cp.async writes through the generic proxy; wgmma reads through the async one
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving reads of accumulators above wg_wait().
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define VX_F4(i) "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define VX_F8(i) VX_F4(i), VX_F4((i) + 4)
#define VX_F16(i) VX_F8(i), VX_F8((i) + 8)
#define VX_F32(i) VX_F16(i), VX_F16((i) + 16)

// d[32] (64×64) = (acc ? d : 0) + A·B, both in shared memory, K-major
__device__ __forceinline__ void wgmma_ss64(float* d, uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : VX_F32(0)
      : "l"(a), "l"(b), "r"(acc));
}

// d[N/2] (64×N) += A·B, A bf16 fragments in registers, B in shared memory
// read transposed (MN-major)
template <int N>
struct WgmmaRS;
template <>
struct WgmmaRS<16> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : VX_F8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <>
struct WgmmaRS<32> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : VX_F16(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : VX_F32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

#undef VX_F4
#undef VX_F8
#undef VX_F16
#undef VX_F32

// The tile [64, HD] read K-major (HD the depth), k-step kk: depth 16kk..
template <int HD>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int kk) {
  return smem_desc(tile + kk * 128, 128, HD * 16);
}
// The tile read MN-major (the 64 rows the depth, HD the N), k-step kk,
// columns n0..
template <int HD>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk, int n0) {
  return smem_desc(tile + kk * 16 * HD + n0 * 8, HD * 16, 128);
}

// s[32] = A·Bᵀ over the depth HD: A, B [64, HD] tiles (q·kᵀ, dO·vᵀ, k·qᵀ, v·dOᵀ)
template <int HD>
__device__ __forceinline__ void mma_abt(float* s, const bf16* a, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss64(s, desc_k<HD>(a, kk), desc_k<HD>(b, kk), kk);
}

// The wgmma N of a product whose N is HD
template <int HD>
constexpr int kChunk = HD % 64 == 0 ? 64 : HD % 32 == 0 ? 32 : 16;

// acc[HD/2] += P·B: P 64×64 as bf16 fragments (to_frags), B a [64, HD] tile
// whose rows are P's columns
template <int HD>
__device__ __forceinline__ void mma_pb(float* acc, const uint32_t* pf, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int n0 = 0; n0 < HD; n0 += kChunk<HD>)
      WgmmaRS<kChunk<HD>>::mma(acc + n0 / 2, pf + 4 * kk, desc_mn<HD>(b, kk, n0));
  }
}

// ----------------------------------------------------- fragments, softmax
//
// Accumulator register i of a thread (lane = 4g + t of warp w of its
// warpgroup) holds row 16w + g + 8·((i / 2) % 2), column 8·(i / 4) + 2t + i % 2.

__device__ __forceinline__ int acc_row(int i) {
  return (threadIdx.x % kThreads) / 32 * 16 + (threadIdx.x % 32) / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int i) { return 8 * (i / 4) + 2 * (threadIdx.x % 4) + i % 2; }

// 2^x on the special-function unit, subnormal results flushed to 0 (a p
// below 2^-126 rounds to nothing beside the row's largest, which is 1/l)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A 64×64 fp32 accumulator → the A fragments of a k16 wgmma over its
// columns, rounded to bf16 once: f[4kk..4kk+3] hold columns 16kk..16kk+15
__device__ __forceinline__ void to_frags(const float* s, uint32_t* f) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    f[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    f[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    f[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    f[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------------------------------------------ tiles in memory

// cp.async of the [64, HD] tile whose row 0 is src (row stride ld) into dst
// by NT threads (tid < NT); rows >= rows_left are zero-filled and not read
// (src itself must lie in the tensor).
template <int HD, int NT>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int ld, int rows_left, int tid) {
  constexpr int kGroups = HD / 8;
  constexpr int kChunks = kRows * kGroups;
#pragma unroll
  for (int it = 0; it < (kChunks + NT - 1) / NT; ++it) {
    const int c = it * NT + tid;
    if (kChunks % NT != 0 && c >= kChunks) break;
    const int rest = c / 8;
    const int r = (rest / kGroups) * 8 + c % 8;
    const bool ok = r < rows_left;
    cp_async16(dst + c * 8, ok ? src + static_cast<size_t>(r) * ld + (rest % kGroups) * 8 : src,
               ok ? 16 : 0);
  }
}

// bf16(acc · mul) of a warpgroup's 64×HD accumulator to the rows of dst
// (row stride ld; rows >= rows_left not written), through the warpgroup's
// shared memory `buf` (64·(HD + 8) bf16) so each row goes out in 16-byte
// stores. Every thread of the block calls it: it starts and ends with a
// block barrier.
template <int HD>
__device__ __forceinline__ void store_rows(const float* acc, float mul, bf16* buf, bf16* dst,
                                           int ld, int rows_left) {
  constexpr int kLd = HD + 8;
  constexpr int kGroups = HD / 8;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    *reinterpret_cast<__nv_bfloat162*>(buf + acc_row(i) * kLd + acc_col(i)) =
        __floats2bfloat162_rn(acc[i] * mul, acc[i + 1] * mul);
  }
  __syncthreads();
  for (int c = threadIdx.x % kThreads; c < kRows * kGroups; c += kThreads) {
    const int r = c / kGroups;
    const int col = (c % kGroups) * 8;
    if (r < rows_left)
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * ld + col) =
          *reinterpret_cast<const uint4*>(buf + r * kLd + col);
  }
  __syncthreads();
}

// acc of a warpgroup's 64×HD accumulator in fp32 to the rows of dst (row
// stride ld; rows >= rows_left not written), through `buf` (64·(HD + 4)
// fp32) so each row goes out in 16-byte stores; block barriers as
// store_rows.
template <int HD>
__device__ __forceinline__ void store_rows_f32(const float* acc, float* buf, float* dst, int ld,
                                               int rows_left) {
  constexpr int kLd = HD + 4;
  constexpr int kGroups = HD / 4;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2)
    *reinterpret_cast<float2*>(buf + acc_row(i) * kLd + acc_col(i)) =
        make_float2(acc[i], acc[i + 1]);
  __syncthreads();
  for (int c = threadIdx.x % kThreads; c < kRows * kGroups; c += kThreads) {
    const int r = c / kGroups;
    const int col = (c % kGroups) * 4;
    if (r < rows_left)
      *reinterpret_cast<float4*>(dst + static_cast<size_t>(r) * ld + col) =
          *reinterpret_cast<const float4*>(buf + r * kLd + col);
  }
  __syncthreads();
}

// ------------------------------------- the forward and the backward's row pass

template <int HD>
constexpr size_t kTileBytes = static_cast<size_t>(kRows) * HD * 2;

// Query tiles a block of core_rows_kernel: two warpgroups share each K and V
// tile they stage, which halves the L2 → shared memory traffic
constexpr int kRowWgs = 2;
// Stages of its K/V ring: step t reads tile t and, in pass 2, V of tile
// t − 1 (below), while the copies of tiles t + 1 .. t + kStages − 2 are in
// flight; three above head_dim 80, where shared memory would hold one block
// an SM
template <int HD>
constexpr int kStages = HD <= 80 ? 4 : 3;

// What a block of core_rows_kernel computes
enum RowsMode : int {
  kRowsFwd = 0,          // K13's forward: the statistics pass, then p normalised and P·V
  kRowsStats = 1,        // K13's backward row pass: the statistics pass and dd
  kRowsOnline = 2,       // K6's forward: one pass, the online recurrence
  kRowsOnlineStats = 3,  // K6's backward row pass: the online forward, its statistics and dd
  kRowsFwdF32 = 4,       // K3's forward: kRowsFwd with the fp32 out (a.o32), never rounded
  kRowsFwdStats = 5,     // K10's backward row pass: kRowsFwd's two passes, statistics, dd
};

// Shared memory of core_rows_kernel: two Q tiles, then kStages K tiles and,
// but in K13's row pass, kStages V tiles
template <int HD, int kMode>
constexpr size_t kRowsSmem =
    (kRowWgs + (kMode == kRowsStats ? 1 : 2) * kStages<HD>) * kTileBytes<HD>;

// One block a (two 64-row query tiles, head, image), a warpgroup a tile.
// kRowsFwd and kRowsStats: pass 1 walks the key tiles for the row
// statistics: m (of s·scale·log2e) and l by the online recurrence, staging
// K only. The forward's pass 2 walks them again: p =
// exp2(s·scale·log2e − m)·(1/l), 0 on the keys >= seq, rounded to bf16
// once, and O += P·V in fp32 registers, cast once. Step t of pass 2 issues
// q·kᵀ of tile t, then P·V of tile t − 1, and forms tile t's p while the
// tensor cores run the latter. The row pass (kRowsStats) stops after pass 1
// and writes m, 1/l and dd = Σ fp32(dO)·fp32(out) of its rows (0 for the
// rows >= seq) to a.stats.
// kRowsOnline and kRowsOnlineStats (K6): one walk over the K and V tiles,
// with the same overlap: per tile m_new = max(m, rowmax(s)·scale·log2e),
// α = exp2(m − m_new), p = exp2(s·scale·log2e − m_new) (0 on the keys >=
// seq), l = l·α + Σp from the unrounded p, and bf16(p) packed as the A of
// P·V; O is rescaled by α once the previous tile's P·V has landed in it, so
// O = Σ α-rescaled bf16(p)·V in fp32, and out = O·(1/l), rounded to bf16
// once. kRowsOnlineStats also writes m, 1/l and dd = Σ fp32(dO)·out with
// the fp32 out (vitax's :3479), the statistics K13's key and query passes
// read. kRowsFwdStats (K10's backward) runs kRowsFwd's two passes and, in
// place of the out, writes kRowsStats' m and 1/l (the same pass 1) and dd
// from the fp32 out in its registers, as kRowsOnlineStats does: vitax's
// K10 takes dd from the fp32 bf16(p)·v (pallas_kernels.py:2263-2268),
// where K1's and K9's take it from the bf16 head output.
template <int HD>
__device__ __forceinline__ void store_stats_f32(const CoreArgs& a, const float (&o)[HD / 2],
                                                const float (&m)[2], const float (&inv)[2],
                                                int img, int h, int q0) {
  // m, 1/l, dd of rows g and g + 8 from the t = 0 lane of each quad, dd
  // summed over the quad's columns from the fp32 out in registers;
  // nothing from a warpgroup whose tile starts at or past the rows
  float* st = a.stats + (static_cast<size_t>(img) * a.heads + h) * 3 * a.seq_pad + q0;
  const bool tile = q0 < a.rows;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = acc_row(2 * r);
    const bool ok = q0 + row < a.rows;
    float dd = 0.f;
    if (ok) {
      const bf16* rd =
          a.dout + head_off(a, a.ld_do, img, h, HD) + static_cast<size_t>(q0 + row) * a.ld_do;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {  // registers 4j + 2r, 4j + 2r + 1: columns 8j + 2t, + 1
        const float2 d =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rd + acc_col(4 * j)));
        dd += d.x * o[4 * j + 2 * r] + d.y * o[4 * j + 2 * r + 1];
      }
    }
    dd = quad_sum(dd);
    if (tile && threadIdx.x % 4 == 0) {
      st[row] = ok ? m[r] : 0.f;
      st[a.seq_pad + row] = ok ? inv[r] : 0.f;
      st[2 * a.seq_pad + row] = dd;
    }
  }
}

template <int HD, int kMode>
__global__ void __launch_bounds__(kRowWgs* kThreads) core_rows_kernel(CoreArgs a) {
  constexpr bool kRowPass = kMode == kRowsStats;
  constexpr bool kOnline = kMode == kRowsOnline || kMode == kRowsOnlineStats;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kT = kRows * HD;
  constexpr int kBlock = kRowWgs * kThreads;
  const int wg = threadIdx.x / kThreads;
  bf16* Qs = reinterpret_cast<bf16*>(smem) + wg * kT;
  bf16* Ks = reinterpret_cast<bf16*>(smem) + kRowWgs * kT;
  constexpr int kS = kStages<HD>;
  bf16* Vs = Ks + kS * kT;
  const int img = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = (blockIdx.x * kRowWgs + wg) * kRows;
  const bf16* kh = a.k + kv_head_off(a, a.ld_k, img, kv_group(a, h), HD);
  const bf16* vh = a.v + kv_head_off(a, a.ld_v, img, kv_group(a, h), HD);
  const int nt = (a.seq + kRows - 1) / kRows;
  const int steps = kRowPass || kOnline ? nt : 2 * nt;
  const float c = a.scale * kLog2e;

  // a tile past the rows (the second of a block) stages zeros
  stage<HD, kThreads>(Qs,
                      a.q + head_off(a, a.ld_q, img, h, HD) +
                          static_cast<size_t>(q0 < a.rows ? q0 : 0) * a.ld_q,
                      a.ld_q, a.rows - q0, threadIdx.x % kThreads);
  // the two-pass modes: step < nt pass 1, K only; else pass 2, K and V;
  // the online modes: K and V of tile `step`
  auto issue = [&](int step) {
    if (step < steps) {
      const int kt = kOnline || step < nt ? step : step - nt;
      const size_t r0 = static_cast<size_t>(kt) * kRows;
      stage<HD, kBlock>(Ks + step % kS * kT, kh + r0 * a.ld_k, a.ld_k, a.seq - kt * kRows,
                        threadIdx.x);
      if (kOnline || step >= nt)
        stage<HD, kBlock>(Vs + step % kS * kT, vh + r0 * a.ld_v, a.ld_v, a.seq - kt * kRows,
                          threadIdx.x);
    }
    cp_async_commit();  // one group a step, empty past the end
  };
#pragma unroll
  for (int step = 0; step < kS - 2; ++step) issue(step);

  float s[32];
  float o[HD / 2];
  uint32_t pf[16];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  if constexpr (kOnline) {
    for (int step = 0; step < nt; ++step) {
      cp_async_wait<kS - 3>();
      fence_async_smem();
      __syncthreads();  // K and V of tile `step` have landed; tile step − 2's slots are free
      issue(step + kS - 2);
      const int k0 = step * kRows;
      wg_fence();
      mma_abt<HD>(s, Qs, Ks + step % kS * kT);
      wg_commit();
      if (step > 0) {  // P·V of the previous tile runs under this tile's softmax
        mma_pb<HD>(o, pf, Vs + (step - 1) % kS * kT);
        wg_commit();
        wg_wait<1>();
      } else {
        wg_wait();
      }
      fence_regs<32>(s);
      if (k0 + kRows > a.seq) {  // the last tile: keys >= seq
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (k0 + acc_col(i) >= a.seq) s[i] = -INFINITY;
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the row's registers 4(j/2) + 2r + j%2
        float mx = s[2 * r];
#pragma unroll
        for (int j = 1; j < 16; ++j) mx = fmaxf(mx, s[4 * (j / 2) + 2 * r + j % 2]);
        const float mn = fmaxf(m[r], quad_max(mx) * c);  // scale > 0: max commutes
        alpha[r] = ex2(m[r] - mn);  // 0 at the first tile (m = −inf)
        m[r] = mn;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = ex2(fmaf(s[i], c, -m[(i / 2) % 2]));  // −inf (masked) → 0
        sum[(i / 2) % 2] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];  // a lane's columns
      wg_wait();  // the previous P·V has landed in o and read pf
      fence_regs<HD / 2>(o);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i / 2) % 2];
      to_frags(s, pf);
    }
    wg_fence();  // P·V of the last tile
    mma_pb<HD>(o, pf, Vs + (nt - 1) % kS * kT);
    wg_commit();
    wg_wait();
    fence_regs<HD / 2>(o);
  } else {
    for (int step = 0; step < steps; ++step) {
      cp_async_wait<kS - 3>();
      fence_async_smem();
      __syncthreads();  // tile `step` has landed; tile step − 2's buffers are free
      issue(step + kS - 2);
      const int k0 = (step < nt ? step : step - nt) * kRows;
      wg_fence();
      mma_abt<HD>(s, Qs, Ks + step % kS * kT);
      wg_commit();
      if (!kRowPass && step > nt) {  // P·V of the previous tile runs under this tile's softmax
        mma_pb<HD>(o, pf, Vs + (step - 1) % kS * kT);
        wg_commit();
        wg_wait<1>();
      } else {
        wg_wait();
      }
      fence_regs<32>(s);
      const bool edge = k0 + kRows > a.seq;  // the last tile: keys >= seq
      if (step < nt) {
        if (edge) {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            if (k0 + acc_col(i) >= a.seq) s[i] = -INFINITY;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // the row's registers 4(j/2) + 2r + j%2
          float mx = s[2 * r];
#pragma unroll
          for (int j = 1; j < 16; ++j) mx = fmaxf(mx, s[4 * (j / 2) + 2 * r + j % 2]);
          const float mn = fmaxf(m[r], quad_max(mx) * c);  // scale > 0: max commutes
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j) sum += ex2(fmaf(s[4 * (j / 2) + 2 * r + j % 2], c, -mn));
          l[r] = l[r] * ex2(m[r] - mn) + sum;
          m[r] = mn;
        }
        continue;
      }
      if (step == nt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = 1.f / quad_sum(l[r]);  // 1/l, as _softmax_rows
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = ex2(fmaf(s[i], c, -m[(i / 2) % 2])) * l[(i / 2) % 2];
      if (edge) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (k0 + acc_col(i) >= a.seq) s[i] = 0.f;
      }
      wg_wait();  // the previous P·V has read pf
      fence_regs<HD / 2>(o);
      to_frags(s, pf);
    }
    if constexpr (!kRowPass) {  // P·V of the last tile
      wg_fence();
      mma_pb<HD>(o, pf, Vs + (steps - 1) % kS * kT);
      wg_commit();
      wg_wait();
      fence_regs<HD / 2>(o);
    }
  }

  if constexpr (kOnline) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[r] = 1.f / quad_sum(l[r]);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= inv[(i / 2) % 2];  // the fp32 out
    store_rows<HD>(o, 1.f, Ks + wg * kRows * (HD + 8),
                   a.o + head_off(a, a.ld_o, img, h, HD) + static_cast<size_t>(q0) * a.ld_o,
                   a.ld_o, a.rows - q0);
    if constexpr (kMode == kRowsOnlineStats) store_stats_f32<HD>(a, o, m, inv, img, h, q0);
  } else if constexpr (kMode == kRowsFwdStats) {
    store_stats_f32<HD>(a, o, m, l, img, h, q0);  // l holds 1/l since pass 2 began
  } else if constexpr (kRowPass) {
    // m, 1/l of rows g and g + 8 from the t = 0 lane of each quad; dd by
    // two threads a row; nothing from a warpgroup whose tile starts at or
    // past the rows (seq_pad ends there)
    float* st = a.stats + (static_cast<size_t>(img) * a.heads + h) * 3 * a.seq_pad + q0;
    const bool tile = q0 < a.rows;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / quad_sum(l[r]);
      const int row = acc_row(2 * r);
      if (tile && threadIdx.x % 4 == 0) {
        const bool ok = q0 + row < a.rows;
        st[row] = ok ? m[r] : 0.f;
        st[a.seq_pad + row] = ok ? inv : 0.f;
      }
    }
    const int row = threadIdx.x % kThreads / 2;
    float dd = 0.f;
    if (q0 + row < a.rows) {
      const size_t col = (threadIdx.x % 2) * (HD / 2);
      const bf16* ro_row = a.out + head_off(a, a.ld_o, img, h, HD) +
                           static_cast<size_t>(q0 + row) * a.ld_o + col;
      const bf16* rd_row = a.dout + head_off(a, a.ld_do, img, h, HD) +
                           static_cast<size_t>(q0 + row) * a.ld_do + col;
#pragma unroll
      for (int j = 0; j < HD / 2; j += 8) {
        const uint4 ro = *reinterpret_cast<const uint4*>(ro_row + j);
        const uint4 rd = *reinterpret_cast<const uint4*>(rd_row + j);
        const bf16* vo = reinterpret_cast<const bf16*>(&ro);
        const bf16* vd = reinterpret_cast<const bf16*>(&rd);
#pragma unroll
        for (int e = 0; e < 8; ++e) dd += __bfloat162float(vd[e]) * __bfloat162float(vo[e]);
      }
    }
    dd += __shfl_xor_sync(0xffffffffu, dd, 1);
    if (tile && threadIdx.x % 2 == 0) st[2 * a.seq_pad + row] = dd;
  } else if constexpr (kMode == kRowsFwdF32) {  // the K and V ring stages it (free by now)
    store_rows_f32<HD>(o, reinterpret_cast<float*>(Ks) + wg * kRows * (HD + 4),
                       a.o32 + head_off(a, a.ld_o, img, h, HD) + static_cast<size_t>(q0) * a.ld_o,
                       a.ld_o, a.rows - q0);
  } else {
    store_rows<HD>(o, 1.f, Ks + wg * kRows * (HD + 8),
                   a.o + head_off(a, a.ld_o, img, h, HD) + static_cast<size_t>(q0) * a.ld_o,
                   a.ld_o, a.rows - q0);
  }
}

template <int HD, int kMode>
cudaError_t launch_rows(const CoreArgs& a, int images, cudaStream_t st) {
  constexpr size_t smem = kRowsSmem<HD, kMode>;
  if (!geometry_ok(a)) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(core_rows_kernel<HD, kMode>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.rows + kRowWgs * kRows - 1) / (kRowWgs * kRows), a.heads, images);
  core_rows_kernel<HD, kMode><<<grid, kRowWgs * kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// The head dims of the K13 instances: every multiple of 16 up to 128
#define VITAX_K13_HEAD_DIMS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)
// K6's (cuda_kernels.FLASH_HEAD_DIMS), a subset of them
#define VITAX_K6_HEAD_DIMS(X) X(32) X(64) X(80) X(128)

// K6's online core, kMode kRowsOnline (its forward, ln_qkvo_attention_flash.cu:
// writes a.o) or kRowsOnlineStats (its backward's row pass,
// ln_qkvo_attention_flash_bwd.cu: a.o and a.stats), head_dim one of
// VITAX_K6_HEAD_DIMS; each source instantiates its own mode.
template <int kMode>
cudaError_t launch_core_online(const CoreArgs& a, int head_dim, int images, cudaStream_t st) {
  switch (head_dim) {
#define VITAX_CASE(HD) \
  case HD:             \
    return launch_rows<HD, kMode>(a, images, st);
    VITAX_K6_HEAD_DIMS(VITAX_CASE)
#undef VITAX_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// core_rows_kernel in mode kMode, head_dim one of VITAX_K13_HEAD_DIMS,
// images <= 65535: K13's forward (kRowsFwd, attention_core.cu), K3's
// (kRowsFwdF32, ln_qkvo_attention_int8.cu: the fp32 head outputs to a.o32)
// and K10's backward row pass (kRowsFwdStats, qkv_attention_bwd.cu: a.stats
// with dd from the fp32 head outputs); each source instantiates the modes it
// launches.
template <int kMode>
cudaError_t launch_core_rows(const CoreArgs& a, int head_dim, int images, cudaStream_t st) {
  switch (head_dim) {
#define VITAX_CASE(HD) \
  case HD:             \
    return launch_rows<HD, kMode>(a, images, st);
    VITAX_K13_HEAD_DIMS(VITAX_CASE)
#undef VITAX_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace k13
}  // namespace vitax
