"""Hand-written Hopper kernels of the serving and training paths, each beside
its plain PyTorch version (counterpart of vitax/ops/pallas_kernels.py).

wrapper -> CUDA source (csrc/) -> the Pallas kernel it replaces
(pallas_kernels.py):

- `layer_norm` -> layernorm.cu -> `_ln_fwd_kernel` :267
- `fused_ln_qkvo_attention` -> ln_qkvo_attention.cu -> `_ln_qkvo_fwd_kernel`
  :2640
- `fused_ln_mlp` -> ln_mlp.cu -> `_ln_mlp_fwd_kernel` :587
- `layer_norm_bwd` -> layernorm_bwd.cu -> `_ln_bwd_kernel` :278
- `fused_ln_qkvo_attention_bwd` -> ln_qkvo_attention_bwd.cu ->
  `_ln_qkvo_bwd_kernel` :2898
- `fused_ln_mlp_bwd` -> ln_mlp_bwd.cu -> `_ln_mlp_bwd_kernel` :1308
- `fused_ln_qkvo_attention_int8` -> ln_qkvo_attention_int8.cu ->
  `_ln_qkvo_fwd_int8_kernel` :2690 (K3: gemm_sm90.cuh's s8 wgmma products
  and K13's core with an fp32 out)
- `fused_ln_mlp_int8` -> ln_mlp_int8.cu -> `_ln_mlp_fwd_int8_kernel` :683
  (K4: gemm_sm90.cuh's s8 wgmma products)
- `fused_ln_qkvo_attention_int8_bwd` -> ln_qkvo_attention_int8_bwd.cu ->
  `_ln_qkvo_bwd_int8_kernel` :2977 (K3 backward: gemm_sm90.cuh's s8 wgmma
  products and K13's core)
- `fused_ln_mlp_int8_bwd` -> ln_mlp_int8_bwd.cu -> `_ln_mlp_bwd_int8_kernel`
  :1122 (K4 backward: gemm_sm90.cuh's s8 wgmma products, fc1's recompute
  and dh1 as one dual product)
- `fused_ln_qkvo_attention_int8_dw_bwd`, `fused_ln_mlp_int8_dw_bwd` -> the
  same two sources with `int8_dw` on (dw_int8.cuh's operand packs,
  gemm_sm90.cuh's group fold) -> the `int8_dw` branches of those kernels,
  :3041-3049 and :3077-3084, :1173-1197
- `gemm_sm90_s8` -> gemm_sm90_s8.cu: the s8 products inside K3's and K4's
  int8 forwards and backwards and K5's halves launched alone, for the card
  tests (no path calls it)
- `fused_ln_qkvo_attention_int8_ho` -> ln_qkvo_attention_int8_ho.cu ->
  `_ln_qkvo_fwd_int8_ho_kernel` :3669 (K5: gemm_sm90.cuh's s8 products and
  K13's core)
- `fused_ln_mlp_int8_ho` -> ln_mlp_int8_ho.cu -> `_ln_mlp_fwd_int8_ho_kernel`
  :3732 (K5: gemm_sm90.cuh's s8 products)
- `fused_ln_qkvo_attention_gqa` -> ln_qkvo_attention.cu with kv_heads < heads
  -> the `kv_heads` branch of `_ln_qkvo_fwd_kernel` (`_kv_off` :2803, K7);
  `fused_ln_qkvo_attention(..., kv_heads=)` routes to it
- `fused_ln_qkvo_attention_rect` -> ln_qkvo_attention_rect.cu ->
  `_ln_qkvo_rect_fwd_kernel` :4033 (K8: gemm_sm90.cuh's products on the
  column slices of Wqkv, K13's core in its rect geometry)
- `fused_ln_qkvo_attention_rect_int8` -> ln_qkvo_attention_rect_int8.cu ->
  `_ln_qkvo_rect_fwd_int8_kernel` :4067 (K8, W8A8)
- `fused_ln_qkvo_attention_gqa_bwd` -> ln_qkvo_attention_bwd.cu with kv_heads
  < heads -> the `kv_heads` branch of `_ln_qkvo_bwd_kernel` :2898
  (`_attn_core_grads` :2846-2895, K7's backward);
  `fused_ln_qkvo_attention_bwd(..., kv_heads=)` routes to it
- `fused_ln_qkvo_attention_rect_bwd` -> ln_qkvo_attention_rect_bwd.cu ->
  `_ln_qkvo_rect_bwd_kernel` :4155 (K8 backward: gemm_sm90.cuh's products,
  K13's three passes in the rect geometry)
- `fused_ln_qkvo_attention_rect_int8_bwd`, `..._rect_int8_dw_bwd` ->
  ln_qkvo_attention_rect_int8_bwd.cu (+ dw_int8.cuh) ->
  `_ln_qkvo_rect_bwd_int8_kernel` :4253, its `int8_grad` and `int8_dw`
  branches
- `fused_ln_qkvo_attention_flash` -> ln_qkvo_attention_flash.cu ->
  `_ln_qkvo_fwd_flash_kernel` :3419 (K6: the products on gemm_sm90.cuh,
  the online core of attention_core.cuh)
- `fused_ln_qkvo_attention_flash_bwd` -> ln_qkvo_attention_flash_bwd.cu ->
  `_ln_qkvo_bwd_flash_kernel` :3446 (K6 backward)
- `fused_ln_mlp_bwd_wide` -> ln_mlp_bwd.cu at d > 1024 ->
  `_ln_mlp_bwd_chunked_kernel` :1527 (pallas_call at :1610);
  `fused_ln_mlp_bwd` routes to it there, as vitax's `_ln_mlp_2d_bwd`
- `flash_attention_bhsd`, `flash_attention` -> attention_core.cu ->
  `_attn_fwd_kernel` :83 (K13, the standalone attention core; both layouts
  count as `flash_attention`)
- `flash_attention_bwd` -> attention_core_bwd.cu -> `_attn_bwd_kernel` :112
  (K13 backward)
- `fused_ln_qkvo_attention_int8_gqa`, `..._int8_gqa_bwd`,
  `..._int8_gqa_dw_bwd` -> the two int8 sources above with kv_heads <
  heads -> the `kv_heads` branches of :2690 and :2977 (K7's int8 tier);
  the K3 wrappers route to them with `kv_heads=`
- `fused_ln_mlp_save`, `fused_ln_mlp_bwd_fast` -> ln_mlp_save.cu ->
  `_ln_mlp_fwd_save_kernel` :620, `_ln_mlp_bwd_fast_kernel` :1245 (K12,
  pallas_calls :1687, :1723)
- `fused_ln_mlp_int8_save`, `fused_ln_mlp_int8_save_bwd`,
  `fused_ln_mlp_int8_save_dw_bwd` -> ln_mlp_int8_save.cu (+ dw_int8.cuh) ->
  `_ln_mlp_fwd_int8_save_kernel` :732, `_ln_mlp_bwd_int8_save_kernel` :778
  and its `int8_dw` branch :816-830 (K12 int8, pallas_calls :2025, :2066)
- `fused_ln_mlp_int4` -> ln_mlp_int8.cu at L = 7 -> `_ln_mlp_fwd_int4_kernel`
  :961 (K11-A, pallas_call :1880)
- `fused_ln_mlp_int4_bwd`, `fused_ln_mlp_int4_dw_bwd` -> ln_mlp_int8_bwd.cu
  at L = 7 (+ dw_int8.cuh's fresh column packs) -> `_ln_mlp_bwd_int4_kernel`
  :1003 and its `int8_dw` branch :1057-1074 (K11-B, pallas_call :1914)
- `fused_ln_qkvo_attention_int4` -> ln_qkvo_attention_int8.cu at L = 7 ->
  `_ln_qkvo_fwd_int4_kernel` :2745 (K11-C, pallas_call :3137)
- `fused_ln_qkvo_attention_int4_bwd`, `..._int4_dw_bwd` ->
  ln_qkvo_attention_int8_bwd.cu at L = 7 -> the `int4_grad` branch of
  `_ln_qkvo_bwd_int8_kernel` :2977 with its `int8_dw` branches :3033-3040,
  :3071-3076 (K11-D, pallas_call :3252)
- `fused_ln_qkvo_attention_int4_gqa`, `..._int4_gqa_bwd`,
  `..._int4_gqa_dw_bwd` -> the same two sources at L = 7 with kv_heads <
  heads -> the `kv_heads` branches of :2745 and of :2977's int4_grad (G-F,
  G-B; Res-ViT's GQA int4); the K11 wrappers route to them with `kv_heads=`
- `fused_ln_qkvo_attention_rect_int4` -> ln_qkvo_attention_rect_int8.cu at
  L = 7 -> `_ln_qkvo_rect_fwd_int4_kernel` :4112 (R-F, pallas_call :4447)
- `fused_ln_qkvo_attention_rect_int4_bwd`, `..._rect_int4_dw_bwd` ->
  ln_qkvo_attention_rect_int8_bwd.cu at L = 7 (+ dw_int8.cuh's fresh column
  packs) -> the `int4_grad` branch of `_ln_qkvo_rect_bwd_int8_kernel` :4253
  with its `int8_dw` branches :4310-4315, :4352-4362 (R-B, R-B dw,
  pallas_call :4534)
- `fused_qkv_attention` -> qkv_attention.cu -> `_qkv_attn_fwd_kernel` :2216
  (K10, pallas_call :2307: the QKV projection and the core, no LN and no
  out-projection; Res-ViT's `attention` with fused_qkv and not fused_qkvo)
- `fused_qkv_attention_bwd` -> qkv_attention_bwd.cu -> `_qkv_attn_bwd_kernel`
  :2239 (K10 backward, pallas_call :2334)
- `fused_qkvo_attention` -> qkvo_attention.cu (+ qkvo_sm90.cuh) ->
  `_qkvo_attn_fwd_kernel` :2396 (K9, pallas_call :2559: K1's Hopper
  sequence without its LN; Res-ViT's `attention` under a mesh, and per
  model shard under tensor parallelism)
- `fused_qkvo_attention_bwd` -> qkvo_attention_bwd.cu (+ qkvo_sm90.cuh) ->
  `_qkvo_attn_bwd_kernel` :2432 (K9 backward, pallas_call :2593: K1's
  Hopper backward without its LN recompute and tail)
- `fused_ln_mlp_partial`, `fused_ln_mlp_partial_bwd` -> ln_mlp.cu and
  ln_mlp_bwd.cu with the residual off -> the `residual=False` branches of
  `_ln_mlp_fwd_kernel` :587 (:614) and `_ln_mlp_bwd_kernel` :1308 (K2 per
  model shard under tensor parallelism); `fused_ln_mlp(...,
  residual=False)` routes to them
- `fused_ln_mlp_int8_partial{,_bwd,_dw_bwd}`,
  `fused_ln_mlp_int4_partial{,_bwd,_dw_bwd}`, `fused_ln_mlp_save_partial`,
  `fused_ln_mlp_bwd_fast_partial`, `fused_ln_mlp_int8_save_partial{,_bwd,
  _dw_bwd}`, `fused_ln_mlp_bwd_wide_partial` -> ln_mlp_int8.cu,
  ln_mlp_int8_bwd.cu, ln_mlp_save.cu, ln_mlp_int8_save.cu and ln_mlp_bwd.cu
  with the residual off -> the `residual=False` branches of K4 (:718,
  :1219), K11-A/B (:997, :1096), K12 (:653, :1281; int8 :772, :862) and
  K2's chunked backward (:1589): the int8, int4 and save-acts MLP halves
  per model shard; each residual wrapper's `residual=False` routes to them

A wrapper given CPU tensors returns its `*_ref` twin (the CPU tests run
those). A wrapper given CUDA tensors launches its kernel or raises: there is
no fallback. With grad mode on and an input that requires grad, the forward
wrappers go through a `torch.autograd.Function` (`LayerNormFn`,
`FusedLnQkvoAttentionFn`, `FusedLnMlpFn`, the last two for both tiers)
whose backward is the matching `*_bwd` wrapper: the int8 one under
`int8_grad` (its `int8_dw` variant under `int8_dw`; K11's int4 one where
`int4_grad` picks it, as vitax's dispatch), else the bf16 one (K7's with
GQA); the int8 block handoff is `FusedBlockInt8HandoffFn`, whose
backward is the two int8 backwards; K8's is `FusedLnQkvoAttentionRectFn`,
whose backward is one of K8's three or R-B's two; K6's is `FusedLnQkvoAttentionFlashFn`;
K10's `FusedQkvAttentionFn`; K9's `FusedQkvoAttentionFn`;
K13's `FlashAttentionFn`; K12's `FusedLnMlpSaveFn`, which `fused_ln_mlp`
and `fused_ln_mlp_int8` take under `save_acts` (vitax's dispatch: bf16, or
int8 with `int8_grad`). As vitax's custom VJPs, each Function saves only
its inputs (K13's also its output, K12's the activations its forward
kept, as vitax's) and recomputes the rest in the backward; its grads
come back in the dtypes of the Pallas VJPs (weight grads in the weight's
dtype, LN and bias grads in fp32).

Each wrapper counts its launches in a plain int attribute, `wrapper.launches`,
incremented once per launch of its kernel and nowhere else, so a run can
show that its main path went through the kernels (`launch_counts`).

The `*_supported` gates are this port's own (the limits of K13's core and
of the GEMMs, bf16 only on the card). The models pick a half where these
and vitax's own gates (ops/gates.py) both pass; a path that keeps the first
design's whole-row core checks that core's limits too and raises by name
outside them (`_check_first_design`).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from vitax_torch.kernels import build
from vitax_torch.ops.common import matmul_f32
from vitax_torch.ops.layernorm import layer_norm_ref
from vitax_torch.ops.mlp import (GP_DEQUANT, GP_QSCALE, gelu_exact,
                                 gelu_exact_grad, gelu_grad_q, gelu_q)
from vitax_torch.ops.quant import (int_mm, pack_i8, quant_cols,
                                   quant_cols_host, quant_cols_host4,
                                   quant_rows, quant_rows4, quant_rows_host,
                                   quant_rows_host4)

SMEM_LIMIT = 232448  # bytes of shared memory a block may opt into (227 KB)
ATTN_HEAD_DIMS = (32, 64, 128)  # the first design's whole-row core
K13_HEAD_DIMS = tuple(range(16, 129, 16))  # VITAX_K13_HEAD_DIMS
K13_MAX_SEQ = 1024  # vitax's K13 and K1 gates (pallas_kernels.py:63, :2200)
K13_MAX_IMAGES = 65535  # the core's grid z
FLASH_HEAD_DIMS = (32, 64, 80, 128)  # K6's online core (VITAX_K6_HEAD_DIMS)
# vitax's _MLP_MONO_MAX_D: above it K2's backward is the :1610 route
MLP_MONO_MAX_D = 1024

_BF = torch.bfloat16
_F32 = torch.float32


# =============================================================================
# plumbing
# =============================================================================

def _check_cuda(name: str, tensors: dict, dtypes: dict) -> torch.device:
    """Device, dtype and contiguity checks for a CUDA launch."""
    dev = None
    for key, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} is on {t.device}, not CUDA")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {dev}")
        if t.dtype != dtypes[key]:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected "
                            f"{dtypes[key]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return dev


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_shape(name: str, key: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _workspace(floats: int, dev: torch.device) -> torch.Tensor:
    return torch.empty(max(int(floats), 1), dtype=_F32, device=dev)


def _f32(dev, *shape):
    return torch.empty(shape, dtype=_F32, device=dev)


def _bf(dev, *shape):
    return torch.empty(shape, dtype=_BF, device=dev)


def _i8(dev, *shape):
    return torch.empty(shape, dtype=torch.int8, device=dev)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    s8_launch_counts(reset=True)
    first_design_launch_counts(reset=True)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def _ln_stats(x32: torch.Tensor, eps: float):
    """(x̂, rstd) of fp32 rows, as the TPU kernels recompute them."""
    mu = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return xc * rstd, rstd


def _ln_bwd_tail(dy32: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor,
                 gamma: torch.Tensor):
    """LN backward on fp32 rows [N, D]: (dx, dγ = Σ dy·x̂, dβ = Σ dy)."""
    dyg = dy32 * gamma.float()
    m1 = dyg.mean(dim=-1, keepdim=True)
    m2 = (dyg * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (dyg - m1 - xhat * m2)
    return dx, (dy32 * xhat).sum(dim=0), dy32.sum(dim=0)


# =============================================================================
# LayerNorm
# =============================================================================

def layernorm_supported(x) -> bool:
    d = x.shape[-1]
    if x.ndim < 2 or d % 8 or d > 8192:
        return False
    return x.dtype in (torch.bfloat16, torch.float32) or not x.is_cuda


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LN over the last dim, fp32 statistics; any leading shape; x.dtype out.
    scale/bias fp32 [D]."""
    if _needs_grad(x, scale, bias):
        return LayerNormFn.apply(x, scale, bias, eps)
    if not x.is_cuda:
        return layer_norm_ref(x, scale, bias, eps)
    d = x.shape[-1]
    dev = _check_cuda("layer_norm", {"x": x, "scale": scale, "bias": bias},
                      {"x": x.dtype, "scale": _F32, "bias": _F32})
    if not layernorm_supported(x):
        raise ValueError(f"layer_norm: unsupported shape/dtype "
                         f"{tuple(x.shape)} {x.dtype}")
    _check_shape("layer_norm", "scale", scale, (d,))
    _check_shape("layer_norm", "bias", bias, (d,))
    y = torch.empty_like(x)
    n = x.numel() // d
    rc = build.load().vitax_layer_norm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), n, d,
        eps, int(x.dtype == torch.bfloat16), _stream(dev))
    build.check(rc, "layer_norm")
    layer_norm.launches += 1
    return y


layer_norm.launches = 0


def layer_norm_bwd_ref(x, gamma, dy, eps):
    """(dx, dγ, dβ) of the row LN, statistics recomputed in fp32
    (pallas_kernels.py:281-304); dx in x.dtype, dγ/dβ fp32 [D]."""
    d = x.shape[-1]
    xhat, rstd = _ln_stats(x.reshape(-1, d).float(), eps)
    dx, dg, db = _ln_bwd_tail(dy.reshape(-1, d).float(), xhat, rstd, gamma)
    return dx.to(x.dtype).reshape(x.shape), dg, db


def layer_norm_bwd(x, gamma, dy, eps):
    """Backward of `layer_norm`: dx (x's shape and dtype), dγ and dβ (fp32
    [D]). x, dy: [..., D] of one dtype; gamma fp32 [D]."""
    if not x.is_cuda:
        return layer_norm_bwd_ref(x, gamma, dy, eps)
    d = x.shape[-1]
    dev = _check_cuda("layer_norm_bwd", {"x": x, "gamma": gamma, "dy": dy},
                      {"x": x.dtype, "gamma": _F32, "dy": x.dtype})
    if not layernorm_supported(x):
        raise ValueError(f"layer_norm_bwd: unsupported shape/dtype "
                         f"{tuple(x.shape)} {x.dtype}")
    _check_shape("layer_norm_bwd", "gamma", gamma, (d,))
    _check_shape("layer_norm_bwd", "dy", dy, tuple(x.shape))
    n = x.numel() // d
    lib = build.load()
    dx = torch.empty_like(x)
    dg = torch.empty(d, dtype=_F32, device=dev)
    db = torch.empty(d, dtype=_F32, device=dev)
    ws = _workspace(lib.vitax_layer_norm_bwd_ws(n, d), dev)
    rc = lib.vitax_layer_norm_bwd(
        x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dg.data_ptr(), db.data_ptr(), ws.data_ptr(), n, d, eps,
        int(x.dtype == torch.bfloat16), _stream(dev))
    build.check(rc, "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    return dx, dg, db


layer_norm_bwd.launches = 0


class LayerNormFn(torch.autograd.Function):
    """`layer_norm` with the LN backward kernel (the custom VJP of vitax's
    layer_norm, pallas_kernels.py:365-383): saves (x, γ)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        ctx.bias_dtype = bias.dtype
        return layer_norm(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dg, db = layer_norm_bwd(x, scale, dy.contiguous(), ctx.eps)
        return dx, dg.to(scale.dtype), db.to(ctx.bias_dtype), None


# =============================================================================
# K2 — fused LN2 + fc1 + GELU + fc2 + residual
# =============================================================================

def ln_mlp_supported(x, w1, w2) -> bool:
    if x.ndim != 3 or w1.ndim != 2 or w2.ndim != 2:
        return False
    d = x.shape[-1]
    m = w1.shape[1]
    if w1.shape[0] != d or tuple(w2.shape) != (m, d):
        return False
    if x.is_cuda and x.dtype != torch.bfloat16:
        return False
    # GEMM tiles: K a multiple of the 32-deep K tile, N of the 8-wide vector
    return d % 32 == 0 and m % 32 == 0


def _ln_mlp_twin(x, gamma, beta, w1, b1, w2, b2, eps, residual=True):
    """(out, a1, h1) of K2's twin (without `x +` when not residual)."""
    xn = layer_norm_ref(x, gamma, beta, eps)
    a1 = matmul_f32(xn, w1) + b1.float()
    h1 = gelu_exact(a1).to(x.dtype)
    y = (matmul_f32(h1, w2) + b2.float()).to(x.dtype)
    return (x + y if residual else y), a1, h1


def fused_ln_mlp_ref(x, gamma, beta, w1, b1, w2, b2, eps, residual=True):
    """x + bf16(fc2(bf16(GELU(fc1(bf16(LN(x))))))) with the TPU kernel's
    rounding points (pallas_kernels.py:603-615); without the `x +` when not
    residual (:614)."""
    return _ln_mlp_twin(x, gamma, beta, w1, b1, w2, b2, eps, residual)[0]


@functools.cache
def _notice(msg: str) -> None:
    """Prints `msg` once a process."""
    print(msg, flush=True)


def save_acts_fits(d: int) -> bool:
    """vitax's save-acts gate (fused_ln_mlp, pallas_kernels.py:2139-2147):
    off above MLP_MONO_MAX_D, where the MLP half keeps K2's recompute and its
    wide backward; says so once a process."""
    if d <= MLP_MONO_MAX_D:
        return True
    _notice(f"save-acts is off above d {MLP_MONO_MAX_D} (d {d}), as in vitax: "
            "the MLP half recomputes in its backward (fused_ln_mlp_bwd_wide)")
    return False


def fused_ln_mlp(x, gamma, beta, w1, b1, w2, b2, eps, save_acts=False,
                 residual=True):
    """out = x + fc2(GELU_exact(fc1(LN(x)))) for x [..., D]; x.dtype out.
    Weights bf16 [D,M], [M,D]; gamma/beta/b1/b2 fp32. Under autograd,
    `save_acts` takes K12's save pair (`FusedLnMlpSaveFn`) where
    `save_acts_fits`; a call that needs no grad is K2's forward, whose out
    the save forward reproduces bit for bit. `residual=False` is the
    kernels' branch without `x +` (`fused_ln_mlp_partial`, under
    `save_acts` K12's partial pair), which vitax's tensor-parallel MLP half
    runs per model shard (vitax's `fused_ln_mlp_tp` passes no save_acts)."""
    if _needs_grad(x, gamma, beta, w1, b1, w2, b2):
        if save_acts and save_acts_fits(x.shape[-1]):
            return FusedLnMlpSaveFn.apply(x, gamma, beta, w1, b1, w2, b2, eps,
                                          False, False, residual)
        return FusedLnMlpFn.apply(x, gamma, beta, w1, b1, w2, b2, eps, False,
                                  False, False, False, False, residual)
    if not residual:
        return fused_ln_mlp_partial(x, gamma, beta, w1, b1, w2, b2, eps)
    if not x.is_cuda:
        return fused_ln_mlp_ref(x, gamma, beta, w1, b1, w2, b2, eps)
    out = _ln_mlp_fwd_cuda("fused_ln_mlp", x, gamma, beta, w1, b1, w2, b2, eps,
                           True)
    fused_ln_mlp.launches += 1
    return out


fused_ln_mlp.launches = 0


def fused_ln_mlp_partial_ref(x, gamma, beta, w1, b1, w2, b2, eps):
    """bf16(fc2(bf16(GELU(fc1(bf16(LN(x)))))) + b2): K2's twin without the
    residual (pallas_kernels.py:614)."""
    return fused_ln_mlp_ref(x, gamma, beta, w1, b1, w2, b2, eps, False)


def fused_ln_mlp_partial(x, gamma, beta, w1, b1, w2, b2, eps):
    """K2's `residual=False` branch (csrc/ln_mlp.cu with residual 0): the
    MLP half's output without `x +`, a model shard's partial sum under
    tensor parallelism (vitax/parallel/tp_kernels.py:116-119, with b2 = 0).
    Counted apart from K2's residual launches. Shapes and dtypes as
    `fused_ln_mlp`'s."""
    if not x.is_cuda:
        return fused_ln_mlp_partial_ref(x, gamma, beta, w1, b1, w2, b2, eps)
    out = _ln_mlp_fwd_cuda("fused_ln_mlp_partial", x, gamma, beta, w1, b1, w2,
                           b2, eps, False)
    fused_ln_mlp_partial.launches += 1
    return out


fused_ln_mlp_partial.launches = 0


def _ln_mlp_fwd_cuda(name, x, gamma, beta, w1, b1, w2, b2, eps, residual):
    """K2's forward launch (ln_mlp.cu): LN, then fc1 and fc2 on
    gemm_sm90.cuh's wgmma GEMM."""
    dev = _check_cuda(
        name,
        {"x": x, "gamma": gamma, "beta": beta, "w1": w1, "b1": b1, "w2": w2,
         "b2": b2},
        {"x": _BF, "gamma": _F32, "beta": _F32, "w1": _BF, "b1": _F32,
         "w2": _BF, "b2": _F32})
    d = x.shape[-1]
    m = w1.shape[1]
    x2 = x.view(-1, d)
    if not ln_mlp_supported(x2.unsqueeze(0), w1, w2):
        raise ValueError(f"{name}: unsupported shapes x {tuple(x.shape)}"
                         f" w1 {tuple(w1.shape)} w2 {tuple(w2.shape)}")
    for key, t, k in (("gamma", gamma, d), ("beta", beta, d), ("b1", b1, m),
                      ("b2", b2, d)):
        _check_shape(name, key, t, (k,))
    n = x2.shape[0]
    xn = torch.empty_like(x2)
    h1 = torch.empty((n, m), dtype=_BF, device=dev)
    out = torch.empty_like(x2)
    rc = build.load().vitax_ln_mlp_fwd(
        x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), xn.data_ptr(),
        h1.data_ptr(), out.data_ptr(), n, d, m, eps, int(residual),
        _stream(dev))
    build.check(rc, name)
    return out.view(x.shape)


def fused_ln_mlp_bwd_ref(x, gamma, beta, w1, b1, w2, do, eps, residual=True):
    """(dx, dγ, dβ, dW1, db1, dW2, db2) of K2 with the TPU kernel's rounding
    points (pallas_kernels.py:1322-1372): dh1 = bf16(dh1f·gelu'(a1)), db1
    over the rounded dh1, dx = do + bf16(dx_ln) in x.dtype. Grads of the
    weights and vectors in fp32."""
    dt = x.dtype
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    do2 = do.reshape(-1, d)
    xhat, rstd = _ln_stats(x2.float(), eps)
    xn = (xhat * gamma.float() + beta.float()).to(dt)
    a1 = matmul_f32(xn, w1) + b1.float()
    h1 = gelu_exact(a1).to(dt)
    dh1 = (matmul_f32(do2, w2.t()) * gelu_exact_grad(a1)).to(dt)
    dw2 = matmul_f32(h1.t(), do2)
    db2 = do2.float().sum(dim=0)
    dw1 = matmul_f32(xn.t(), dh1)
    db1 = dh1.float().sum(dim=0)
    dxn = matmul_f32(dh1, w1.t())
    dxln, dg, dbe = _ln_bwd_tail(dxn, xhat, rstd, gamma)
    dx = do2 + dxln.to(dt) if residual else dxln.to(dt)
    return dx.reshape(x.shape), dg, dbe, dw1, db1, dw2, db2


def fused_ln_mlp_bwd(x, gamma, beta, w1, b1, w2, do, eps, residual=True):
    """Backward of `fused_ln_mlp`: dx (x's shape, bf16) and fp32 dγ, dβ
    [D], dW1 [D,M], db1 [M], dW2 [M,D], db2 [D]. residual=False is
    `fused_ln_mlp_partial_bwd` (the block without the residual add). Above
    MLP_MONO_MAX_D it is `fused_ln_mlp_bwd_wide`, vitax's route to its
    chunked kernel, for both."""
    if x.shape[-1] > MLP_MONO_MAX_D:
        return fused_ln_mlp_bwd_wide(x, gamma, beta, w1, b1, w2, do, eps,
                                     residual)
    if not residual:
        return fused_ln_mlp_partial_bwd(x, gamma, beta, w1, b1, w2, do, eps)
    if not x.is_cuda:
        return fused_ln_mlp_bwd_ref(x, gamma, beta, w1, b1, w2, do, eps)
    out = _ln_mlp_bwd_cuda("fused_ln_mlp_bwd", x, gamma, beta, w1, b1, w2, do,
                           eps, True)
    fused_ln_mlp_bwd.launches += 1
    return out


fused_ln_mlp_bwd.launches = 0


def fused_ln_mlp_partial_bwd_ref(x, gamma, beta, w1, b1, w2, do, eps):
    """K2's backward twin without the residual's dx (pallas_kernels.py:
    1367-1368 with residual=False)."""
    return fused_ln_mlp_bwd_ref(x, gamma, beta, w1, b1, w2, do, eps, False)


def fused_ln_mlp_partial_bwd(x, gamma, beta, w1, b1, w2, do, eps):
    """Backward of `fused_ln_mlp_partial` (ln_mlp_bwd.cu with residual 0):
    dx = bf16(dx_ln) without `do +`, the other grads as
    `fused_ln_mlp_bwd`'s. Counted apart from the residual launches."""
    if not x.is_cuda:
        return fused_ln_mlp_partial_bwd_ref(x, gamma, beta, w1, b1, w2, do,
                                            eps)
    out = _ln_mlp_bwd_cuda("fused_ln_mlp_partial_bwd", x, gamma, beta, w1, b1,
                           w2, do, eps, False)
    fused_ln_mlp_partial_bwd.launches += 1
    return out


fused_ln_mlp_partial_bwd.launches = 0


def fused_ln_mlp_bwd_wide_ref(x, gamma, beta, w1, b1, w2, do, eps,
                              residual=True):
    """The twin of `fused_ln_mlp_bwd_wide`: K2's backward twin. vitax's
    chunked kernel (pallas_kernels.py:1527-1607) computes the same grads,
    with dW1 and dW2 summed from bf16 partials of 512-row blocks; the port
    keeps one fp32 sum (ROADMAP, reference caveats)."""
    return fused_ln_mlp_bwd_ref(x, gamma, beta, w1, b1, w2, do, eps, residual)


def fused_ln_mlp_bwd_wide(x, gamma, beta, w1, b1, w2, do, eps, residual=True):
    """K2's backward at d > MLP_MONO_MAX_D, the port of vitax's
    `_ln_mlp_bwd_chunked_kernel` (:1527, pallas_call at :1610, taken by
    `_ln_mlp_2d_bwd` :1662-1665): the launch of ln_mlp_bwd.cu, whose fp32
    weight-grad sums need no chunking on the card, counted apart from the
    d <= 1024 route's. Outputs as `fused_ln_mlp_bwd`. residual=False is
    `fused_ln_mlp_bwd_wide_partial`."""
    if not residual:
        return fused_ln_mlp_bwd_wide_partial(x, gamma, beta, w1, b1, w2, do,
                                             eps)
    if not x.is_cuda:
        return fused_ln_mlp_bwd_wide_ref(x, gamma, beta, w1, b1, w2, do, eps)
    out = _ln_mlp_bwd_cuda("fused_ln_mlp_bwd_wide", x, gamma, beta, w1, b1,
                           w2, do, eps, True)
    fused_ln_mlp_bwd_wide.launches += 1
    return out


fused_ln_mlp_bwd_wide.launches = 0


def fused_ln_mlp_bwd_wide_partial(x, gamma, beta, w1, b1, w2, do, eps):
    """`fused_ln_mlp_bwd_wide` without the residual's dx, the
    `residual=False` branch of vitax's chunked kernel (:1589), which its
    tensor-parallel MLP half reaches per shard at d > 1024 (ViT-H/14 under
    `--n-model`): dx = bf16(dx_ln). Counted apart."""
    if not x.is_cuda:
        return fused_ln_mlp_bwd_wide_ref(x, gamma, beta, w1, b1, w2, do, eps,
                                         False)
    out = _ln_mlp_bwd_cuda("fused_ln_mlp_bwd_wide_partial", x, gamma, beta,
                           w1, b1, w2, do, eps, False)
    fused_ln_mlp_bwd_wide_partial.launches += 1
    return out


fused_ln_mlp_bwd_wide_partial.launches = 0


def _ln_mlp_bwd_cuda(name, x, gamma, beta, w1, b1, w2, do, eps, residual):
    """K2's backward launch (ln_mlp_bwd.cu)."""
    dev = _check_cuda(
        name,
        {"x": x, "gamma": gamma, "beta": beta, "w1": w1, "b1": b1, "w2": w2,
         "do": do},
        {"x": _BF, "gamma": _F32, "beta": _F32, "w1": _BF, "b1": _F32,
         "w2": _BF, "do": _BF})
    d = x.shape[-1]
    m = w1.shape[1]
    x2 = x.view(-1, d)
    if not ln_mlp_supported(x2.unsqueeze(0), w1, w2):
        raise ValueError(f"{name}: unsupported shapes x {tuple(x.shape)} w1 "
                         f"{tuple(w1.shape)} w2 {tuple(w2.shape)}")
    for key, t, k in (("gamma", gamma, d), ("beta", beta, d), ("b1", b1, m)):
        _check_shape(name, key, t, (k,))
    _check_shape(name, "do", do, tuple(x.shape))
    n = x2.shape[0]
    lib = build.load()
    dx, dg, dbe = _bf(dev, n, d), _f32(dev, d), _f32(dev, d)
    dw1, db1, dw2, db2 = (_f32(dev, d, m), _f32(dev, m), _f32(dev, m, d),
                          _f32(dev, d))
    xn, h1, dh1 = _bf(dev, n, d), _bf(dev, n, m), _bf(dev, n, m)
    dxn = _f32(dev, n, d)
    ws = _workspace(lib.vitax_ln_mlp_bwd_ws(n, d, m), dev)
    rc = lib.vitax_ln_mlp_bwd(*(t.data_ptr() for t in (
        x2, gamma, beta, w1, b1, w2, do, dx, dg, dbe, dw1, db1, dw2, db2, xn,
        h1, dh1, dxn, ws)), n, d, m, eps, int(residual), _stream(dev))
    build.check(rc, name)
    return dx.view(x.shape), dg, dbe, dw1, db1, dw2, db2


GEMM_SM90_KINDS = ("nn_bias", "nt_store", "nt_f32", "tn_f32", "gelu_pair",
                   "nn_bias_gelu", "nn_bias_gelu_save", "nn_bias_residual")
_GEMM_SM90_BIAS = ("nn_bias", "gelu_pair", "nn_bias_gelu",
                   "nn_bias_gelu_save", "nn_bias_residual")


def gemm_sm90_ref(kind, a, b, bias=None, a2=None, b2=None, residual=None):
    """The plain twin of `gemm_sm90`: fp32 products of the bf16 operands and
    the epilogue in fp32, rounded to bf16 where the kernel rounds."""
    if kind in ("nn_bias", "nn_bias_residual"):
        y = (matmul_f32(a, b) + bias.float()).to(_BF)
        return y if kind == "nn_bias" else residual + y
    if kind in ("nn_bias_gelu", "nn_bias_gelu_save"):
        pre = matmul_f32(a, b) + bias.float()
        h = gelu_exact(pre).to(_BF)
        if kind == "nn_bias_gelu":
            return h
        return h, gelu_exact_grad(pre).to(_BF)
    if kind == "nt_store":
        return matmul_f32(a, b.t()).to(_BF)
    if kind == "nt_f32":
        return matmul_f32(a, b.t())
    if kind == "tn_f32":
        return matmul_f32(a.t(), b)
    if kind == "gelu_pair":
        pre = matmul_f32(a, b) + bias.float()
        return (gelu_exact(pre).to(_BF),
                (matmul_f32(a2, b2.t()) * gelu_exact_grad(pre)).to(_BF))
    raise ValueError(f"gemm_sm90: unknown kind {kind!r}")


def gemm_sm90(kind, a, b, bias=None, a2=None, b2=None, residual=None):
    """One product of gemm_sm90.cuh, the wgmma GEMM inside K1's and K2's
    forwards and backwards and K12's forward, launched alone
    (csrc/gemm_sm90.cu) so that the card tests hold each layout and
    epilogue against fp32 products; no path of the port calls it. kind:
    "nn_bias" bf16(a[m,k]·b[k,n] + bias), "nt_store" bf16(a·b[n,k]ᵀ),
    "nt_f32" a·b[n,k]ᵀ in fp32, "tn_f32" a[k,m]ᵀ·b[k,n] in fp32 (split over
    k), "gelu_pair" (bf16(gelu(pre)), bf16((a2·b2ᵀ)·gelu'(pre))) with pre =
    a·b + bias (K2's dual product); the forwards' epilogues on pre:
    "nn_bias_gelu" bf16(gelu(pre)) (fc1), "nn_bias_gelu_save" (that,
    bf16(gelu'(pre))) (K12's fc1), "nn_bias_residual" residual [m, n] +
    bf16(pre) in bf16 (fc2)."""
    if not a.is_cuda:
        return gemm_sm90_ref(kind, a, b, bias, a2, b2, residual)
    name = "gemm_sm90"
    if kind not in GEMM_SM90_KINDS:
        raise ValueError(f"{name}: unknown kind {kind!r}")
    mats = {"a": a, "b": b, **({"a2": a2, "b2": b2} if kind == "gelu_pair"
                               else {}),
            **({"residual": residual} if kind == "nn_bias_residual" else {})}
    vecs = {"bias": bias} if kind in _GEMM_SM90_BIAS else {}
    dev = _check_cuda(name, {**mats, **vecs},
                      {**dict.fromkeys(mats, _BF), **dict.fromkeys(vecs, _F32)})
    if kind == "tn_f32":
        k, m = a.shape
        n = b.shape[1]
        _check_shape(name, "b", b, (k, n))
    else:
        m, k = a.shape
        n = b.shape[0] if kind.startswith("nt") else b.shape[1]
        _check_shape(name, "b", b, (n, k) if kind.startswith("nt") else (k, n))
    if kind == "gelu_pair":
        _check_shape(name, "a2", a2, (m, k))
        _check_shape(name, "b2", b2, (n, k))
    if kind == "nn_bias_residual":  # the C entry point takes it as a2
        _check_shape(name, "residual", residual, (m, n))
        a2 = residual
    if vecs:
        _check_shape(name, "bias", bias, (n,))
    lib = build.load()
    c, c2 = _bf(dev, m, n), _bf(dev, m, n)
    f = _f32(dev, m, n)
    ws = _workspace(lib.vitax_gemm_sm90_ws(m, n, k), dev)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    rc = lib.vitax_gemm_sm90(ptr(a), ptr(b), ptr(bias), ptr(a2), ptr(b2),
                             c.data_ptr(), c2.data_ptr(), f.data_ptr(),
                             ws.data_ptr(), m, n, k,
                             GEMM_SM90_KINDS.index(kind), _stream(dev))
    build.check(rc, name)
    if kind in ("gelu_pair", "nn_bias_gelu_save"):
        return c, c2
    return f if kind.endswith("f32") else c


GEMM_SM90_S8_KINDS = ("s8_bf16", "s8_f32", "s8_gelu_pair", "s8_group",
                      "s8_gelu_q_f32", "s8_residual", "s8_residual_f32",
                      "s8_group_rc")


def s8_launch_counts(reset: bool = False) -> dict:
    """The s8 products of gemm_sm90.cuh launched since the last reset, by
    kind, as the library counts them where it launches one (`launch_s8`):
    inside K3's forward (kv_heads == heads) two s8_bf16 (qkv, out), inside
    K4's one s8_gelu_q_f32 (fc1) and one s8_residual (fc2; s8_bf16 without
    the residual), inside K3's and K7's backwards two s8_bf16 (qkv, dattn)
    and one s8_f32 (dxn), inside K4's one s8_gelu_pair and one s8_f32, and
    under int8_dw two s8_group in each backward; inside K11-C's and G-F's
    forwards two s8_bf16, inside K11-D's and G-B's backwards two s8_bf16 and
    one s8_f32, and under int8_dw two s8_group_rc; inside K5's attention half one
    s8_bf16 (qkv) and one s8_residual_f32 (the out-projection), inside its
    MLP half one s8_gelu_q_f32 (fc1) and one s8_residual_f32 (fc2), inside
    K8's int8 forward three s8_bf16 (q, kv, out), inside its backward three
    s8_bf16 (q, kv, dattn) and two s8_f32 (dxnc, dxn), and under int8_dw
    three s8_group, besides `gemm_sm90_s8`'s own.
    `launch_counts` keys the wrappers. Nothing is counted before the
    library is loaded: no product has launched then."""
    counts = (ctypes.c_longlong * len(GEMM_SM90_S8_KINDS))()
    if build.loaded():
        build.check(build.load().vitax_gemm_sm90_s8_launches(counts,
                                                             int(reset)),
                    "s8_launch_counts")
    return {f"gemm_sm90_s8:{k}": v
            for k, v in zip(GEMM_SM90_S8_KINDS, counts)}


FIRST_DESIGN_PIECES = ("gemm.cuh:s8", "attention.cuh:core",
                       "attention_bwd.cuh:core", "gemm.cuh:bf16")


def first_design_launch_counts(reset: bool = False) -> dict:
    """Launches since the last reset of four first-design pieces, as the
    library counts them where each launches: gemm.cuh's mma.sync s8
    products ("gemm.cuh:s8": K7's int8 forward, K11-A, R-F, K12-int8),
    attention.cuh's whole-row forward core ("attention.cuh:core": K7,
    R-F), attention_bwd.cuh's whole-row backward core
    ("attention_bwd.cuh:core": K7's bf16 backward) and gemm.cuh's bf16
    WMMA products ("gemm.cuh:bf16": K7, K12's backwards). LN, K1, K2,
    K12's forward, K13, K6, K3's and K4's forwards and backwards, K7's int8
    backwards, K11-B, K11-C/D and G-F/G-B, K5's halves, K8 in its bf16 and
    int8 tiers, R-B and, since they run pieces of K1's Hopper sequence, K9
    and K10 launch none of them. Nothing is counted before the library is
    loaded."""
    counts = (ctypes.c_longlong * len(FIRST_DESIGN_PIECES))()
    if build.loaded():
        build.check(build.load().vitax_first_design_launches(counts,
                                                             int(reset)),
                    "first_design_launch_counts")
    return dict(zip(FIRST_DESIGN_PIECES, counts))


def gemm_sm90_s8_ref(kind, a, b, sr, sc=None, bias=None, a2=None, b2=None,
                     sr2=None, sc2=None, group=None, residual=None):
    """The plain twin of `gemm_sm90_s8`: exact int32 products (`int_mm`)
    dequantized in the kernels' order (`_dequant`), the GELU pair's
    epilogue as K4's backward twin writes it, fc1's and fc2's as K4's
    forward twin (gelu_q in fp32; residual + bf16(y) in bf16), the
    handoff's as K5's twins (f32(residual) + y in fp32, rounded once), and
    the group fold as `_dw_int8` adds it: over each group of `group` columns
    of K, in order, F += f32(acc)·sr[z, m], and the two-scale fold as
    `_dw_int8_cols` adds it, F += (f32(acc)·sr[z, m])·sc[z, n]."""
    if kind in ("s8_group", "s8_group_rc"):
        f = torch.zeros((a.shape[0], b.shape[0]), dtype=_F32, device=a.device)
        for z, k0 in enumerate(range(0, a.shape[1], group)):
            cols = slice(k0, k0 + group)
            t = int_mm(a[:, cols], b[:, cols].t()) * sr[z].reshape(-1, 1)
            f = f + (t * sc[z] if kind == "s8_group_rc" else t)
        return f
    y = _dequant(int_mm(a, b.t()), sr.reshape(-1, 1), sc, bias)
    if kind == "s8_bf16":
        return y.to(_BF)
    if kind == "s8_f32":
        return y
    if kind == "s8_gelu_q_f32":
        return gelu_q(y)
    if kind == "s8_residual":
        return residual + y.to(_BF)
    if kind == "s8_residual_f32":
        return (residual.float() + y).to(_BF)
    if kind == "s8_gelu_pair":
        dh1_32 = (_dequant(int_mm(a2, b2.t()), sr2.reshape(-1, 1), sc2)
                  * gelu_grad_q(y))
        return gelu_q(y).to(_BF), dh1_32.to(_BF), dh1_32
    raise ValueError(f"gemm_sm90_s8: unknown kind {kind!r}")


def gemm_sm90_s8_inputs(kind, m, n, k, extra, seed=0, device="cuda"):
    """Keyword arguments of `gemm_sm90_s8` for one product, drawn from a
    seed: int8 codes in [-127, 127] and fp32 scales, with a bias when
    `extra` is True; for "s8_group" and "s8_group_rc" `extra` is the
    group's columns, and each group's codes are zero past 25/32 of its rows,
    as dw_int8.cuh pads them ("s8_group_rc" has column scales of its own a
    group, sc [groups, n]); "s8_residual" and "s8_residual_f32" get a bf16
    residual [m, n]."""
    g = torch.Generator(device=device).manual_seed(seed)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=device,
                             dtype=torch.int8)

    def scales(*shape):
        return torch.rand(shape, generator=g, device=device) * 1e-3 + 1e-5

    if kind in ("s8_group", "s8_group_rc"):
        a, b = codes(m, k), codes(n, k)
        rows = extra * 25 // 32
        for z0 in range(0, k, extra):
            a[:, z0 + rows:z0 + extra] = 0
            b[:, z0 + rows:z0 + extra] = 0
        out = dict(a=a, b=b, sr=scales(k // extra, m), group=extra)
        if kind == "s8_group_rc":
            out["sc"] = scales(k // extra, n)
        return out
    out = dict(a=codes(m, k), b=codes(n, k), sr=scales(m), sc=scales(n))
    if extra:
        out["bias"] = torch.randn(n, generator=g, device=device) * 0.1
    if kind in ("s8_residual", "s8_residual_f32"):
        out["residual"] = torch.randn(m, n, generator=g, device=device).to(_BF)
    if kind == "s8_gelu_pair":
        out.update(a2=codes(m, k), b2=codes(n, k), sr2=scales(m),
                   sc2=scales(n))
    return out


# (kind, m, n, k, bias or the group's columns) of the card checks of
# `gemm_sm90_s8` (tests/test_torch_cuda_kernels.py and chip_smoke.py): the
# first of each kind at its ViT-B/16 b32 spq 200 shape (K3's qkv, K3's dxn,
# K4's dual product, K4's int8_dw dW1 over 50 groups of 128 rows, K4's
# forward fc1 and fc2; the handoff's fc2 at the drop phase's b32 spq 104),
# then ragged M, N and K, K3's dWqkv fold (16 groups of 400 rows in 512),
# K5's out-projection, and tiny ones; the two-scale fold at K11-D's b32 dWo
# (16 groups of 400 rows in 512), its dWqkv, and ragged ones
GEMM_SM90_S8_CASES = [
    ("s8_bf16", 6400, 2304, 768, True), ("s8_f32", 6400, 768, 2304, False),
    ("s8_gelu_pair", 6400, 3072, 768, True),
    ("s8_group", 768, 3072, 50 * 128, 128),
    ("s8_gelu_q_f32", 6400, 3072, 768, True),
    ("s8_residual", 6400, 768, 3072, True),
    ("s8_bf16", 6400, 768, 768, False), ("s8_bf16", 3328, 768, 768, False),
    ("s8_bf16", 199, 136, 784, True), ("s8_f32", 1, 768, 3072, False),
    ("s8_f32", 3328, 776, 2320, True), ("s8_f32", 591, 776, 2320, True),
    ("s8_gelu_pair", 591, 3072, 768, True),
    ("s8_gelu_pair", 77, 264, 144, True),
    ("s8_group", 768, 2304, 16 * 512, 512),
    ("s8_group", 3072, 768, 5 * 128, 128),
    ("s8_group", 100, 24, 3 * 256, 256),
    ("s8_gelu_q_f32", 591, 3072, 768, True),
    ("s8_gelu_q_f32", 77, 264, 144, True),
    ("s8_residual", 591, 776, 3072, True),
    ("s8_residual", 77, 136, 144, True),
    ("s8_residual_f32", 3328, 768, 3072, True),
    ("s8_residual_f32", 3328, 768, 768, True),
    ("s8_residual_f32", 591, 776, 3072, True),
    ("s8_residual_f32", 77, 136, 144, True),
    ("s8_group_rc", 768, 768, 16 * 512, 512),
    ("s8_group_rc", 768, 2304, 16 * 512, 512),
    ("s8_group_rc", 100, 24, 3 * 256, 256)]


def gemm_sm90_s8(kind, a, b, sr, sc=None, bias=None, a2=None, b2=None,
                 sr2=None, sc2=None, group=None, residual=None):
    """One s8 product of gemm_sm90.cuh, the int8 wgmma path inside K3's and
    K4's int8 forwards and backwards, launched alone (csrc/gemm_sm90_s8.cu)
    so that the card tests hold each epilogue against exact integer
    products; no path of the port calls it. a [m, k] and b [n, k] int8 codes, k % 16 == 0,
    n % 8 == 0; sr [m], sc [n] fp32 scales. kind: "s8_bf16"
    bf16(f32(a·bᵀ)·sr·sc (+ bias)), "s8_f32" the same in fp32,
    "s8_gelu_pair" (h1, dh1, dh1_32) of K4's dual product with pre =
    f32(a·bᵀ)·sr·sc + bias and the second product a2 [m, k], b2 [n, k] with
    sr2, sc2 (bf16(gelu_q(pre)), bf16(dh1_32), dh1_32 =
    f32(a2·b2ᵀ)·sr2·sc2·gelu_q'(pre)), "s8_group" the int8_dw fold over
    groups of `group` columns of k (group % 128 == 0), sr [k / group, m],
    "s8_group_rc" the int4_grad backwards' fold with sc [k / group, n] too,
    "s8_gelu_q_f32" K4's fc1, gelu_q(f32(a·bᵀ)·sr·sc + bias) in fp32,
    "s8_residual" K4's fc2, bf16(residual + bf16(f32(a·bᵀ)·sr·sc + bias))
    with residual [m, n] bf16, "s8_residual_f32" K5's out-projection and
    fc2, bf16(f32(residual) + (f32(a·bᵀ)·sr·sc + bias))."""
    if not a.is_cuda:
        return gemm_sm90_s8_ref(kind, a, b, sr, sc, bias, a2, b2, sr2, sc2,
                                group, residual)
    name = "gemm_sm90_s8"
    if kind not in GEMM_SM90_S8_KINDS:
        raise ValueError(f"{name}: unknown kind {kind!r}")
    m, k = a.shape
    n = b.shape[0]
    mats = {"a": a, "b": b, **({"a2": a2, "b2": b2}
                               if kind == "s8_gelu_pair" else {})}
    residual_kind = kind in ("s8_residual", "s8_residual_f32")
    if residual_kind:
        _check_cuda(name, {"residual": residual}, {"residual": _BF})
        _check_shape(name, "residual", residual, (m, n))
    vecs = {"sr": sr, **({"sc": sc} if kind != "s8_group" else {}),
            **({"bias": bias} if bias is not None else {}),
            **({"sr2": sr2, "sc2": sc2} if kind == "s8_gelu_pair" else {})}
    dev = _check_cuda(name, {**mats, **vecs},
                      {**dict.fromkeys(mats, torch.int8),
                       **dict.fromkeys(vecs, _F32)})
    for key, t in mats.items():
        _check_shape(name, key, t, (n if key.startswith("b") else m, k))
    if kind in ("s8_group", "s8_group_rc"):
        if not group or k % group:
            raise ValueError(f"{name}: k {k} is not whole groups of {group}")
        _check_shape(name, "sr", sr, (k // group, m))
        if kind == "s8_group_rc":
            _check_shape(name, "sc", sc, (k // group, n))
    else:
        for key, t in vecs.items():
            _check_shape(name, key, t, (m,) if key.startswith("sr") else (n,))
    lib = build.load()
    pair = kind == "s8_gelu_pair"  # only the outputs the kind writes
    bf16_out = pair or residual_kind or kind == "s8_bf16"
    c = _bf(dev, m, n) if bf16_out else None
    c2 = _bf(dev, m, n) if pair else None
    f = _f32(dev, m, n) if pair or not bf16_out else None

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    rc = lib.vitax_gemm_sm90_s8(ptr(a), ptr(b), ptr(a2), ptr(b2), ptr(sr),
                                ptr(sc), ptr(bias), ptr(sr2), ptr(sc2),
                                ptr(residual), ptr(c), ptr(c2), ptr(f), m, n,
                                k, group or 0, GEMM_SM90_S8_KINDS.index(kind),
                                _stream(dev))
    build.check(rc, name)
    if pair:
        return c, c2, f
    return c if bf16_out else f


class FusedLnMlpFn(torch.autograd.Function):
    """The fused MLP half with its backward kernel, saving (x, γ, β, W1, b1,
    W2), as vitax's custom VJPs: `int8` picks the W8A8 forward (K4) and
    `int8_grad` the W8A8 dx-path backward (K4 bwd, _ln_mlp_2d_int8g
    :1845-1865), with `int8_dw` its per-group int8 weight grads; `int8`
    alone keeps the bf16 backward of the bf16 function (_ln_mlp_2d_int8
    :1779-1801), as does the bf16 tier (_ln_mlp_2d :1652-1673). `int4`
    picks the A4W4 forward (K11-A) and `int4_grad` the A4W4 dx-path
    backward (K11-B) ahead of `int8_grad` (_ln_mlp_2d_int4 :1939-1974).
    `residual=False` picks each kernel's branch without `x +` (and without
    `do +` in dx), the `*_partial` wrappers: vitax's tensor-parallel MLP
    half per model shard."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, eps, int8, int8_grad,
                int8_dw, int4=False, int4_grad=False, residual=True):
        ctx.save_for_backward(x, gamma, beta, w1, b1, w2)
        ctx.eps = eps
        ctx.tier = (int4 and int4_grad, int8 and int8_grad, int8_dw)
        ctx.residual = residual
        ctx.b2_dtype = b2.dtype
        fwd = (fused_ln_mlp_int4 if int4 else fused_ln_mlp_int8 if int8
               else fused_ln_mlp)
        return fwd(x, gamma, beta, w1, b1, w2, b2, eps, residual=residual)

    @staticmethod
    def backward(ctx, do):
        x, gamma, beta, w1, b1, w2 = ctx.saved_tensors
        int4_grad, int8_grad, int8_dw = ctx.tier
        args = (x, gamma, beta, w1, b1, w2, do.contiguous(), ctx.eps)
        if int4_grad:
            bwd = (fused_ln_mlp_int4_dw_bwd if int8_dw
                   else fused_ln_mlp_int4_bwd)
        elif int8_grad:
            bwd = (fused_ln_mlp_int8_dw_bwd if int8_dw
                   else fused_ln_mlp_int8_bwd)
        else:
            bwd = fused_ln_mlp_bwd
        dx, dg, dbe, dw1, db1, dw2, db2 = bwd(*args, residual=ctx.residual)
        return (dx, dg.to(gamma.dtype), dbe.to(beta.dtype), dw1.to(w1.dtype),
                db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(ctx.b2_dtype),
                None, None, None, None, None, None, None)


# =============================================================================
# K1 — fused LN1 + QKV + attention core + out-projection
# =============================================================================

def attention_smem_bytes(spq: int, head_dim: int, warps: int = 1) -> int:
    """Shared memory of one forward attention-core block (attention.cuh)."""
    rows = (spq + 15) // 16 * 16
    sw = max(rows, head_dim)
    return (2 * rows * head_dim * 2
            + warps * (16 * head_dim * 2 + 16 * sw * 4 + 16 * rows * 2))


def attention_bwd_smem_bytes(spq: int, head_dim: int, warps: int = 1) -> int:
    """Shared memory of one query-tile block of the attention-core backward
    (ln_qkvo_attention_bwd.cu: attn_bwd_smem_bytes)."""
    rows = (spq + 15) // 16 * 16
    sw = max(rows, head_dim)
    per_warp = (2 * 16 * head_dim * 2 + 16 * sw * 4 + 16 * rows * 2
                + 16 * 16 * 4 + 16 * 4)
    return 2 * rows * head_dim * 2 + warps * per_warp


def _head_dim(x, wqkv, heads, kv_heads=None):
    """Hd of the packed [q (H·Hd) | k (Hkv·Hd) | v (Hkv·Hd)] wqkv [D, W] for
    x [B, S, D] (Hkv = kv_heads, default heads), or None where the shapes
    are not such a layout or heads % kv_heads != 0 (query heads that would
    not split evenly into kv groups)."""
    if x.ndim != 3 or wqkv.ndim != 2:
        return None
    kv_heads = kv_heads or heads
    if kv_heads <= 0 or heads % kv_heads:
        return None
    if wqkv.shape[0] != x.shape[2] or wqkv.shape[1] % (heads + 2 * kv_heads):
        return None
    return wqkv.shape[1] // (heads + 2 * kv_heads)


def qkv_attention_supported(x, wqkv, heads, kv_heads=None) -> bool:
    """Gate of the fused attention half, K1's family (K1, K7, K3, K11-C, K5,
    and K8's key side), in eval and in training: x [B, S, D] (S padded to
    spq = round_up(S, 8) by the caller), merged wqkv [D, (H + 2·Hkv)·Hd]
    with Hkv = kv_heads (default heads), bf16 on the card. It takes what
    the Hopper halves take (K1 and K3, forward and backward, with
    kv_heads == heads, K7's int8 backward and K5's attention half):
    `_k13_shapes_fit`, K13's core and gemm_sm90.cuh's products. The models
    pick the half where this and vitax's gate pass, in eval and in training
    alike (K13's backward passes take what its forward takes), and so does
    K8 in its bf16 and int8 tiers, on K13's core in its rect geometry, and
    so do K11-C/D and G-F/G-B, K3's sequences at L = 7; K9, K1's sequence
    without its LN, and K10, its first launches, take the same shapes
    (`fused_qkvo_attention_supported`, `fused_qkv_attention_supported`).
    A first-design path (the whole-row core: K7's bf16 pair and int8
    forward, R-F) checks its own limits in its wrapper and raises by
    name outside them. Unlike vitax's gate
    (pallas_kernels.py:2189-2193) it rejects heads % kv_heads != 0."""
    if x.ndim == 3 and x.is_cuda and x.dtype != torch.bfloat16:
        return False
    return _k13_shapes_fit(x, wqkv, heads, kv_heads)


def _k13_shapes_fit(x, wqkv, heads, kv_heads=None) -> bool:
    """The shapes of the Hopper attention halves, any dtype: K13's core (S
    <= 1024, a head dim of VITAX_K13_HEAD_DIMS, at most 65535 images) and
    gemm_sm90.cuh's products (N % 8, K % 16: d % 16, Hd % 16)."""
    hd = _head_dim(x, wqkv, heads, kv_heads)
    if hd is None:
        return False
    b, s, d = x.shape
    return (s <= K13_MAX_SEQ and hd in K13_HEAD_DIMS and d % 16 == 0
            and b <= K13_MAX_IMAGES)


def _core_fits(x, wqkv, heads, kv_heads=None, backward=False) -> bool:
    """The shapes the first design takes, any dtype: attention.cuh's
    whole-row core (head dims ATTN_HEAD_DIMS, its shared memory and, with
    `backward`, its backward's) and gemm.cuh's products (widths a multiple
    of 32). K7 (kv_heads < heads: its bf16 pair and int8 forward) and R-F
    run it."""
    hd = _head_dim(x, wqkv, heads, kv_heads)
    if hd is None:
        return False
    d = x.shape[2]
    spq = (x.shape[1] + 7) // 8 * 8
    return (hd in ATTN_HEAD_DIMS and d % 32 == 0 and heads * hd % 32 == 0
            and attention_smem_bytes(spq, hd) <= SMEM_LIMIT
            and (not backward
                 or attention_bwd_smem_bytes(spq, hd) <= SMEM_LIMIT))


FIRST_DESIGN_ITEM = ('ROADMAP Queue 2, "the first-design attention paths onto '
                     "K13's core\"")


def _check_first_design(name, path, x, wqkv, heads, kv_heads=None,
                        backward=False):
    """Raises where a path on the first design's whole-row core (`path`,
    e.g. "K7") is asked for shapes its core cannot take though the K1
    family's gate, and vitax's, take them: it never launches outside its
    limits and never falls back to another kernel."""
    if not _core_fits(x, wqkv, heads, kv_heads, backward):
        hd = _head_dim(x, wqkv, heads, kv_heads)
        raise NotImplementedError(
            f"{name}: {path} keeps the first design's whole-row attention "
            f"core (attention.cuh), which does not take x {tuple(x.shape)} "
            f"with head_dim {hd} (head dims {ATTN_HEAD_DIMS} and the "
            f"{'backward' if backward else 'forward'} core's shared memory "
            f"at spq); K1, K3, K9 and K10 with kv_heads == heads run K13's "
            f"core there; "
            f"{FIRST_DESIGN_ITEM}")


def _split_heads(t, heads):
    """[B, S, H·Hd] → [B, H, S, Hd]."""
    b, s, w = t.shape
    return t.reshape(b, s, heads, w // heads).transpose(1, 2)


def _softmax_pv(q, k, v, seq_len):
    """q [B,H,Sq,Hd] over keys k, v [B,H,Sk,Hd]: fp32 softmax p of q·kᵀ/√Hd
    (key cols ≥ seq_len exactly 0) and the fp32 head outputs p·v, as
    _attn_core_recompute (pallas_kernels.py:2814-2843) and
    _rect_core_recompute (:3949-3974) before their casts."""
    spq = k.shape[-2]
    s = matmul_f32(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if seq_len < spq:
        col = torch.arange(spq, device=q.device)
        s = torch.where(col < seq_len, s, torch.full_like(s, -1e30))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))
    return p, matmul_f32(p.to(v.dtype), v)


def _attn_core(qkv, seq_len, heads, head_dim, kv_heads=None):
    """qkv [B, spq, (H + 2·Hkv)·Hd] → per-head q, k, v [B,H,spq,Hd] (k and v
    of query head h from kv group h·Hkv/H, vitax's _kv_off :2803), fp32
    softmax p and the fp32 head outputs p·v."""
    kv_heads = kv_heads or heads
    hhd, kvw = heads * head_dim, kv_heads * head_dim
    q = _split_heads(qkv[..., :hhd], heads)
    k, v = (_split_heads(qkv[..., hhd + i * kvw:hhd + (i + 1) * kvw], kv_heads)
            .repeat_interleave(heads // kv_heads, dim=1) for i in range(2))
    p, o32 = _softmax_pv(q, k, v, seq_len)
    return q, k, v, p, o32


def _qkvo_core(xn, wqkv, bqkv, seq_len, heads, head_dim, kv_heads=None):
    """xn → qkv → the attention core with bf16 head outputs o."""
    qkv = (matmul_f32(xn, wqkv) + bqkv.float()).to(xn.dtype)
    q, k, v, p, o32 = _attn_core(qkv, seq_len, heads, head_dim, kv_heads)
    return q, k, v, p, o32.to(xn.dtype)


def _group_sum(t32, kv_heads):
    """[B, H, S, Hd] fp32 per-query-head grads → [B, Hkv, S, Hd]: each kv
    group's H/Hkv heads summed in head order (vitax's GQA transpose of
    repeat_kv, :2884-2894); the identity without GQA."""
    b, h, s, hd = t32.shape
    if not kv_heads or kv_heads == h:
        return t32
    t = t32.view(b, kv_heads, h // kv_heads, s, hd)
    acc = t[:, :, 0]
    for r in range(1, h // kv_heads):
        acc = acc + t[:, :, r]
    return acc


def _core_grads(q, k, v, p, o, dattn, scale, kv_heads=None):
    """(dq [B,H,Sq,Hd], dk, dv [B,Hkv,Sk,Hd]) of the attention core with the
    TPU rounding points (_attn_core_grads, pallas_kernels.py:2846-2895, and
    _rect_core_grads :3977-4022): ds, dq, dk, dv in the compute dtype, dk
    and dv of a kv group one fp32 sum over its query heads before the cast.
    q [B,H,Sq,Hd] over keys k, v [B,H,Sk,Hd] (repeated per query head with
    GQA), dattn [B·Sq, H·Hd]."""
    dt = q.dtype
    b, h, sq, hd = q.shape
    d_o = dattn.view(b, sq, h, hd).transpose(1, 2)
    dp = matmul_f32(d_o, v.transpose(-1, -2))
    dd = (d_o.float() * o.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - dd)).to(dt)
    dq = (matmul_f32(ds, k) * scale).to(dt)
    dk = _group_sum(matmul_f32(ds.transpose(-1, -2), q) * scale, kv_heads)
    dv = _group_sum(matmul_f32(p.to(dt).transpose(-1, -2), d_o), kv_heads)
    return dq, dk.to(dt), dv.to(dt)


def _attn_core_grads(q, k, v, p, o, dattn, scale, kv_heads=None):
    """dqkv [B·spq, (H + 2·Hkv)·Hd] of the square attention core, the packed
    [dq | dk | dv] rows."""
    return torch.cat([_heads_to_rows(t) for t in
                      _core_grads(q, k, v, p, o, dattn, scale, kv_heads)],
                     dim=1)


def _heads_to_rows(t):
    """[B, H, spq, Hd] → [B·spq, H·Hd], heads side by side."""
    b, h, spq, hd = t.shape
    return t.transpose(1, 2).reshape(b * spq, h * hd)


def fused_ln_qkvo_attention_ref(x, gamma, beta, wqkv, bqkv, wo, bo, eps,
                                seq_len, heads, head_dim, kv_heads=None):
    """LN1 → qkv → per-head softmax(qkᵀ/√hd, cols ≥ seq_len masked)·v →
    out-projection, with the TPU kernel's rounding points
    (pallas_kernels.py:2646-2686). x [B, spq, D] → [B, spq, D], no residual.
    kv_heads < heads: the packed GQA layout (K7's twin)."""
    b, spq, d = x.shape
    xn = layer_norm_ref(x, gamma, beta, eps)
    *_, o = _qkvo_core(xn, wqkv, bqkv, seq_len, heads, head_dim, kv_heads)
    attn = _heads_to_rows(o)
    return (matmul_f32(attn, wo) + bo.float()).to(x.dtype).view(b, spq, d)


def _gqa(heads, kv_heads) -> bool:
    return kv_heads is not None and kv_heads != heads


def fused_ln_qkvo_attention(x, gamma, beta, wqkv, bqkv, wo, bo, eps, seq_len,
                            heads, head_dim, kv_heads=None):
    """LN + QKV projection + attention core + out-projection, forward.
    x [B, spq, D] bf16 (pad rows past seq_len allowed), wqkv [D, 3·H·Hd]
    columns [q heads | k heads | v heads], wo [H·Hd, D] bf16; gamma, beta,
    bqkv, bo fp32. Returns [B, spq, D] without the residual. kv_heads <
    heads: GQA, `fused_ln_qkvo_attention_gqa` (K7)."""
    if _gqa(heads, kv_heads):
        return fused_ln_qkvo_attention_gqa(x, gamma, beta, wqkv, bqkv, wo, bo,
                                           eps, seq_len, heads, head_dim,
                                           kv_heads)
    if _needs_grad(x, gamma, beta, wqkv, bqkv, wo, bo):
        return FusedLnQkvoAttentionFn.apply(x, gamma, beta, wqkv, bqkv, wo, bo,
                                            eps, seq_len, heads, head_dim,
                                            False, False, False, None)
    if not x.is_cuda:
        return fused_ln_qkvo_attention_ref(x, gamma, beta, wqkv, bqkv, wo, bo,
                                           eps, seq_len, heads, head_dim)
    out = _ln_qkvo_cuda("fused_ln_qkvo_attention", x, gamma, beta, wqkv, bqkv,
                        wo, bo, eps, seq_len, heads, head_dim, heads)
    fused_ln_qkvo_attention.launches += 1
    return out


fused_ln_qkvo_attention.launches = 0


def _ln_qkvo_cuda(name, x, gamma, beta, wqkv, bqkv, wo, bo, eps, seq_len,
                  heads, head_dim, kv_heads):
    """K1's forward launch: LN, gemm_sm90.cuh's qkv product, K13's core on
    the packed rows and the out-projection on gemm_sm90.cuh; K7's with
    kv_heads < heads (gemm.cuh's products, the whole-row core)."""
    dev = _check_cuda(
        name,
        {"x": x, "gamma": gamma, "beta": beta, "wqkv": wqkv, "bqkv": bqkv,
         "wo": wo, "bo": bo},
        {"x": _BF, "gamma": _F32, "beta": _F32, "wqkv": _BF, "bqkv": _F32,
         "wo": _BF, "bo": _F32})
    b, spq, d = x.shape
    hhd = heads * head_dim
    _check_qkvo(name, x, gamma, beta, wqkv, bqkv, wo, seq_len, heads,
                head_dim, qkv_attention_supported, kv_heads,
                "K7" if _gqa(heads, kv_heads) else None)
    _check_shape(name, "bo", bo, (d,))
    n = b * spq
    xn = torch.empty((n, d), dtype=_BF, device=dev)
    qkv = torch.empty((n, wqkv.shape[1]), dtype=_BF, device=dev)
    attn = torch.empty((n, hhd), dtype=_BF, device=dev)
    out = torch.empty_like(x)
    rc = build.load().vitax_ln_qkvo_attention_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wqkv.data_ptr(),
        bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(), xn.data_ptr(),
        qkv.data_ptr(), attn.data_ptr(), out.data_ptr(), b, spq, d, seq_len,
        heads, kv_heads, head_dim, eps, 1.0 / math.sqrt(head_dim),
        _stream(dev))
    build.check(rc, name)
    return out


def _check_qkvo(name, x, gamma, beta, wqkv, bqkv, wo, seq_len, heads,
                head_dim, gate, kv_heads=None, first_design=None,
                backward=False):
    """The launch checks of a fused attention half: `gate`'s shapes, and
    where the path runs the first design's core (`first_design` names it)
    that core's limits, forward or `backward` (`_check_first_design`)."""
    b, spq, d = x.shape
    hhd = heads * head_dim
    width = (heads + 2 * (kv_heads or heads)) * head_dim
    gate_args = (x, wqkv, heads) + ((kv_heads,) if _gqa(heads, kv_heads)
                                    else ())
    if (spq % 8 or not 0 < seq_len <= spq or not gate(*gate_args)
            or wqkv.shape[1] != width):
        raise ValueError(
            f"{name}: unsupported shapes x {tuple(x.shape)} wqkv "
            f"{tuple(wqkv.shape)} seq_len {seq_len} heads {heads} kv_heads "
            f"{kv_heads} head_dim {head_dim}")
    if first_design:
        _check_first_design(name, first_design, x, wqkv, heads, kv_heads,
                            backward)
    for key, t, shape in (("gamma", gamma, (d,)), ("beta", beta, (d,)),
                          ("bqkv", bqkv, (width,)), ("wo", wo, (hhd, d))):
        _check_shape(name, key, t, shape)


def fused_ln_qkvo_attention_gqa_ref(x, gamma, beta, wqkv, bqkv, wo, bo, eps,
                                    seq_len, heads, head_dim, kv_heads):
    """The twin of `fused_ln_qkvo_attention_gqa`: K1's twin on the packed
    GQA layout."""
    return fused_ln_qkvo_attention_ref(x, gamma, beta, wqkv, bqkv, wo, bo, eps,
                                       seq_len, heads, head_dim, kv_heads)


def fused_ln_qkvo_attention_gqa(x, gamma, beta, wqkv, bqkv, wo, bo, eps,
                                seq_len, heads, head_dim, kv_heads):
    """K7: `fused_ln_qkvo_attention` with kv_heads < heads, wqkv [D,
    (H + 2·Hkv)·Hd] packed [q (H·Hd) | k (Hkv·Hd) | v (Hkv·Hd)] and bqkv to
    match; query head h attends with kv group h·Hkv/H. Under autograd the
    backward is K1's with kv_heads (`fused_ln_qkvo_attention_bwd`: dK and dV
    of a group summed over its query heads in fp32)."""
    if _needs_grad(x, gamma, beta, wqkv, bqkv, wo, bo):
        return FusedLnQkvoAttentionFn.apply(x, gamma, beta, wqkv, bqkv, wo, bo,
                                            eps, seq_len, heads, head_dim,
                                            False, False, False, kv_heads)
    if not x.is_cuda:
        return fused_ln_qkvo_attention_gqa_ref(x, gamma, beta, wqkv, bqkv, wo,
                                               bo, eps, seq_len, heads,
                                               head_dim, kv_heads)
    out = _ln_qkvo_cuda("fused_ln_qkvo_attention_gqa", x, gamma, beta, wqkv,
                        bqkv, wo, bo, eps, seq_len, heads, head_dim, kv_heads)
    fused_ln_qkvo_attention_gqa.launches += 1
    return out


fused_ln_qkvo_attention_gqa.launches = 0


def fused_ln_qkvo_attention_bwd_ref(x, gamma, beta, wqkv, bqkv, wo, do, eps,
                                    seq_len, heads, head_dim, kv_heads=None):
    """(dx, dγ, dβ, dWqkv, dbqkv, dWo, dbo) of K1 with the TPU kernel's
    rounding points (pallas_kernels.py:2911-2956, _attn_core_grads
    :2846-2895): dattn, ds, dq, dk, dv in x.dtype; dx in x.dtype; the rest
    fp32. kv_heads < heads: the packed GQA layout (K7's backward)."""
    dt = x.dtype
    b, spq, d = x.shape
    scale = 1.0 / math.sqrt(head_dim)
    x2 = x.reshape(-1, d)
    do2 = do.reshape(-1, d)
    xhat, rstd = _ln_stats(x2.float(), eps)
    xn = (xhat * gamma.float() + beta.float()).to(dt)
    q, k, v, p, o = _qkvo_core(xn.view(b, spq, d), wqkv, bqkv, seq_len, heads,
                               head_dim, kv_heads)
    dattn = matmul_f32(do2, wo.t()).to(dt)
    dwo = matmul_f32(_heads_to_rows(o).t(), do2)
    dbo = do2.float().sum(dim=0)
    dqkv = _attn_core_grads(q, k, v, p, o, dattn, scale, kv_heads)
    dxn = matmul_f32(dqkv, wqkv.t())
    dw = matmul_f32(xn.t(), dqkv)
    db = dqkv.float().sum(dim=0)
    dxln, dg, dbe = _ln_bwd_tail(dxn, xhat, rstd, gamma)
    return dxln.to(dt).view(b, spq, d), dg, dbe, dw, db, dwo, dbo


def fused_ln_qkvo_attention_bwd(x, gamma, beta, wqkv, bqkv, wo, do, eps,
                                seq_len, heads, head_dim, kv_heads=None):
    """Backward of `fused_ln_qkvo_attention`: dx [B, spq, D] bf16 and fp32
    dγ, dβ [D], dWqkv [D, W], dbqkv [W], dWo [H·Hd, D], dbo [D], W =
    (H + 2·Hkv)·Hd (3·H·Hd without GQA). kv_heads < heads: K7's backward,
    `fused_ln_qkvo_attention_gqa_bwd` (the same kernel with dK and dV of
    each kv group summed over its H/Hkv query heads in fp32, in head order,
    before one cast)."""
    if _gqa(heads, kv_heads):
        return fused_ln_qkvo_attention_gqa_bwd(x, gamma, beta, wqkv, bqkv, wo,
                                               do, eps, seq_len, heads,
                                               head_dim, kv_heads)
    if not x.is_cuda:
        return fused_ln_qkvo_attention_bwd_ref(x, gamma, beta, wqkv, bqkv, wo,
                                               do, eps, seq_len, heads,
                                               head_dim)
    out = _ln_qkvo_bwd_cuda("fused_ln_qkvo_attention_bwd", x, gamma, beta,
                            wqkv, bqkv, wo, do, eps, seq_len, heads, head_dim,
                            heads)
    fused_ln_qkvo_attention_bwd.launches += 1
    return out


fused_ln_qkvo_attention_bwd.launches = 0


def fused_ln_qkvo_attention_gqa_bwd_ref(x, gamma, beta, wqkv, bqkv, wo, do,
                                        eps, seq_len, heads, head_dim,
                                        kv_heads):
    """The twin of `fused_ln_qkvo_attention_gqa_bwd`: K1's backward twin on
    the packed GQA layout."""
    return fused_ln_qkvo_attention_bwd_ref(x, gamma, beta, wqkv, bqkv, wo, do,
                                           eps, seq_len, heads, head_dim,
                                           kv_heads)


def fused_ln_qkvo_attention_gqa_bwd(x, gamma, beta, wqkv, bqkv, wo, do, eps,
                                    seq_len, heads, head_dim, kv_heads):
    """K7's backward: `fused_ln_qkvo_attention_bwd` with kv_heads < heads,
    the outputs of K1's backward with dWqkv [D, (H + 2·Hkv)·Hd] and dbqkv
    to match."""
    if not x.is_cuda:
        return fused_ln_qkvo_attention_gqa_bwd_ref(x, gamma, beta, wqkv, bqkv,
                                                   wo, do, eps, seq_len,
                                                   heads, head_dim, kv_heads)
    out = _ln_qkvo_bwd_cuda("fused_ln_qkvo_attention_gqa_bwd", x, gamma, beta,
                            wqkv, bqkv, wo, do, eps, seq_len, heads, head_dim,
                            kv_heads)
    fused_ln_qkvo_attention_gqa_bwd.launches += 1
    return out


fused_ln_qkvo_attention_gqa_bwd.launches = 0


def _ln_qkvo_bwd_cuda(name, x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len,
                      heads, head_dim, kv_heads):
    """K1's backward launch: K13's core and gemm_sm90.cuh's products, with
    the core's row statistics as its only attention scratch; K7's with
    kv_heads < heads (the whole-row core, bf16 P and ds in scratch)."""
    dev = _check_cuda(
        name,
        {"x": x, "gamma": gamma, "beta": beta, "wqkv": wqkv, "bqkv": bqkv,
         "wo": wo, "do": do},
        {"x": _BF, "gamma": _F32, "beta": _F32, "wqkv": _BF, "bqkv": _F32,
         "wo": _BF, "do": _BF})
    _check_qkvo(name, x, gamma, beta, wqkv, bqkv, wo, seq_len, heads,
                head_dim, qkv_attention_supported, kv_heads,
                "K7's backward" if _gqa(heads, kv_heads) else None, True)
    _check_shape(name, "do", do, tuple(x.shape))
    b, spq, d = x.shape
    hhd = heads * head_dim
    width = wqkv.shape[1]
    n = b * spq
    rows = (spq + 15) // 16 * 16
    lib = build.load()
    dx, dg, dbe = torch.empty_like(x), _f32(dev, d), _f32(dev, d)
    dw, db = _f32(dev, d, width), _f32(dev, width)
    dwo, dbo = _f32(dev, hhd, d), _f32(dev, d)
    xn, qkv, attn, dattn = (_bf(dev, n, d), _bf(dev, n, width),
                            _bf(dev, n, hhd), _bf(dev, n, hhd))
    dqkv, dxn = _bf(dev, n, width), _f32(dev, n, d)
    ws = _workspace(lib.vitax_ln_qkvo_attention_bwd_ws(n, d, hhd, width), dev)
    head = (x, gamma, beta, wqkv, bqkv, wo, do, dx, dg, dbe, dw, db, dwo, dbo,
            xn, qkv, attn, dattn)
    scale = 1.0 / math.sqrt(head_dim)
    if kv_heads == heads:
        stats = _workspace(lib.vitax_attention_core_bwd_ws(b, spq, heads), dev)
        rc = lib.vitax_ln_qkvo_attention_bwd(*(t.data_ptr() for t in (
            *head, stats, dqkv, dxn, ws)), b, spq, d, seq_len, heads,
            head_dim, eps, scale, _stream(dev))
    else:
        p, ds = _bf(dev, b, heads, rows, rows), _bf(dev, b, heads, rows, rows)
        rc = lib.vitax_ln_qkvo_attention_gqa_bwd(*(t.data_ptr() for t in (
            *head, p, ds, dqkv, dxn, ws)), b, spq, d, seq_len, heads,
            kv_heads, head_dim, eps, scale, _stream(dev))
    build.check(rc, name)
    return dx, dg, dbe, dw, db, dwo, dbo


class FusedLnQkvoAttentionFn(torch.autograd.Function):
    """The fused attention half with its backward kernel, saving (x, γ, β,
    Wqkv, bqkv, Wo), as vitax's fused_ln_qkvo_attention custom VJP
    (pallas_kernels.py:3209-3300): `int8` picks the W8A8 forward (K3) and
    `int8_grad` the W8A8 backward (K3 bwd, :3246-3299), with `int8_dw` its
    per-group int8 weight grads; otherwise the backward is the bf16 one (K1
    bwd, :3300). kv_heads < heads takes the GQA branch of each (K7). `int4`
    picks the A4W4 forward (K11-C); `int4_grad` switches K3's backward to
    K11-D, and only K3's: without `int8_grad` the backward stays K1's, as
    vitax's (:3246)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, wqkv, bqkv, wo, bo, eps, seq_len, heads,
                head_dim, int8, int8_grad, int8_dw, kv_heads, int4=False,
                int4_grad=False):
        ctx.save_for_backward(x, gamma, beta, wqkv, bqkv, wo)
        ctx.meta = (eps, seq_len, heads, head_dim)
        ctx.tier = (int8 and int8_grad, int8_dw, int4_grad)
        ctx.kv_heads = kv_heads
        ctx.bo_dtype = bo.dtype
        if int4:
            return fused_ln_qkvo_attention_int4(x, gamma, beta, wqkv, bqkv, wo,
                                                bo, eps, seq_len, heads,
                                                head_dim, kv_heads=kv_heads)
        if int8:
            return fused_ln_qkvo_attention_int8(x, gamma, beta, wqkv, bqkv, wo,
                                                bo, eps, seq_len, heads,
                                                head_dim, kv_heads=kv_heads)
        return fused_ln_qkvo_attention(x, gamma, beta, wqkv, bqkv, wo, bo, eps,
                                       seq_len, heads, head_dim, kv_heads)

    @staticmethod
    def backward(ctx, do):
        x, gamma, beta, wqkv, bqkv, wo = ctx.saved_tensors
        int8_grad, int8_dw, int4_grad = ctx.tier
        args = (x, gamma, beta, wqkv, bqkv, wo, do.contiguous(), *ctx.meta,
                ctx.kv_heads)
        if not int8_grad:
            grads = fused_ln_qkvo_attention_bwd(*args)
        elif int4_grad:
            grads = (fused_ln_qkvo_attention_int4_dw_bwd if int8_dw
                     else fused_ln_qkvo_attention_int4_bwd)(*args)
        elif int8_dw:
            grads = fused_ln_qkvo_attention_int8_dw_bwd(*args)
        else:
            grads = fused_ln_qkvo_attention_int8_bwd(*args)
        dx, dg, dbe, dw, db, dwo, dbo = grads
        return (dx, dg.to(gamma.dtype), dbe.to(beta.dtype), dw.to(wqkv.dtype),
                db.to(bqkv.dtype), dwo.to(wo.dtype), dbo.to(ctx.bo_dtype),
                None, None, None, None, None, None, None, None, None, None)


# =============================================================================
# K6 — K1 with a KV-chunked online softmax (ViT-H/14 and whatever K1's
# whole-row core cannot hold)
# =============================================================================

def online_core_smem_bytes(head_dim: int, backward: bool = False) -> int:
    """Shared memory of a block of K6's online core (attention_core.cuh,
    kRowsSmem: two 64-row Q tiles and a ring of K and V tiles, 4 stages up
    to head_dim 80 and 3 above) and, in training, of K13's key and query
    passes that follow its row pass (attention_core_bwd.cu, kDkvSmem and
    kDqSmem: 8 tiles, the key pass's 3 stages of statistics besides); no
    term grows with spq."""
    tile = 64 * head_dim * 2
    fwd = (2 + 2 * (4 if head_dim <= 80 else 3)) * tile
    if not backward:
        return fwd
    return max(fwd, 8 * tile + 3 * 3 * 64 * 4)


def qkv_attention_flash_supported(x, wqkv, heads) -> bool:
    """Gate of K6: x [B, S, D] (S padded to spq = round_up(S, 8) by the
    caller), merged wqkv [D, 3·H·Hd]. Where vitax's gate
    (pallas_kernels.py:3362-3381) bounds its VMEM, this one takes the head
    dims its core is built for, the GEMM tiles and bf16 on the card; the
    core's shared memory does not depend on S."""
    if x.ndim != 3 or wqkv.ndim != 2 or heads <= 0:
        return False
    d = x.shape[-1]
    if wqkv.shape[0] != d or wqkv.shape[1] % (3 * heads):
        return False
    hd = wqkv.shape[1] // (3 * heads)
    if x.is_cuda and x.dtype != torch.bfloat16:
        return False
    return (hd in FLASH_HEAD_DIMS and d % 32 == 0 and heads * hd % 32 == 0
            and online_core_smem_bytes(hd) <= SMEM_LIMIT)


def qkv_attention_flash_bwd_supported(x, wqkv, heads) -> bool:
    """Gate of K6 in training: the forward's and its backward core's shared
    memory."""
    if not qkv_attention_flash_supported(x, wqkv, heads):
        return False
    hd = wqkv.shape[1] // (3 * heads)
    return online_core_smem_bytes(hd, backward=True) <= SMEM_LIMIT


_FLASH_KV_CHUNKS = 4  # vitax's _QKVO_FLASH_KV default


def flash_chunks(spq: int) -> int:
    """vitax's `_flash_chunks` (pallas_kernels.py:3384-3388): the KV chunk
    count of its TPU kernel, which the twins copy so that they round where
    it does (3 chunks of 88 keys at spq 264, 4 of 184 at spq 736)."""
    n = _FLASH_KV_CHUNKS
    while n > 1 and (spq % n or (spq // n) % 8):
        n -= 1
    return max(n, 1)


def _flash_chunk_scores(q, k, lo, ckv, seq_len, scale):
    """s = q·kᵀ·scale over keys [lo, lo + ckv), columns ≥ seq_len -1e30."""
    s = matmul_f32(q, k[..., lo:lo + ckv, :].transpose(-1, -2)) * scale
    if lo + ckv > seq_len:
        col = torch.arange(lo, lo + ckv, device=q.device)
        s = torch.where(col < seq_len, s, torch.full_like(s, -1e30))
    return s


def _flash_core(q, k, v, seq_len):
    """vitax's `_flash_head_fwd` (:3391-3416) for every head at once: q, k,
    v [B, H, spq, Hd] → the fp32 head outputs and the row statistics (m,
    l), [B, H, spq, 1] each."""
    spq, hd = q.shape[-2], q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    n_kv = flash_chunks(spq)
    ckv = spq // n_kv
    m = torch.full(q.shape[:-1] + (1,), -1e30, dtype=_F32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=_F32, device=q.device)
    for c in range(n_kv):
        lo = c * ckv
        s = _flash_chunk_scores(q, k, lo, ckv, seq_len, scale)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + matmul_f32(p.to(v.dtype), v[..., lo:lo + ckv, :])
        m = m_new
    return acc / l, m, l


ONLINE_TILE = 64  # keys a tile of K6's online core


def flash_online_core_ref(q, k, v, seq_len):
    """The plain version of K6's online core (attention_core.cuh,
    kRowsOnline{,Stats}) at its rounding points: q, k, v [B, H, rows, Hd]
    bf16, keys masked at seq_len, one walk over 64-key tiles (the tiles
    wholly past seq_len, which would add p = 0 at α = 1, skipped, as the
    kernel's grid skips them). Per tile, with c = scale·log2e: m_new =
    max(m, rowmax(s)·c), α = exp2(m − m_new), p = exp2(s·c − m_new) (0 on
    the keys >= seq_len), l = l·α + Σp from the unrounded p, O = O·α +
    bf16(p)·V in fp32; out = O·(1/l). Returns the fp32 out and the
    statistics the kernel's row pass writes, m (in c units) and 1/l, each
    [B, H, rows, 1]."""
    c = math.log2(math.e) / math.sqrt(q.shape[-1])
    m = torch.full(q.shape[:-1] + (1,), -math.inf, dtype=_F32,
                   device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape, dtype=_F32, device=q.device)
    for lo in range(0, seq_len, ONLINE_TILE):
        hi = min(lo + ONLINE_TILE, seq_len)
        s = matmul_f32(q, k[..., lo:hi, :].transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True) * c)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + matmul_f32(p.to(v.dtype), v[..., lo:hi, :])
        m = m_new
    inv = 1.0 / l
    return o * inv, m, inv


def flash_online_rows_ref(qkv, seq_len, heads, head_dim, dattn=None):
    """The plain version of `flash_online_core`: qkv [B, spq, 3·H·Hd] → the
    head outputs [B, spq, H·Hd] in qkv's dtype; with dattn [B, spq, H·Hd]
    also the backward row pass's statistics [B, H, 3, seq_pad] (m·scale·
    log2e, 1/l, dd = Σ fp32(dO)·out with the fp32 out; 0 past spq, seq_pad
    = spq rounded up to 64)."""
    b, spq, _ = qkv.shape
    q, k, v = (_split_heads(c, heads) for c in qkv.chunk(3, dim=-1))
    out, m, inv = flash_online_core_ref(q, k, v, seq_len)
    attn = _heads_to_rows(out.to(qkv.dtype)).view(b, spq, heads * head_dim)
    if dattn is None:
        return attn
    dd = (_split_heads(dattn, heads).float() * out).sum(dim=-1, keepdim=True)
    stats = torch.cat([m, inv, dd], dim=-1).transpose(-1, -2)
    return attn, torch.nn.functional.pad(stats, (0, -spq % ONLINE_TILE))


def flash_online_core(qkv, seq_len, heads, head_dim, dattn=None):
    """K6's online core alone (ln_qkvo_attention_flash.cu,
    `vitax_attention_online`) on the packed qkv rows, query rows to spq and
    keys masked at seq_len: the bf16 head outputs and, with dattn, the
    backward row pass's statistics, as `flash_online_rows_ref`. The card
    checks hold the core against its plain version through it; no path of
    the port calls it (K6's entry points launch the core themselves)."""
    if not qkv.is_cuda:
        return flash_online_rows_ref(qkv, seq_len, heads, head_dim, dattn)
    name = "flash_online_core"
    tensors = {"qkv": qkv, **({} if dattn is None else {"dattn": dattn})}
    dev = _check_cuda(name, tensors, dict.fromkeys(tensors, _BF))
    b, spq, w = qkv.shape
    hhd = heads * head_dim
    if (head_dim not in FLASH_HEAD_DIMS or w != 3 * hhd
            or not 0 < seq_len <= spq):
        raise ValueError(f"{name}: unsupported qkv {tuple(qkv.shape)}, "
                         f"seq_len {seq_len}, {heads} heads of {head_dim}")
    if dattn is not None:
        _check_shape(name, "dattn", dattn, (b, spq, hhd))
    lib = build.load()
    attn = _bf(dev, b, spq, hhd)
    stats = (None if dattn is None else
             _workspace(lib.vitax_attention_core_bwd_ws(b, spq, heads), dev))
    rc = lib.vitax_attention_online(
        qkv.data_ptr(), 0 if dattn is None else dattn.data_ptr(),
        attn.data_ptr(), 0 if stats is None else stats.data_ptr(), b, spq,
        seq_len, heads, head_dim, 1.0 / math.sqrt(head_dim), _stream(dev))
    build.check(rc, name)
    return attn if stats is None else (attn, stats.view(b, heads, 3, -1))


def _flash_qkv(xn, wqkv, bqkv, heads):
    """xn [B, spq, D] → qkv → per-head q, k, v [B, H, spq, Hd]."""
    qkv = (matmul_f32(xn, wqkv) + bqkv.float()).to(xn.dtype)
    return [_split_heads(t, heads) for t in qkv.chunk(3, dim=-1)]


def fused_ln_qkvo_attention_flash_ref(x, gamma, beta, wqkv, bqkv, wo, bo,
                                      eps, seq_len, heads, head_dim):
    """K6's twin: LN1 → qkv → vitax's KV-chunked online softmax per head →
    out-projection, at the TPU kernel's rounding points
    (_ln_qkvo_fwd_flash_kernel, pallas_kernels.py:3419-3444; p cast to the
    compute dtype unnormalised before p·v). x [B, spq, D] → [B, spq, D],
    no residual."""
    b, spq, d = x.shape
    xn = layer_norm_ref(x, gamma, beta, eps)
    q, k, v = _flash_qkv(xn, wqkv, bqkv, heads)
    out, _, _ = _flash_core(q, k, v, seq_len)
    attn = _heads_to_rows(out.to(x.dtype))
    return (matmul_f32(attn, wo) + bo.float()).to(x.dtype).view(b, spq, d)


def fused_ln_qkvo_attention_flash(x, gamma, beta, wqkv, bqkv, wo, bo, eps,
                                  seq_len, heads, head_dim):
    """K6 forward: `fused_ln_qkvo_attention`'s function with the online
    core (ln_qkvo_attention_flash.cu: LN, the qkv product, the online core
    on the packed rows, the out-projection), the same arguments (MHA only).
    Under autograd its backward is `fused_ln_qkvo_attention_flash_bwd`."""
    if _needs_grad(x, gamma, beta, wqkv, bqkv, wo, bo):
        return FusedLnQkvoAttentionFlashFn.apply(x, gamma, beta, wqkv, bqkv,
                                                 wo, bo, eps, seq_len, heads,
                                                 head_dim)
    if not x.is_cuda:
        return fused_ln_qkvo_attention_flash_ref(x, gamma, beta, wqkv, bqkv,
                                                 wo, bo, eps, seq_len, heads,
                                                 head_dim)
    name = "fused_ln_qkvo_attention_flash"
    dev = _check_cuda(
        name,
        {"x": x, "gamma": gamma, "beta": beta, "wqkv": wqkv, "bqkv": bqkv,
         "wo": wo, "bo": bo},
        {"x": _BF, "gamma": _F32, "beta": _F32, "wqkv": _BF, "bqkv": _F32,
         "wo": _BF, "bo": _F32})
    _check_qkvo(name, x, gamma, beta, wqkv, bqkv, wo, seq_len, heads,
                head_dim, qkv_attention_flash_supported)
    b, spq, d = x.shape
    _check_shape(name, "bo", bo, (d,))
    n, hhd = b * spq, heads * head_dim
    xn, qkv = _bf(dev, n, d), _bf(dev, n, 3 * hhd)
    attn, out = _bf(dev, n, hhd), torch.empty_like(x)
    rc = build.load().vitax_ln_qkvo_attention_flash_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wqkv.data_ptr(),
        bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(), xn.data_ptr(),
        qkv.data_ptr(), attn.data_ptr(), out.data_ptr(), b, spq, d, seq_len,
        heads, head_dim, eps, 1.0 / math.sqrt(head_dim), _stream(dev))
    build.check(rc, name)
    fused_ln_qkvo_attention_flash.launches += 1
    return out


fused_ln_qkvo_attention_flash.launches = 0


def fused_ln_qkvo_attention_flash_bwd_ref(x, gamma, beta, wqkv, bqkv, wo, do,
                                          eps, seq_len, heads, head_dim):
    """(dx, dγ, dβ, dWqkv, dbqkv, dWo, dbo) of K6 at the TPU kernel's
    rounding points (_ln_qkvo_bwd_flash_kernel, pallas_kernels.py:
    3446-3531): (m, l) and the fp32 head outputs from the forward's chunk
    recurrence; dd = Σ fp32(dO)·out in fp32; per chunk p = exp(s − m)/l,
    ds = (p (dO vᵀ − dd)) in x.dtype, dq summed over the chunks in fp32,
    dk, dv per chunk; dx in x.dtype, the rest fp32."""
    dt = x.dtype
    b, spq, d = x.shape
    scale = 1.0 / math.sqrt(head_dim)
    x2, do2 = x.reshape(-1, d), do.reshape(-1, d)
    xhat, rstd = _ln_stats(x2.float(), eps)
    xn = (xhat * gamma.float() + beta.float()).to(dt)
    q, k, v = _flash_qkv(xn.view(b, spq, d), wqkv, bqkv, heads)
    out, m, l = _flash_core(q, k, v, seq_len)
    dattn = matmul_f32(do2, wo.t()).to(dt)
    d_o = dattn.view(b, spq, heads, head_dim).transpose(1, 2)
    dd = (d_o.float() * out).sum(dim=-1, keepdim=True)
    n_kv = flash_chunks(spq)
    ckv = spq // n_kv
    dq = torch.zeros(q.shape, dtype=_F32, device=x.device)
    dks, dvs = [], []
    for c in range(n_kv):
        lo = c * ckv
        kc, vc = k[..., lo:lo + ckv, :], v[..., lo:lo + ckv, :]
        p = torch.exp(_flash_chunk_scores(q, k, lo, ckv, seq_len, scale)
                      - m) / l
        dp = matmul_f32(d_o, vc.transpose(-1, -2))
        ds = (p * (dp - dd)).to(dt)
        dq = dq + matmul_f32(ds, kc) * scale
        dks.append(matmul_f32(ds.transpose(-1, -2), q) * scale)
        dvs.append(matmul_f32(p.to(dt).transpose(-1, -2), d_o))
    dqkv = torch.cat([_heads_to_rows(t.to(dt)) for t in
                      (dq, torch.cat(dks, dim=2), torch.cat(dvs, dim=2))],
                     dim=1)
    dwo = matmul_f32(_heads_to_rows(out.to(dt)).t(), do2)
    dbo = do2.float().sum(dim=0)
    dxn = matmul_f32(dqkv, wqkv.t())
    dw = matmul_f32(xn.t(), dqkv)
    db = dqkv.float().sum(dim=0)
    dxln, dg, dbe = _ln_bwd_tail(dxn, xhat, rstd, gamma)
    return dxln.to(dt).view(b, spq, d), dg, dbe, dw, db, dwo, dbo


def fused_ln_qkvo_attention_flash_bwd(x, gamma, beta, wqkv, bqkv, wo, do, eps,
                                      seq_len, heads, head_dim):
    """K6 backward (ln_qkvo_attention_flash_bwd.cu: the online core's row
    pass, then K13's key and query passes on its statistics; no P or ds in
    device memory): dx [B, spq, D] bf16 and fp32 dγ, dβ [D], dWqkv [D,
    3·H·Hd], dbqkv [3·H·Hd], dWo [H·Hd, D], dbo [D]."""
    if not x.is_cuda:
        return fused_ln_qkvo_attention_flash_bwd_ref(
            x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads, head_dim)
    name = "fused_ln_qkvo_attention_flash_bwd"
    dev = _check_cuda(
        name,
        {"x": x, "gamma": gamma, "beta": beta, "wqkv": wqkv, "bqkv": bqkv,
         "wo": wo, "do": do},
        {"x": _BF, "gamma": _F32, "beta": _F32, "wqkv": _BF, "bqkv": _F32,
         "wo": _BF, "do": _BF})
    _check_qkvo(name, x, gamma, beta, wqkv, bqkv, wo, seq_len, heads,
                head_dim, qkv_attention_flash_bwd_supported)
    _check_shape(name, "do", do, tuple(x.shape))
    b, spq, d = x.shape
    hhd = heads * head_dim
    n, w = b * spq, 3 * hhd
    lib = build.load()
    dx, dg, dbe = torch.empty_like(x), _f32(dev, d), _f32(dev, d)
    dw, db, dwo, dbo = (_f32(dev, d, w), _f32(dev, w), _f32(dev, hhd, d),
                        _f32(dev, d))
    xn, qkv, attn, dattn = (_bf(dev, n, d), _bf(dev, n, w), _bf(dev, n, hhd),
                            _bf(dev, n, hhd))
    stats = _workspace(lib.vitax_attention_core_bwd_ws(b, spq, heads), dev)
    dqkv, dxn = _bf(dev, n, w), _f32(dev, n, d)
    ws = _workspace(lib.vitax_ln_qkvo_attention_bwd_ws(n, d, hhd, w), dev)
    rc = lib.vitax_ln_qkvo_attention_flash_bwd(*(t.data_ptr() for t in (
        x, gamma, beta, wqkv, bqkv, wo, do, dx, dg, dbe, dw, db, dwo, dbo, xn,
        qkv, attn, dattn, stats, dqkv, dxn, ws)), b, spq, d, seq_len, heads,
        head_dim, eps, 1.0 / math.sqrt(head_dim), _stream(dev))
    build.check(rc, name)
    fused_ln_qkvo_attention_flash_bwd.launches += 1
    return dx, dg, dbe, dw, db, dwo, dbo


fused_ln_qkvo_attention_flash_bwd.launches = 0


class FusedLnQkvoAttentionFlashFn(torch.autograd.Function):
    """K6 with its backward kernel, as vitax's fused_ln_qkvo_attention_flash
    custom VJP (pallas_kernels.py:3549-3622): it saves only (x, γ, β, Wqkv,
    bqkv, Wo), and the backward recomputes the rest, (m, l) included."""

    @staticmethod
    def forward(ctx, x, gamma, beta, wqkv, bqkv, wo, bo, eps, seq_len, heads,
                head_dim):
        ctx.save_for_backward(x, gamma, beta, wqkv, bqkv, wo)
        ctx.meta = (eps, seq_len, heads, head_dim)
        ctx.bo_dtype = bo.dtype
        return fused_ln_qkvo_attention_flash(x, gamma, beta, wqkv, bqkv, wo,
                                             bo, eps, seq_len, heads,
                                             head_dim)

    @staticmethod
    def backward(ctx, do):
        x, gamma, beta, wqkv, bqkv, wo = ctx.saved_tensors
        dx, dg, dbe, dw, db, dwo, dbo = fused_ln_qkvo_attention_flash_bwd(
            x, gamma, beta, wqkv, bqkv, wo, do.contiguous(), *ctx.meta)
        return (dx, dg.to(gamma.dtype), dbe.to(beta.dtype), dw.to(wqkv.dtype),
                db.to(bqkv.dtype), dwo.to(wo.dtype), dbo.to(ctx.bo_dtype),
                None, None, None, None)


# =============================================================================
# K13 — the standalone attention core (flash_attention_bhsd :228 and
# flash_attention :248): what vitax's multi_head_attention{,_bhsd} run
# wherever a fused attention half is off (--no-fused-qkv)
# =============================================================================

def attention_supported(q, k, v) -> bool:
    """vitax's gate of K13 (pallas_kernels.py:58-64), the same answer on
    every shape: q, k, v [B, S, H, Hd] of one shape, S <= 1024, Hd <= 128,
    Hd % 8 == 0. The kernel (csrc/attention_core.cu) takes all of them; on
    the card it takes bf16 only (`check_k13_dtype`)."""
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        return False
    _, s, _, hd = q.shape
    return s <= 1024 and hd <= 128 and hd % 8 == 0


def check_k13_dtype(name: str, dtype: torch.dtype) -> None:
    """K13's kernels are bf16 only. vitax's gate takes any dtype, so an fp32
    model on the card reaches K13 (and K1 and K2) in fp32, which is a later
    slice of the port; raise rather than run another function."""
    if dtype != _BF:
        raise NotImplementedError(
            f"{name}: {dtype} on the card: K13's kernels take bf16 only; "
            'fp32 tiers of K13, K1 and K2 are ROADMAP Queue 1 item 9, "fp32 '
            'models on the card". Run the model in bf16, or with '
            "use_pallas=False / --no-pallas")


def flash_attention_bhsd_ref(q, k, v):
    """K13's twin, at the TPU kernel's rounding points (_attn_fwd_kernel,
    pallas_kernels.py:83-109): s = fp32(q·kᵀ)·scale, p = _softmax_rows(s)
    (e·(1/Σe), normalised in fp32), out = (bf16(p)·v in fp32) cast to q's
    dtype. q, k, v [B, H, S, Hd]; vitax's pad rows and masked pad keys add
    nothing, so there are none here."""
    _, o32 = _softmax_pv(q, k, v, k.shape[-2])
    return o32.to(q.dtype)


def flash_attention_bwd_ref(q, k, v, out, do):
    """(dq, dk, dv) [B, H, S, Hd] of K13 at the TPU kernel's rounding points
    (_attn_bwd_kernel, pallas_kernels.py:112-165), from the saved (q, k, v,
    out): p recomputed as the forward's, dd = Σ fp32(dO)·fp32(out),
    ds = (p (dO vᵀ − dd)) in q's dtype, dq = (ds k)·scale, dk = (dsᵀ q)·scale,
    dv = bf16(p)ᵀ dO, each cast once."""
    b, h, s, hd = q.shape
    p, _ = _softmax_pv(q, k, v, s)
    return _core_grads(q, k, v, p, out,
                       do.transpose(1, 2).reshape(b * s, h * hd),
                       1.0 / math.sqrt(hd))


def _core_rows(tb, head_major, pad):
    """tb [B, H, S, Hd] as the kernel's contiguous rows [images, S, heads,
    Hd + pad]: memory [B, H, S, Hd] (images B·H, one head) if head_major,
    else [B, S, H, Hd]; zero columns past Hd. A copy only where tb is laid
    out otherwise, the head dim is padded, or the data is not 16-byte
    aligned."""
    t = (tb if head_major else tb.transpose(1, 2)).contiguous()
    if pad:
        return torch.nn.functional.pad(t, (0, pad))
    return t.clone() if t.data_ptr() % 16 else t


def _from_rows(t, head_major, hd):
    """The kernel's rows → the [B, H, S, Hd] view of their first hd columns."""
    tb = t if head_major else t.transpose(1, 2)
    return tb if tb.shape[-1] == hd else tb[..., :hd]


def _k13_cuda(name, tensors, n_out):
    """Launches K13's forward (tensors q, k, v) or backward (q, k, v, out,
    dO), all [B, H, S, Hd] views. The kernel reads vitax's [B, H, S, Hd]
    memory and the [B, S, H, Hd] memory that the projection einsums give as
    they are; q's decides, the others are brought to it. Returns n_out
    tensors [B, H, S, Hd]."""
    for key, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} is on {t.device}, not CUDA")
        check_k13_dtype(name, t.dtype)
    q = tensors["q"]
    if q.shape != tensors["k"].shape or not attention_supported(
            *(tensors[key].transpose(1, 2) for key in ("q", "k", "v"))):
        raise ValueError(f"{name}: unsupported shapes " + ", ".join(
            f"{key} {tuple(t.shape)}" for key, t in tensors.items()))
    for key, t in tensors.items():
        _check_shape(name, key, t, tuple(q.shape))
    b, h, s, hd = q.shape
    head_major = q.is_contiguous() or not q.transpose(1, 2).is_contiguous()
    pad = -hd % 16
    rows = {key: _core_rows(t, head_major, pad) for key, t in tensors.items()}
    dev = _check_cuda(name, rows, dict.fromkeys(rows, _BF))
    outs = [torch.empty_like(rows["q"]) for _ in range(n_out)]
    images, heads = (b * h, 1) if head_major else (b, h)
    lib = build.load()
    args = [t.data_ptr() for t in (*rows.values(), *outs)]
    if n_out == 1:
        rc = lib.vitax_attention_core_fwd(*args, images, s, heads, hd + pad,
                                          1.0 / math.sqrt(hd), _stream(dev))
    else:
        stats = _workspace(lib.vitax_attention_core_bwd_ws(images, s, heads),
                           dev)
        rc = lib.vitax_attention_core_bwd(*args, stats.data_ptr(), images, s,
                                          heads, hd + pad,
                                          1.0 / math.sqrt(hd), _stream(dev))
    build.check(rc, name)
    return [_from_rows(t, head_major, hd) for t in outs]


def flash_attention_bhsd(q, k, v):
    """K13 forward (csrc/attention_core.cu): [B, H, S, Hd]³ → [B, H, S, Hd],
    softmax(q·kᵀ/√Hd)·v with an fp32 softmax. CPU tensors take the twin;
    CUDA bf16 tensors inside `attention_supported` the kernel; CUDA fp32
    raises (`check_k13_dtype`). Under autograd the backward is
    `flash_attention_bwd` (`FlashAttentionFn`). Launches count as
    `flash_attention`'s."""
    if _needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v)
    if not q.is_cuda:
        return flash_attention_bhsd_ref(q, k, v)
    out, = _k13_cuda("flash_attention_bhsd", {"q": q, "k": k, "v": v}, 1)
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v):
    """K13 on [B, S, H, Hd]³ → [B, S, H, Hd]: `flash_attention_bhsd` on the
    transposed views (the kernel takes their memory as it is, no copy)."""
    return flash_attention_bhsd(
        *(t.transpose(1, 2) for t in (q, k, v))).transpose(1, 2)


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, out, do):
    """K13 backward (csrc/attention_core_bwd.cu): (dq, dk, dv) [B, H, S,
    Hd] of `flash_attention_bhsd` from the saved (q, k, v, out) and dO, all
    [B, H, S, Hd]; the grads in q's memory layout."""
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, out, do)
    grads = _k13_cuda("flash_attention_bwd",
                      {"q": q, "k": k, "v": v, "out": out, "do": do}, 3)
    flash_attention_bwd.launches += 1
    return tuple(grads)


flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """K13 with its backward kernel, saving (q, k, v, out) as vitax's
    custom VJP (pallas_kernels.py:215-225)."""

    @staticmethod
    def forward(ctx, q, k, v):
        out = flash_attention_bhsd(q, k, v)
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, do):
        return flash_attention_bwd(*ctx.saved_tensors, do)


# =============================================================================
# W8A8 tiers of both halves: K4 (MLP) and K3 (attention), forward and the
# int8 dx-path backward. The kernels take the bf16 weights and quantize
# them in their first launches (csrc/quant.cuh; vitax does it in XLA outside
# its kernels), into scratch the wrappers allocate; the twins quantize with
# ops/quant.py, whose divisions give the same codes. The s8 products need
# K % 16, which the bf16 gates' K % 32 implies, so the same gates serve both
# tiers.
# =============================================================================

def _affine(xhat, gamma, beta):
    """x̂·γ + β as one fused multiply-add, as XLA (and nvcc) contract it:
    torch.addcmul rounds once. The int8 twins quantize this value, and one
    rounding more or less can move a code across a .5 tie."""
    return torch.addcmul(beta.float(), xhat, gamma.float())


def _keep(scratch, **pairs):
    """Hands the (codes, scale) pairs of an int8 kernel or twin to a caller
    that asked for them (chip_smoke.py and the card tests hold the kernels'
    codes against the twins'), scales flattened to one per row or column."""
    if scratch is not None:
        scratch.update({k: (q, s.reshape(-1)) for k, (q, s) in pairs.items()})


def _dequant(acc, s_row, s_col, bias=None):
    """f32(acc)·s_row·s_col (+ bias), the TPU kernels' order, the bias add
    fused with the last multiply as XLA contracts it."""
    t = acc * s_row
    return t * s_col if bias is None else torch.addcmul(bias.float(), t, s_col)


# The int8_dw weight grads (Jetfire-style per-group int8 with row-scale
# folding, pallas_kernels.py:1173-1197 and :3041-3084): the per-row codes of
# the dx-path products (do, dh1, dqkv) are reused as one operand; their row
# scales fold into the other operand before its per-column quantization over
# a group of rows. The TPU's group is a grid step's row chunk; the port picks
# its own: K4 fixed groups of MLP_DW_GROUP rows (the last one ragged), K3
# whole images (`qkvo_dw_group`). The twins take the group as an argument.
MLP_DW_GROUP = 128
# the kernels pad each group's rows to whole 128-code K tiles of
# gemm_sm90.cuh's s8 path (dw_int8.cuh's kDwPad; gemm.cuh's 64-deep stages,
# K12-int8's, divide it)
_DW_PAD = 128


def _qkvo_bwd_tile(b: int, spq: int) -> int:
    """Images of one grid step of vitax's attention backwards
    (_qkvo_bwd_tile, pallas_kernels.py:3223): 4 at spq <= 128, else 2,
    halved until it divides b."""
    t = 4 if spq <= 128 else 2
    while t > 1 and b % t:
        t //= 2
    return t


def qkvo_dw_group(b: int, spq: int) -> int:
    """Rows of one int8_dw group of K3's backward: tile·spq, whole images."""
    return _qkvo_bwd_tile(b, spq) * spq


def qkvo_rect_dw_groups(b: int, cpq: int, spq: int):
    """Rows of the int8_dw groups of K8's backward, (Q side and dWo, KV
    side): vitax's grid step of tile images, the tile taken at x's spq
    (pallas_kernels.py:4506), so tile·cpq rows of xc and tile·spq rows of
    x."""
    t = _qkvo_bwd_tile(b, spq)
    return t * cpq, t * spq


def _dw_int8(a, s_row, q, group):
    """Σ over groups of `group` rows of f32(quant_cols(a_g·s_g)ᵀ·q_g)·s_col:
    a [n, Wa] (bf16 or fp32 values), s_row [n, 1] the row scales of the codes
    q [n, Wb]; int32 (exact) inside a group, fp32 across groups in order.
    Returns (dW [Wa, Wb] fp32, (column codes [n, Wa], their scales
    [groups·Wa]))."""
    dw = torch.zeros((a.shape[1], q.shape[1]), dtype=_F32, device=a.device)
    codes, scales = [], []
    for r0 in range(0, a.shape[0], group):
        rows = slice(r0, r0 + group)
        ac, sc = quant_cols(a[rows].float() * s_row[rows])
        dw = dw + int_mm(ac.t(), q[rows]) * sc.reshape(-1, 1)
        codes.append(ac)
        scales.append(sc.reshape(-1))
    return dw, (torch.cat(codes), torch.cat(scales))


def _dw_int8_cols(a, b, group):
    """The int4_grad backwards' int8_dw (pallas_kernels.py:1057-1074,
    :3033-3040, :3071-3076): Σ over groups of `group` rows of
    f32(quant_cols(a_g)ᵀ·quant_cols(b_g))·s_a·s_b, both operands packed
    fresh per column (no row-scale folding). Returns (dW [Wa, Wb] fp32,
    a's and b's (column codes [n, W], their scales [groups·W]))."""
    dw = torch.zeros((a.shape[1], b.shape[1]), dtype=_F32, device=a.device)
    packs = ([], [], [], [])
    for r0 in range(0, a.shape[0], group):
        rows = slice(r0, r0 + group)
        ac, sa = quant_cols(a[rows].float())
        bc, sb = quant_cols(b[rows].float())
        dw = dw + int_mm(ac.t(), bc) * sa.reshape(-1, 1) * sb
        for out, t in zip(packs, (ac, sa.reshape(-1), bc, sb.reshape(-1))):
            out.append(t)
    ac, sa, bc, sb = (torch.cat(t) for t in packs)
    return dw, (ac, sa), (bc, sb)


def _mlp_block_rows(n: int) -> int:
    """vitax's int8 row block (_mlp_block_rows, pallas_kernels.py:427, at
    its default knobs): 256, or at n >= 32768 1024 or a nearby divisor of
    n that two forward chunks divide."""
    if n < 32768:
        return 256
    if n % 1024:
        for cand in (1280, 960, 768, 640, 512):
            if n % (2 * cand) == 0:
                return cand
    return 1024


def mlp_int4_dw_group(n: int) -> int:
    """Rows of one int8_dw group of K11-B (vitax's grid step chunk over n
    rows): the rows padded by _ln_mlp_pad (:1412), their row block
    _ln_mlp_rows (:1393) split into _bwd_chunks (:1405), at vitax's default
    knobs (VITAX_MLP_ROWS, _CHUNKS, _BWD_CHUNKS unset)."""
    block = _mlp_block_rows(n)
    if n < block:
        npad = -(-n // 16) * 16
    elif n < 2 * block:
        npad = -(-n // block) * block
    else:
        npad = -(-n // block) * block
        if npad % (2 * block):
            npad += block
    rows = min(_mlp_block_rows(npad), -(-npad // 16) * 16)
    while rows > 16 and npad % rows:
        rows //= 2
    chunks = 2
    while chunks > 1 and (rows % chunks or (rows // chunks) % 16):
        chunks //= 2
    return rows // chunks


def _pad_rows(t, group):
    """t [n, W] with zero rows up to a whole number of groups: vitax's pad
    rows (zero x, zero cotangent) whose h1 and xn enter the column scales of
    K11-B's int8_dw; the groups past that are all pad and add nothing."""
    pad = -t.shape[0] % group
    return torch.nn.functional.pad(t, (0, 0, 0, pad)) if pad else t


def _dw_pad(group: int) -> int:
    return -(-group // _DW_PAD) * _DW_PAD


def _dw_layout(n: int, group: int):
    """(groups, kp) of the kernels' transposed int8_dw operands [W, kp]:
    each group's rows zero-padded to a multiple of _DW_PAD."""
    groups = -(-n // group)
    return groups, groups * _dw_pad(group)


def _group_codes(qt, n, group):
    """A kernel's transposed column codes qt [W, kp] in the twin's layout,
    [n, W]."""
    w = qt.shape[0]
    return (qt.view(w, -1, _dw_pad(group))[:, :, :group]
            .permute(1, 2, 0).reshape(-1, w)[:n])


def fused_ln_mlp_int8_ref(x, gamma, beta, w1, b1, w2, b2, eps, *,
                          scratch=None, residual=True):
    """K4 forward with the TPU kernel's rounding points
    (_ln_mlp_fwd_int8_kernel, pallas_kernels.py:692-721): xq from the fp32
    LN output, a1 = f32(xq·W1q)·sx·s1 + b1, h1q from gelu_q(a1) in fp32,
    y = f32(h1q·W2q)·sh·s2 + b2, out = x + bf16(y) in x.dtype (bf16(y)
    without `x +` when not residual, :718). A `scratch` dict receives every
    (codes, scale) pair, as the kernel's wrapper fills it."""
    return _ln_mlp_int8_twin(x, gamma, beta, w1, b1, w2, b2, eps, scratch,
                             residual=residual)[0]


def _quantizers(int4):
    """(per-row activations, per-column weights, per-row weights) of the
    W8A8 tier, or with `int4` of the A4W4 tier."""
    if int4:
        return quant_rows4, quant_cols_host4, quant_rows_host4
    return quant_rows, quant_cols_host, quant_rows_host


def _ln_mlp_int8_twin(x, gamma, beta, w1, b1, w2, b2, eps, scratch,
                      int4=False, residual=True):
    """(out, a1, h1q, sh) of K4's twin, or with `int4` of K11-A's (out
    without `x +` when not residual)."""
    rows = _quantizers(int4)[0]
    d = x.shape[-1]
    xhat, _ = _ln_stats(x.reshape(-1, d).float(), eps)
    xq, sx = rows(_affine(xhat, gamma, beta))
    return _mlp_int8_from_codes(x, xq, sx, w1, b1, w2, b2, scratch, int4,
                                residual)


def fused_ln_mlp_int8_from_codes_ref(x, xq, sx, w1, b1, w2, b2, *,
                                     scratch=None, residual=True):
    """K4's twin after its LN-quant, from given row codes xq [n, D] and
    scales sx [n] of the LN output. Given a kernel's own codes (its LN and
    torch's may put a code one step apart) it holds the rest of the kernel
    bit for bit: the int32 sums are exact and every later step is rounded
    where the kernel rounds it."""
    return _mlp_int8_from_codes(x, xq, sx.reshape(-1, 1), w1, b1, w2, b2,
                                scratch, residual=residual)[0]


def _mlp_int8_from_codes(x, xq, sx, w1, b1, w2, b2, scratch, int4=False,
                         residual=True):
    rows, cols_host, _ = _quantizers(int4)
    x2 = x.reshape(-1, x.shape[-1])
    w1q, s1 = cols_host(w1)
    w2q, s2 = cols_host(w2)
    a1 = _dequant(int_mm(xq, w1q), sx, s1, b1)
    h1q, sh = rows(gelu_q(a1))
    y = _dequant(int_mm(h1q, w2q), sh, s2, b2)
    _keep(scratch, w1q=(w1q, s1), w2q=(w2q, s2), xq=(xq, sx), h1q=(h1q, sh))
    out = x2 + y.to(x.dtype) if residual else y.to(x.dtype)
    return out.reshape(x.shape), a1, h1q, sh


def fused_ln_mlp_int8(x, gamma, beta, w1, b1, w2, b2, eps, int8_grad=False,
                      int8_dw=False, save_acts=False, residual=True, *,
                      scratch=None):
    """`fused_ln_mlp` with W8A8 fc1 and fc2 and the sigmoid GELU (K4).
    Under autograd the backward is K4's int8 dx-path backward with
    `int8_grad` (with its int8 weight grads under `int8_dw`), else the bf16
    K2 backward; `int8_grad` with `save_acts` takes K12's int8 save pair
    (`FusedLnMlpSaveFn`), and `save_acts` alone changes nothing, as in
    vitax's dispatch (pallas_kernels.py:2156-2166). `residual=False` is
    `fused_ln_mlp_int8_partial` (and its backwards). A `scratch` dict
    receives the codes and scales the kernel wrote, keyed and laid out as
    the twin's."""
    if _needs_grad(x, gamma, beta, w1, b1, w2, b2):
        if int8_grad and save_acts:
            return FusedLnMlpSaveFn.apply(x, gamma, beta, w1, b1, w2, b2, eps,
                                          True, int8_dw, residual)
        return FusedLnMlpFn.apply(x, gamma, beta, w1, b1, w2, b2, eps, True,
                                  int8_grad, int8_dw, False, False, residual)
    if not residual:
        return fused_ln_mlp_int8_partial(x, gamma, beta, w1, b1, w2, b2, eps,
                                         scratch=scratch)
    if not x.is_cuda:
        return fused_ln_mlp_int8_ref(x, gamma, beta, w1, b1, w2, b2, eps,
                                     scratch=scratch)
    out = _ln_mlp_quant_fwd_cuda("fused_ln_mlp_int8", False, x, gamma, beta,
                                 w1, b1, w2, b2, eps, scratch)
    fused_ln_mlp_int8.launches += 1
    return out


def _ln_mlp_quant_fwd_cuda(name, int4, x, gamma, beta, w1, b1, w2, b2, eps,
                           scratch, residual=True):
    """K4's forward launch (ln_mlp_int8.cu: LN-quant, fc1 and fc2 on
    gemm_sm90.cuh's s8 path, the row codes between), or with `int4`
    K11-A's (gemm.cuh's s8 products)."""
    dev = _check_cuda(
        name,
        {"x": x, "gamma": gamma, "beta": beta, "w1": w1, "b1": b1, "w2": w2,
         "b2": b2},
        {"x": _BF, "gamma": _F32, "beta": _F32, "w1": _BF, "b1": _F32,
         "w2": _BF, "b2": _F32})
    d = x.shape[-1]
    m = w1.shape[1]
    x2 = x.view(-1, d)
    if not ln_mlp_supported(x2.unsqueeze(0), w1, w2):
        raise ValueError(f"{name}: unsupported shapes x {tuple(x.shape)} w1 "
                         f"{tuple(w1.shape)} w2 {tuple(w2.shape)}")
    for key, t, k in (("gamma", gamma, d), ("beta", beta, d), ("b1", b1, m),
                      ("b2", b2, d)):
        _check_shape(name, key, t, (k,))
    n = x2.shape[0]
    w1t, s1 = _i8(dev, m, d), _f32(dev, m)  # per column, as [N, K]
    w2t, s2 = _i8(dev, d, m), _f32(dev, d)
    xq, h1q = _i8(dev, n, d), _i8(dev, n, m)
    sx, sh = _f32(dev, n), _f32(dev, n)
    g = _f32(dev, n, m)
    out = torch.empty_like(x2)
    lib = build.load()
    fn = lib.vitax_ln_mlp_int4_fwd if int4 else lib.vitax_ln_mlp_int8_fwd
    rc = fn(*(t.data_ptr() for t in (
        x2, gamma, beta, w1, b1, w2, b2, w1t, s1, w2t, s2, xq, sx, g, h1q, sh,
        out)), n, d, m, eps, int(residual), _stream(dev))
    build.check(rc, name)
    _keep(scratch, w1q=(w1t.t(), s1), w2q=(w2t.t(), s2), xq=(xq, sx),
          h1q=(h1q, sh))
    return out.view(x.shape)


fused_ln_mlp_int8.launches = 0


def fused_ln_mlp_int8_partial(x, gamma, beta, w1, b1, w2, b2, eps, *,
                              scratch=None):
    """K4's `residual=False` branch (ln_mlp_int8.cu with residual 0,
    vitax's :718): bf16(f32(h1q·W2q)·sh·s2 + b2) without `x +`, a model
    shard's partial sum of vitax's tensor-parallel `--int8` MLP half.
    Counted apart from K4's residual launches."""
    if not x.is_cuda:
        return fused_ln_mlp_int8_ref(x, gamma, beta, w1, b1, w2, b2, eps,
                                     scratch=scratch, residual=False)
    out = _ln_mlp_quant_fwd_cuda("fused_ln_mlp_int8_partial", False, x, gamma,
                                 beta, w1, b1, w2, b2, eps, scratch, False)
    fused_ln_mlp_int8_partial.launches += 1
    return out


fused_ln_mlp_int8_partial.launches = 0


def fused_ln_mlp_int8_bwd_ref(x, gamma, beta, w1, b1, w2, do, eps, *,
                              int8_dw=False, group=None, scratch=None,
                              residual=True):
    """(dx, dγ, dβ, dW1, db1, dW2, db2) of K4 under int8_grad with the TPU
    kernel's rounding points (_ln_mlp_bwd_int8_kernel, pallas_kernels.py:
    1134-1224): xq from the bf16-rounded xn (the forward quantizes fp32),
    the fc1 recompute on the column-quantized W1,
    dh1f = f32(doq·W2rᵀ)·sdo·s2r, dh1_32 = dh1f·gelu_grad_q(a1),
    dxn = f32(dh1q·W1rᵀ)·sd·s1r; db1 = Σ dh1_32. dW1, dW2: bf16 products,
    or with `int8_dw` the per-group int8 products over `group` rows
    (MLP_DW_GROUP by default; `_dw_int8`). dx without `do +` when not
    residual (:1219)."""
    return _ln_mlp_quant_bwd_ref(x, gamma, beta, w1, b1, w2, do, eps, False,
                                 int8_dw, group or MLP_DW_GROUP, scratch,
                                 residual)


def _ln_mlp_quant_bwd_ref(x, gamma, beta, w1, b1, w2, do, eps, int4, int8_dw,
                          group, scratch, residual=True):
    """K4's backward twin, or with `int4` K11-B's: the same body with every
    quantizer of the recompute and the dx-path on the int4 grid, and under
    `int8_dw` both operands of each weight grad packed fresh per column
    (`_dw_int8_cols`; the caller pads the rows to whole groups). dx without
    `do +` when not residual."""
    rows, cols_host, rows_host = _quantizers(int4)
    dt = x.dtype
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    do2 = do.reshape(-1, d)
    w1r, s1r = rows_host(w1)
    w2r, s2r = rows_host(w2)
    w1c, s1c = cols_host(w1)
    xhat, rstd = _ln_stats(x2.float(), eps)
    xn = _affine(xhat, gamma, beta).to(dt)
    xq, sxq = rows(xn.float())
    a1 = _dequant(int_mm(xq, w1c), sxq, s1c, b1)
    doq, sdo = rows(do2.float())
    dh1f = _dequant(int_mm(doq, w2r.t()), sdo, s2r)
    h1 = gelu_q(a1).to(dt)
    dh1_32 = dh1f * gelu_grad_q(a1)
    dh1 = dh1_32.to(dt)
    dh1q, sd = rows(dh1_32)
    if int8_dw and int4:
        dw2, h1c, doc = _dw_int8_cols(h1, do2, group)
        dw1, xnc, dh1c = _dw_int8_cols(xn, dh1_32, group)
        _keep(scratch, h1c=h1c, doc=doc, xnc=xnc, dh1c=dh1c)
    elif int8_dw:
        dw2, h1c = _dw_int8(h1, sdo, doq, group)
        dw1, xnc = _dw_int8(xn, sd, dh1q, group)
        _keep(scratch, h1c=h1c, xnc=xnc)
    else:
        dw2 = matmul_f32(h1.t(), do2)
        dw1 = matmul_f32(xn.t(), dh1)
    dxn = _dequant(int_mm(dh1q, w1r.t()), sd, s1r)
    dxln, dg, dbe = _ln_bwd_tail(dxn, xhat, rstd, gamma)
    _keep(scratch, w1r=(w1r, s1r), w2r=(w2r, s2r), w1c=(w1c, s1c),
          xq=(xq, sxq), doq=(doq, sdo), dh1q=(dh1q, sd))
    dx = do2 + dxln.to(dt) if residual else dxln.to(dt)
    return (dx.reshape(x.shape), dg, dbe, dw1, dh1_32.sum(dim=0), dw2,
            do2.float().sum(dim=0))


def fused_ln_mlp_int8_dw_bwd_ref(x, gamma, beta, w1, b1, w2, do, eps, *,
                                 scratch=None, residual=True):
    """The twin of `fused_ln_mlp_int8_dw_bwd`: int8_dw at the port's group
    (MLP_DW_GROUP rows)."""
    return fused_ln_mlp_int8_bwd_ref(x, gamma, beta, w1, b1, w2, do, eps,
                                     int8_dw=True, group=MLP_DW_GROUP,
                                     scratch=scratch, residual=residual)


def _ln_mlp_int8_bwd_cuda(name, x, gamma, beta, w1, b1, w2, do, eps, int8_dw,
                          scratch, int4=False, residual=True):
    """K4's backward launch (ln_mlp_int8_bwd.cu: gemm_sm90.cuh's s8 path, no
    a1 scratch), or with `int4` K11-B's (the same sequence at L = 7), whose
    int8_dw runs on the rows padded to whole groups of vitax's
    (`mlp_int4_dw_group`)."""
    dev = _check_cuda(
        name,
        {"x": x, "gamma": gamma, "beta": beta, "w1": w1, "b1": b1, "w2": w2,
         "do": do},
        {"x": _BF, "gamma": _F32, "beta": _F32, "w1": _BF, "b1": _F32,
         "w2": _BF, "do": _BF})
    d = x.shape[-1]
    m = w1.shape[1]
    x2 = x.view(-1, d)
    if not ln_mlp_supported(x2.unsqueeze(0), w1, w2):
        raise ValueError(f"{name}: unsupported shapes x {tuple(x.shape)} w1 "
                         f"{tuple(w1.shape)} w2 {tuple(w2.shape)}")
    for key, t, k in (("gamma", gamma, d), ("beta", beta, d), ("b1", b1, m)):
        _check_shape(name, key, t, (k,))
    _check_shape(name, "do", do, tuple(x.shape))
    rows = x2.shape[0]
    do2 = do.view(-1, d)
    group = MLP_DW_GROUP
    if int4 and int8_dw:
        group = mlp_int4_dw_group(rows)
        x2, do2 = _pad_rows(x2, group), _pad_rows(do2, group)
    n = x2.shape[0]
    lib = build.load()
    w1r, s1r = _i8(dev, d, m), _f32(dev, d)  # per row
    w2r, s2r = _i8(dev, m, d), _f32(dev, m)
    w1c, s1c = _i8(dev, m, d), _f32(dev, m)  # per column, as [N, K]
    dx, dg, dbe = torch.empty_like(x2), _f32(dev, d), _f32(dev, d)
    dw1, db1 = _f32(dev, d, m), _f32(dev, m)
    dw2, db2 = _f32(dev, m, d), _f32(dev, d)
    xn, h1 = _bf(dev, n, d), _bf(dev, n, m)
    # dh1 (bf16) feeds the bf16 dW1 only: K4's int8_dw does without it
    dh1 = None if int8_dw else _bf(dev, n, m)
    dh1f, dxn = _f32(dev, n, m), _f32(dev, n, d)
    xq, doq, dh1q = _i8(dev, n, d), _i8(dev, n, d), _i8(dev, n, m)
    sx, sdo, sdh = _f32(dev, n), _f32(dev, n), _f32(dev, n)
    ws = _workspace(lib.vitax_ln_mlp_bwd_ws(n, d, m), dev)
    # int8_dw: (h1 | do) column codes and scales for dW2, (xn | dh1) for dW1;
    # K4 reuses do's and dh1's row codes, so it has no scales of its own
    # for them (K11-B's are the fifth and last)
    dw = [None] * 8
    if int8_dw:
        groups, kp = _dw_layout(n, group)
        dw = [_i8(dev, m, kp), _f32(dev, groups, m), _i8(dev, d, kp),
              _f32(dev, groups, d) if int4 else None, _i8(dev, d, kp),
              _f32(dev, groups, d), _i8(dev, m, kp),
              _f32(dev, groups, m) if int4 else None]
    ptrs = [None if t is None else t.data_ptr() for t in dw]
    if not int4:
        del ptrs[7], ptrs[3]
    fn = lib.vitax_ln_mlp_int4_bwd if int4 else lib.vitax_ln_mlp_int8_bwd
    rc = fn(*(None if t is None else t.data_ptr() for t in (
        x2, gamma, beta, b1, w1, w2, do2, dx, dg, dbe, dw1, db1, dw2, db2, w1r,
        s1r, w2r, s2r, w1c, s1c, xn, xq, sx, h1, doq, sdo, dh1f, dh1,
        dh1q, sdh, dxn, ws)), *ptrs, n, d, m, group, int(int8_dw), eps,
        int(residual), _stream(dev))
    build.check(rc, name)
    _keep(scratch, w1r=(w1r, s1r), w2r=(w2r, s2r), w1c=(w1c.t(), s1c),
          xq=(xq, sx), doq=(doq, sdo), dh1q=(dh1q, sdh))
    if int8_dw and scratch is not None:  # the layout change copies
        _keep(scratch, h1c=(_group_codes(dw[0], n, group), dw[1]),
              xnc=(_group_codes(dw[4], n, group), dw[5]))
        if int4:
            _keep(scratch, doc=(_group_codes(dw[2], n, group), dw[3]),
                  dh1c=(_group_codes(dw[6], n, group), dw[7]))
    return dx[:rows].view(x.shape), dg, dbe, dw1, db1, dw2, db2


def fused_ln_mlp_int8_bwd(x, gamma, beta, w1, b1, w2, do, eps, *,
                          scratch=None, residual=True):
    """Backward of `fused_ln_mlp_int8` under int8_grad: dx (x's shape, bf16)
    and fp32 dγ, dβ [D], dW1 [D,M], db1 [M], dW2 [M,D], db2 [D].
    residual=False is `fused_ln_mlp_int8_partial_bwd`."""
    if not residual:
        return fused_ln_mlp_int8_partial_bwd(x, gamma, beta, w1, b1, w2, do,
                                             eps, scratch=scratch)
    if not x.is_cuda:
        return fused_ln_mlp_int8_bwd_ref(x, gamma, beta, w1, b1, w2, do, eps,
                                         scratch=scratch)
    out = _ln_mlp_int8_bwd_cuda("fused_ln_mlp_int8_bwd", x, gamma, beta, w1,
                                b1, w2, do, eps, False, scratch)
    fused_ln_mlp_int8_bwd.launches += 1
    return out


fused_ln_mlp_int8_bwd.launches = 0


def fused_ln_mlp_int8_partial_bwd(x, gamma, beta, w1, b1, w2, do, eps, *,
                                  scratch=None):
    """K4's backward without the residual's dx (ln_mlp_int8_bwd.cu with
    residual 0, vitax's :1219): dx = bf16(dx_ln), every other output
    `fused_ln_mlp_int8_bwd`'s. Counted apart."""
    if not x.is_cuda:
        return fused_ln_mlp_int8_bwd_ref(x, gamma, beta, w1, b1, w2, do, eps,
                                         scratch=scratch, residual=False)
    out = _ln_mlp_int8_bwd_cuda("fused_ln_mlp_int8_partial_bwd", x, gamma,
                                beta, w1, b1, w2, do, eps, False, scratch,
                                residual=False)
    fused_ln_mlp_int8_partial_bwd.launches += 1
    return out


fused_ln_mlp_int8_partial_bwd.launches = 0


def fused_ln_mlp_int8_dw_bwd(x, gamma, beta, w1, b1, w2, do, eps, *,
                             scratch=None, residual=True):
    """`fused_ln_mlp_int8_bwd` under int8_dw: dW1 and dW2 are per-group int8
    products with row-scale folding, over groups of MLP_DW_GROUP = 128 rows
    (the last one ragged), int32 inside a group and fp32 across groups in
    order. `scratch` also receives the column codes, h1c and xnc, as
    [rows, width] with one scale a column a group. residual=False is
    `fused_ln_mlp_int8_partial_dw_bwd`."""
    if not residual:
        return fused_ln_mlp_int8_partial_dw_bwd(x, gamma, beta, w1, b1, w2,
                                                do, eps, scratch=scratch)
    if not x.is_cuda:
        return fused_ln_mlp_int8_dw_bwd_ref(x, gamma, beta, w1, b1, w2, do,
                                            eps, scratch=scratch)
    out = _ln_mlp_int8_bwd_cuda("fused_ln_mlp_int8_dw_bwd", x, gamma, beta,
                                w1, b1, w2, do, eps, True, scratch)
    fused_ln_mlp_int8_dw_bwd.launches += 1
    return out


fused_ln_mlp_int8_dw_bwd.launches = 0


def fused_ln_mlp_int8_partial_dw_bwd(x, gamma, beta, w1, b1, w2, do, eps, *,
                                     scratch=None):
    """`fused_ln_mlp_int8_dw_bwd` without the residual's dx (its `int8_dw`
    branch at :1219). Counted apart."""
    if not x.is_cuda:
        return fused_ln_mlp_int8_dw_bwd_ref(x, gamma, beta, w1, b1, w2, do,
                                            eps, scratch=scratch,
                                            residual=False)
    out = _ln_mlp_int8_bwd_cuda("fused_ln_mlp_int8_partial_dw_bwd", x, gamma,
                                beta, w1, b1, w2, do, eps, True, scratch,
                                residual=False)
    fused_ln_mlp_int8_partial_dw_bwd.launches += 1
    return out


fused_ln_mlp_int8_partial_dw_bwd.launches = 0


# =============================================================================
# K11 — the A4W4 (int4) tiers of the plain ViT, `--int4`, `--int4-attn`,
# `--int4-grad`: K4's and K3's forwards and backwards with every quantizer
# of the forward projections, the recompute and the dx-path on the int4 grid
# (codes in int8, limit 7; csrc's L = 7 instantiations), the weight grads
# bf16 or, under int8_dw, int8 packed fresh per column (no row-scale
# folding). vitax's dispatch (pallas_kernels.py:2152-2155, :3137, :3246):
# int4 picks the forward ahead of save-acts and int8; the MLP's backward is
# K11-B under int4_grad, else K4's under int8_grad, else K2's; the attention
# half's is K11-D only under int8 and int8_grad and int4_grad, else K3's
# under int8 and int8_grad, else K1's.
# =============================================================================

def fused_ln_mlp_int4_ref(x, gamma, beta, w1, b1, w2, b2, eps, *,
                          scratch=None, residual=True):
    """K11-A with the TPU kernel's rounding points (_ln_mlp_fwd_int4_kernel,
    pallas_kernels.py:973-998): K4's twin on the int4 grid, xq from the
    fp32 LN output, h1q from gelu_q(a1), out = x + bf16(y) in x.dtype
    (bf16(y) when not residual, :997)."""
    return _ln_mlp_int8_twin(x, gamma, beta, w1, b1, w2, b2, eps, scratch,
                             int4=True, residual=residual)[0]


def fused_ln_mlp_int4(x, gamma, beta, w1, b1, w2, b2, eps, int8_grad=False,
                      int8_dw=False, int4_grad=False, residual=True, *,
                      scratch=None):
    """`fused_ln_mlp` with A4W4 fc1 and fc2 and the sigmoid GELU (K11-A,
    ln_mlp_int8.cu at L = 7). Under autograd the backward is K11-B with
    `int4_grad`, else K4's with `int8_grad` (with their int8 weight grads
    under `int8_dw`), else K2's (_ln_mlp_2d_int4_bwd :1948-1970).
    `residual=False` is `fused_ln_mlp_int4_partial` (and its backwards).
    `scratch`: as `fused_ln_mlp_int8`'s."""
    if _needs_grad(x, gamma, beta, w1, b1, w2, b2):
        return FusedLnMlpFn.apply(x, gamma, beta, w1, b1, w2, b2, eps, True,
                                  int8_grad, int8_dw, True, int4_grad,
                                  residual)
    if not residual:
        return fused_ln_mlp_int4_partial(x, gamma, beta, w1, b1, w2, b2, eps,
                                         scratch=scratch)
    if not x.is_cuda:
        return fused_ln_mlp_int4_ref(x, gamma, beta, w1, b1, w2, b2, eps,
                                     scratch=scratch)
    out = _ln_mlp_quant_fwd_cuda("fused_ln_mlp_int4", True, x, gamma, beta,
                                 w1, b1, w2, b2, eps, scratch)
    fused_ln_mlp_int4.launches += 1
    return out


fused_ln_mlp_int4.launches = 0


def fused_ln_mlp_int4_partial(x, gamma, beta, w1, b1, w2, b2, eps, *,
                              scratch=None):
    """K11-A's `residual=False` branch (ln_mlp_int8.cu at L = 7 with
    residual 0, vitax's :997): the tensor-parallel `--int4` MLP half's
    partial sum. Counted apart."""
    if not x.is_cuda:
        return fused_ln_mlp_int4_ref(x, gamma, beta, w1, b1, w2, b2, eps,
                                     scratch=scratch, residual=False)
    out = _ln_mlp_quant_fwd_cuda("fused_ln_mlp_int4_partial", True, x, gamma,
                                 beta, w1, b1, w2, b2, eps, scratch, False)
    fused_ln_mlp_int4_partial.launches += 1
    return out


fused_ln_mlp_int4_partial.launches = 0


def fused_ln_mlp_int4_bwd_ref(x, gamma, beta, w1, b1, w2, do, eps, *,
                              int8_dw=False, group=None, scratch=None,
                              residual=True):
    """(dx, dγ, dβ, dW1, db1, dW2, db2) of K11-B with the TPU kernel's
    rounding points (_ln_mlp_bwd_int4_kernel, pallas_kernels.py:1017-1109):
    K4's backward twin with quant_rows4 of the bf16-rounded xn, of do and of
    dh1_32, and W1, W2 on the int4 grid. dW1, dW2: bf16 products, or with
    `int8_dw` Σ over groups of `group` rows (vitax's, `mlp_int4_dw_group`,
    by default) of int8 products of both operands packed fresh per column,
    the rows zero-padded to whole groups as vitax pads them. dx without
    `do +` when not residual (:1096)."""
    if not int8_dw:
        return _ln_mlp_quant_bwd_ref(x, gamma, beta, w1, b1, w2, do, eps,
                                     True, False, None, scratch, residual)
    d = x.shape[-1]
    x2, do2 = x.reshape(-1, d), do.reshape(-1, d)
    group = group or mlp_int4_dw_group(x2.shape[0])
    dx, *grads = _ln_mlp_quant_bwd_ref(
        _pad_rows(x2, group), gamma, beta, w1, b1, w2, _pad_rows(do2, group),
        eps, True, True, group, scratch, residual)
    return (dx[:x2.shape[0]].reshape(x.shape), *grads)


def fused_ln_mlp_int4_dw_bwd_ref(x, gamma, beta, w1, b1, w2, do, eps, *,
                                 scratch=None, residual=True):
    """The twin of `fused_ln_mlp_int4_dw_bwd`: int8_dw at vitax's group."""
    return fused_ln_mlp_int4_bwd_ref(x, gamma, beta, w1, b1, w2, do, eps,
                                     int8_dw=True, scratch=scratch,
                                     residual=residual)


def fused_ln_mlp_int4_bwd(x, gamma, beta, w1, b1, w2, do, eps, *,
                          scratch=None, residual=True):
    """Backward of `fused_ln_mlp_int4` under int4_grad (K11-B,
    ln_mlp_int8_bwd.cu at L = 7): dx (x's shape, bf16) and fp32 dγ, dβ
    [D], dW1 [D,M], db1 [M], dW2 [M,D], db2 [D]; the weight grads bf16
    products in fp32. residual=False is `fused_ln_mlp_int4_partial_bwd`."""
    if not residual:
        return fused_ln_mlp_int4_partial_bwd(x, gamma, beta, w1, b1, w2, do,
                                             eps, scratch=scratch)
    if not x.is_cuda:
        return fused_ln_mlp_int4_bwd_ref(x, gamma, beta, w1, b1, w2, do, eps,
                                         scratch=scratch)
    out = _ln_mlp_int8_bwd_cuda("fused_ln_mlp_int4_bwd", x, gamma, beta, w1,
                                b1, w2, do, eps, False, scratch, int4=True)
    fused_ln_mlp_int4_bwd.launches += 1
    return out


fused_ln_mlp_int4_bwd.launches = 0


def fused_ln_mlp_int4_partial_bwd(x, gamma, beta, w1, b1, w2, do, eps, *,
                                  scratch=None):
    """K11-B without the residual's dx (vitax's :1096). Counted apart."""
    if not x.is_cuda:
        return fused_ln_mlp_int4_bwd_ref(x, gamma, beta, w1, b1, w2, do, eps,
                                         scratch=scratch, residual=False)
    out = _ln_mlp_int8_bwd_cuda("fused_ln_mlp_int4_partial_bwd", x, gamma,
                                beta, w1, b1, w2, do, eps, False, scratch,
                                int4=True, residual=False)
    fused_ln_mlp_int4_partial_bwd.launches += 1
    return out


fused_ln_mlp_int4_partial_bwd.launches = 0


def fused_ln_mlp_int4_dw_bwd(x, gamma, beta, w1, b1, w2, do, eps, *,
                             scratch=None, residual=True):
    """`fused_ln_mlp_int4_bwd` under int8_dw: dW1 and dW2 are Σ over groups
    of vitax's rows (`mlp_int4_dw_group`; the rows padded with zeros to
    whole groups) of int8 products of both operands packed fresh per
    column. `scratch` also receives those column codes, h1c and doc (dW2),
    xnc and dh1c (dW1), as [padded rows, width] with one scale a column a
    group. residual=False is `fused_ln_mlp_int4_partial_dw_bwd`."""
    if not residual:
        return fused_ln_mlp_int4_partial_dw_bwd(x, gamma, beta, w1, b1, w2,
                                                do, eps, scratch=scratch)
    if not x.is_cuda:
        return fused_ln_mlp_int4_dw_bwd_ref(x, gamma, beta, w1, b1, w2, do,
                                            eps, scratch=scratch)
    out = _ln_mlp_int8_bwd_cuda("fused_ln_mlp_int4_dw_bwd", x, gamma, beta,
                                w1, b1, w2, do, eps, True, scratch, int4=True)
    fused_ln_mlp_int4_dw_bwd.launches += 1
    return out


fused_ln_mlp_int4_dw_bwd.launches = 0


def fused_ln_mlp_int4_partial_dw_bwd(x, gamma, beta, w1, b1, w2, do, eps, *,
                                     scratch=None):
    """`fused_ln_mlp_int4_dw_bwd` without the residual's dx (:1096 with
    its `int8_dw` branch). Counted apart."""
    if not x.is_cuda:
        return fused_ln_mlp_int4_dw_bwd_ref(x, gamma, beta, w1, b1, w2, do,
                                            eps, scratch=scratch,
                                            residual=False)
    out = _ln_mlp_int8_bwd_cuda("fused_ln_mlp_int4_partial_dw_bwd", x, gamma,
                                beta, w1, b1, w2, do, eps, True, scratch,
                                int4=True, residual=False)
    fused_ln_mlp_int4_partial_dw_bwd.launches += 1
    return out


fused_ln_mlp_int4_partial_dw_bwd.launches = 0


def fused_ln_qkvo_attention_int4_ref(x, gamma, beta, wqkv, bqkv, wo, bo, eps,
                                     seq_len, heads, head_dim, kv_heads=None,
                                     *, scratch=None):
    """K11-C with the TPU kernel's rounding points
    (_ln_qkvo_fwd_int4_kernel, pallas_kernels.py:2756-2798): K3's twin on
    the int4 grid, xq from the fp32 LN output, aq from the fp32 attn, no
    residual. kv_heads < heads: the packed GQA layout (_kv_off :2803)."""
    return _qkvo_quant_fwd_ref(x, gamma, beta, wqkv, bqkv, wo, bo, eps,
                               seq_len, heads, head_dim, kv_heads, scratch,
                               True)


def fused_ln_qkvo_attention_int4(x, gamma, beta, wqkv, bqkv, wo, bo, eps,
                                 seq_len, heads, head_dim, int8_grad=False,
                                 int8_dw=False, int4_grad=False,
                                 kv_heads=None, *, scratch=None):
    """`fused_ln_qkvo_attention` with A4W4 QKV and out-projections (K11-C,
    ln_qkvo_attention_int8.cu at L = 7); the core stays bf16 with fp32
    softmax. Under autograd the backward follows vitax's (:3246):
    `int8_grad` (the caller's int8 and int8_grad) with `int4_grad` is
    K11-D, `int8_grad` alone K3's backward (their int8 weight grads under
    `int8_dw`), else K1's. kv_heads < heads: `fused_ln_qkvo_attention_
    int4_gqa` (Res-ViT's). `scratch`: as `fused_ln_mlp_int8`'s."""
    if _gqa(heads, kv_heads):
        return fused_ln_qkvo_attention_int4_gqa(
            x, gamma, beta, wqkv, bqkv, wo, bo, eps, seq_len, heads, head_dim,
            kv_heads, int8_grad, int8_dw, int4_grad, scratch=scratch)
    if _needs_grad(x, gamma, beta, wqkv, bqkv, wo, bo):
        return FusedLnQkvoAttentionFn.apply(x, gamma, beta, wqkv, bqkv, wo, bo,
                                            eps, seq_len, heads, head_dim,
                                            True, int8_grad, int8_dw, None,
                                            True, int4_grad)
    if not x.is_cuda:
        return fused_ln_qkvo_attention_int4_ref(x, gamma, beta, wqkv, bqkv, wo,
                                                bo, eps, seq_len, heads,
                                                head_dim, scratch=scratch)
    out = _ln_qkvo_int8_cuda("fused_ln_qkvo_attention_int4", x, gamma, beta,
                             wqkv, bqkv, wo, bo, eps, seq_len, heads,
                             head_dim, heads, scratch, int4=True)
    fused_ln_qkvo_attention_int4.launches += 1
    return out


fused_ln_qkvo_attention_int4.launches = 0


def fused_ln_qkvo_attention_int4_gqa_ref(x, gamma, beta, wqkv, bqkv, wo, bo,
                                         eps, seq_len, heads, head_dim,
                                         kv_heads, *, scratch=None):
    """The twin of `fused_ln_qkvo_attention_int4_gqa`: K11-C's twin on the
    packed GQA layout."""
    return fused_ln_qkvo_attention_int4_ref(x, gamma, beta, wqkv, bqkv, wo,
                                            bo, eps, seq_len, heads,
                                            head_dim, kv_heads,
                                            scratch=scratch)


def fused_ln_qkvo_attention_int4_gqa(x, gamma, beta, wqkv, bqkv, wo, bo, eps,
                                     seq_len, heads, head_dim, kv_heads,
                                     int8_grad=False, int8_dw=False,
                                     int4_grad=False, *, scratch=None):
    """G-F: K11-C with kv_heads < heads on the packed [q (H·Hd) | k (Hkv·Hd)
    | v (Hkv·Hd)] layout (the kv_heads branch of _ln_qkvo_fwd_int4_kernel
    :2745, pallas_call :3137; ln_qkvo_attention_int8.cu at L = 7 with
    kv_heads, as K7's int8 tier). Under autograd its backward is G-B
    (`fused_ln_qkvo_attention_int4_gqa_bwd`, `_dw_bwd` under int8_dw) with
    `int8_grad` and `int4_grad`, K7's int8 backward with `int8_grad`
    alone, else K7's bf16 backward, as vitax's (:3246)."""
    if _needs_grad(x, gamma, beta, wqkv, bqkv, wo, bo):
        return FusedLnQkvoAttentionFn.apply(x, gamma, beta, wqkv, bqkv, wo, bo,
                                            eps, seq_len, heads, head_dim,
                                            True, int8_grad, int8_dw, kv_heads,
                                            True, int4_grad)
    if not x.is_cuda:
        return fused_ln_qkvo_attention_int4_gqa_ref(
            x, gamma, beta, wqkv, bqkv, wo, bo, eps, seq_len, heads, head_dim,
            kv_heads, scratch=scratch)
    out = _ln_qkvo_int8_cuda("fused_ln_qkvo_attention_int4_gqa", x, gamma,
                             beta, wqkv, bqkv, wo, bo, eps, seq_len, heads,
                             head_dim, kv_heads, scratch, int4=True)
    fused_ln_qkvo_attention_int4_gqa.launches += 1
    return out


fused_ln_qkvo_attention_int4_gqa.launches = 0


def fused_ln_qkvo_attention_int4_bwd_ref(x, gamma, beta, wqkv, bqkv, wo, do,
                                         eps, seq_len, heads, head_dim,
                                         kv_heads=None, *, int8_dw=False,
                                         group=None, scratch=None):
    """(dx, dγ, dβ, dWqkv, dbqkv, dWo, dbo) of K11-D, the int4_grad branch
    of _ln_qkvo_bwd_int8_kernel (pallas_kernels.py:2977-3107, _qr =
    _quant_rows4, the weights by _quant_cols_host4 and _quant_rows_host4,
    :3247-3250): K3's backward twin on the int4 grid, the core grads bf16.
    dW, dWo: bf16 products, or with `int8_dw` Σ over groups of `group` rows
    (whole images, `qkvo_dw_group`, by default) of int8 products of both
    operands packed fresh per column: attn with do, the fp32 xn with
    dqkv. kv_heads < heads: the packed GQA layout, dK and dV of a kv group
    summed over its query heads in fp32 (G-B's twin)."""
    return _qkvo_quant_bwd_ref(x, gamma, beta, wqkv, bqkv, wo, do, eps,
                               seq_len, heads, head_dim, kv_heads, int8_dw,
                               group, scratch, True)


def fused_ln_qkvo_attention_int4_dw_bwd_ref(x, gamma, beta, wqkv, bqkv, wo,
                                            do, eps, seq_len, heads, head_dim,
                                            kv_heads=None, *, scratch=None):
    """The twin of `fused_ln_qkvo_attention_int4_dw_bwd`."""
    return fused_ln_qkvo_attention_int4_bwd_ref(
        x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads, head_dim,
        kv_heads, int8_dw=True, scratch=scratch)


def fused_ln_qkvo_attention_int4_bwd(x, gamma, beta, wqkv, bqkv, wo, do, eps,
                                     seq_len, heads, head_dim, kv_heads=None,
                                     *, scratch=None):
    """Backward of `fused_ln_qkvo_attention_int4` under int8_grad and
    int4_grad (K11-D, ln_qkvo_attention_int8_bwd.cu at L = 7): outputs as
    `fused_ln_qkvo_attention_int8_bwd`'s. kv_heads < heads:
    `fused_ln_qkvo_attention_int4_gqa_bwd`."""
    if _gqa(heads, kv_heads):
        return fused_ln_qkvo_attention_int4_gqa_bwd(
            x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads, head_dim,
            kv_heads, scratch=scratch)
    if not x.is_cuda:
        return fused_ln_qkvo_attention_int4_bwd_ref(
            x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads, head_dim,
            scratch=scratch)
    out = _ln_qkvo_int8_bwd_cuda("fused_ln_qkvo_attention_int4_bwd", x, gamma,
                                 beta, wqkv, bqkv, wo, do, eps, seq_len,
                                 heads, head_dim, heads, False, scratch,
                                 int4=True)
    fused_ln_qkvo_attention_int4_bwd.launches += 1
    return out


fused_ln_qkvo_attention_int4_bwd.launches = 0


def fused_ln_qkvo_attention_int4_dw_bwd(x, gamma, beta, wqkv, bqkv, wo, do,
                                        eps, seq_len, heads, head_dim,
                                        kv_heads=None, *, scratch=None):
    """`fused_ln_qkvo_attention_int4_bwd` under int8_dw: dWqkv and dWo are
    Σ over K3's groups (whole images, `qkvo_dw_group`) of int8 products of
    both operands packed fresh per column. `scratch` also receives those
    column codes, atc and doc (dWo), xnc and dqc (dW), as [rows, width]
    with one scale a column a group. kv_heads < heads:
    `fused_ln_qkvo_attention_int4_gqa_dw_bwd`."""
    if _gqa(heads, kv_heads):
        return fused_ln_qkvo_attention_int4_gqa_dw_bwd(
            x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads, head_dim,
            kv_heads, scratch=scratch)
    if not x.is_cuda:
        return fused_ln_qkvo_attention_int4_dw_bwd_ref(
            x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads, head_dim,
            scratch=scratch)
    out = _ln_qkvo_int8_bwd_cuda("fused_ln_qkvo_attention_int4_dw_bwd", x,
                                 gamma, beta, wqkv, bqkv, wo, do, eps, seq_len,
                                 heads, head_dim, heads, True, scratch,
                                 int4=True)
    fused_ln_qkvo_attention_int4_dw_bwd.launches += 1
    return out


fused_ln_qkvo_attention_int4_dw_bwd.launches = 0


def fused_ln_qkvo_attention_int4_gqa_bwd_ref(x, gamma, beta, wqkv, bqkv, wo,
                                             do, eps, seq_len, heads,
                                             head_dim, kv_heads, *,
                                             scratch=None):
    """The twin of `fused_ln_qkvo_attention_int4_gqa_bwd`."""
    return fused_ln_qkvo_attention_int4_bwd_ref(
        x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads, head_dim,
        kv_heads, scratch=scratch)


def fused_ln_qkvo_attention_int4_gqa_bwd(x, gamma, beta, wqkv, bqkv, wo, do,
                                         eps, seq_len, heads, head_dim,
                                         kv_heads, *, scratch=None):
    """G-B: K11-D with kv_heads < heads (the kv_heads branch of
    _ln_qkvo_bwd_int8_kernel :2977 under int4_grad, pallas_call :3252), the
    outputs of `fused_ln_qkvo_attention_int4_bwd` on the packed GQA
    layout, dK and dV of each kv group summed over its query heads in fp32
    before one cast (K7's)."""
    if not x.is_cuda:
        return fused_ln_qkvo_attention_int4_gqa_bwd_ref(
            x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads, head_dim,
            kv_heads, scratch=scratch)
    out = _ln_qkvo_int8_bwd_cuda("fused_ln_qkvo_attention_int4_gqa_bwd", x,
                                 gamma, beta, wqkv, bqkv, wo, do, eps, seq_len,
                                 heads, head_dim, kv_heads, False, scratch,
                                 int4=True)
    fused_ln_qkvo_attention_int4_gqa_bwd.launches += 1
    return out


fused_ln_qkvo_attention_int4_gqa_bwd.launches = 0


def fused_ln_qkvo_attention_int4_gqa_dw_bwd_ref(x, gamma, beta, wqkv, bqkv,
                                                wo, do, eps, seq_len, heads,
                                                head_dim, kv_heads, *,
                                                scratch=None):
    """The twin of `fused_ln_qkvo_attention_int4_gqa_dw_bwd`."""
    return fused_ln_qkvo_attention_int4_dw_bwd_ref(
        x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads, head_dim,
        kv_heads, scratch=scratch)


def fused_ln_qkvo_attention_int4_gqa_dw_bwd(x, gamma, beta, wqkv, bqkv, wo,
                                            do, eps, seq_len, heads, head_dim,
                                            kv_heads, *, scratch=None):
    """G-B under int8_dw (:3033-3040, :3071-3076 with kv_heads): dWqkv [D,
    (H + 2·Hkv)·Hd] and dWo are Σ over K3's groups of int8 products of both
    operands packed fresh per column."""
    if not x.is_cuda:
        return fused_ln_qkvo_attention_int4_gqa_dw_bwd_ref(
            x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads, head_dim,
            kv_heads, scratch=scratch)
    out = _ln_qkvo_int8_bwd_cuda("fused_ln_qkvo_attention_int4_gqa_dw_bwd", x,
                                 gamma, beta, wqkv, bqkv, wo, do, eps, seq_len,
                                 heads, head_dim, kv_heads, True, scratch,
                                 int4=True)
    fused_ln_qkvo_attention_int4_gqa_dw_bwd.launches += 1
    return out


fused_ln_qkvo_attention_int4_gqa_dw_bwd.launches = 0


# =============================================================================
# K12 — the save-acts MLP half, bf16 and int8: the forward also writes what
# the backward needs (h1 and g', or h1q, sh and gpq) and the backward reads
# it instead of recomputing fc1 (vitax's fused_ln_mlp(save_acts=True),
# pallas_kernels.py:2123-2169, custom VJPs :1985-2004 and :2100-2118)
# =============================================================================

_SAVE_DTYPES = {"x": _BF, "do": _BF, "gamma": _F32, "beta": _F32, "w1": _BF,
                "b1": _F32, "w2": _BF, "b2": _F32, "h1": _BF, "gp": _BF,
                "h1q": torch.int8, "sh": _F32, "gpq": torch.int8}


def _check_save(name, tensors, shapes):
    """K12's launch checks: device, dtypes and contiguity of `tensors`, the
    GEMM shapes of x, w1 and w2, and each tensor of `shapes` {key: shape}.
    Returns (dev, x as [N, D])."""
    x, w1, w2 = tensors["x"], tensors["w1"], tensors["w2"]
    dev = _check_cuda(name, tensors, {k: _SAVE_DTYPES[k] for k in tensors})
    x2 = x.view(-1, x.shape[-1])
    if not ln_mlp_supported(x2.unsqueeze(0), w1, w2):
        raise ValueError(f"{name}: unsupported shapes x {tuple(x.shape)} w1 "
                         f"{tuple(w1.shape)} w2 {tuple(w2.shape)}")
    for key, shape in shapes.items():
        _check_shape(name, key, tensors[key], shape)
    return dev, x2


def fused_ln_mlp_save_ref(x, gamma, beta, w1, b1, w2, b2, eps,
                          residual=True):
    """K12's forward with the TPU kernel's rounding points
    (_ln_mlp_fwd_save_kernel, pallas_kernels.py:620-656): K2's out (without
    `x +` when not residual, :653), and h1 = bf16(gelu(a1)) and
    g' = bf16(gelu'(a1)) [N, M] in x.dtype, g' the exact-erf derivative in
    fp32 (:577-584)."""
    out, a1, h1 = _ln_mlp_twin(x, gamma, beta, w1, b1, w2, b2, eps, residual)
    m = w1.shape[-1]
    return (out, h1.reshape(-1, m),
            gelu_exact_grad(a1).to(x.dtype).reshape(-1, m))


def fused_ln_mlp_save(x, gamma, beta, w1, b1, w2, b2, eps, residual=True):
    """K12's forward (:1687): (out, h1, g'), out `fused_ln_mlp`'s to the bit
    (the same launches compute it), h1 and g' bf16 [N, M] for
    `fused_ln_mlp_bwd_fast`. residual=False is `fused_ln_mlp_save_partial`."""
    if not residual:
        return fused_ln_mlp_save_partial(x, gamma, beta, w1, b1, w2, b2, eps)
    if not x.is_cuda:
        return fused_ln_mlp_save_ref(x, gamma, beta, w1, b1, w2, b2, eps)
    out = _ln_mlp_save_fwd_cuda("fused_ln_mlp_save", x, gamma, beta, w1, b1,
                                w2, b2, eps, True)
    fused_ln_mlp_save.launches += 1
    return out


fused_ln_mlp_save.launches = 0


def fused_ln_mlp_save_partial(x, gamma, beta, w1, b1, w2, b2, eps):
    """K12's forward without `x +` (ln_mlp_save.cu with residual 0, vitax's
    :653): (partial, h1, g'). Counted apart."""
    if not x.is_cuda:
        return fused_ln_mlp_save_ref(x, gamma, beta, w1, b1, w2, b2, eps,
                                     False)
    out = _ln_mlp_save_fwd_cuda("fused_ln_mlp_save_partial", x, gamma, beta,
                                w1, b1, w2, b2, eps, False)
    fused_ln_mlp_save_partial.launches += 1
    return out


fused_ln_mlp_save_partial.launches = 0


def _ln_mlp_save_fwd_cuda(name, x, gamma, beta, w1, b1, w2, b2, eps,
                          residual):
    """K12's forward launch (ln_mlp_save.cu)."""
    d, m = w1.shape
    n = x.numel() // d
    dev, x2 = _check_save(
        name, dict(x=x, gamma=gamma, beta=beta, w1=w1, b1=b1, w2=w2, b2=b2),
        dict(gamma=(d,), beta=(d,), b1=(m,), b2=(d,)))
    xn, h1, gp = _bf(dev, n, d), _bf(dev, n, m), _bf(dev, n, m)
    out = torch.empty_like(x2)
    rc = build.load().vitax_ln_mlp_save_fwd(*(t.data_ptr() for t in (
        x2, gamma, beta, w1, b1, w2, b2, xn, h1, gp, out)), n, d, m, eps,
        int(residual), _stream(dev))
    build.check(rc, name)
    return out.view(x.shape), h1, gp


def fused_ln_mlp_bwd_fast_ref(x, gamma, beta, w1, w2, h1, gp, do, eps,
                              residual=True):
    """(dx, dγ, dβ, dW1, db1, dW2, db2) from the saved h1 and g' with the
    TPU kernel's rounding points (_ln_mlp_bwd_fast_kernel, pallas_kernels.py:
    1253-1290): dh1 = x.dtype(f32(do·W2ᵀ)·f32(g')), db1 over the rounded dh1,
    dx = do + bf16(dx_ln) in x.dtype (without `do +` when not residual,
    :1281); only the LN statistics recomputed."""
    dt = x.dtype
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    do2 = do.reshape(-1, d)
    xhat, rstd = _ln_stats(x2.float(), eps)
    xn = (xhat * gamma.float() + beta.float()).to(dt)
    dh1 = (matmul_f32(do2, w2.t()) * gp.float()).to(dt)
    dxn = matmul_f32(dh1, w1.t())
    dxln, dg, dbe = _ln_bwd_tail(dxn, xhat, rstd, gamma)
    dx = do2 + dxln.to(dt) if residual else dxln.to(dt)
    return (dx.reshape(x.shape), dg, dbe, matmul_f32(xn.t(), dh1),
            dh1.float().sum(dim=0), matmul_f32(h1.t(), do2),
            do2.float().sum(dim=0))


def fused_ln_mlp_bwd_fast(x, gamma, beta, w1, w2, h1, gp, do, eps,
                          residual=True):
    """K12's backward (:1723) from `fused_ln_mlp_save`'s h1 and g': dx (x's
    shape, bf16) and fp32 dγ, dβ [D], dW1 [D,M], db1 [M], dW2 [M,D],
    db2 [D]. residual=False is `fused_ln_mlp_bwd_fast_partial`."""
    if not residual:
        return fused_ln_mlp_bwd_fast_partial(x, gamma, beta, w1, w2, h1, gp,
                                             do, eps)
    if not x.is_cuda:
        return fused_ln_mlp_bwd_fast_ref(x, gamma, beta, w1, w2, h1, gp, do,
                                         eps)
    out = _ln_mlp_bwd_fast_cuda("fused_ln_mlp_bwd_fast", x, gamma, beta, w1,
                                w2, h1, gp, do, eps, True)
    fused_ln_mlp_bwd_fast.launches += 1
    return out


fused_ln_mlp_bwd_fast.launches = 0


def fused_ln_mlp_bwd_fast_partial(x, gamma, beta, w1, w2, h1, gp, do, eps):
    """K12's backward without the residual's dx (ln_mlp_save.cu with
    residual 0, vitax's :1281): dx = bf16(dx_ln). Counted apart."""
    if not x.is_cuda:
        return fused_ln_mlp_bwd_fast_ref(x, gamma, beta, w1, w2, h1, gp, do,
                                         eps, False)
    out = _ln_mlp_bwd_fast_cuda("fused_ln_mlp_bwd_fast_partial", x, gamma,
                                beta, w1, w2, h1, gp, do, eps, False)
    fused_ln_mlp_bwd_fast_partial.launches += 1
    return out


fused_ln_mlp_bwd_fast_partial.launches = 0


def _ln_mlp_bwd_fast_cuda(name, x, gamma, beta, w1, w2, h1, gp, do, eps,
                          residual):
    """K12's backward launch (ln_mlp_save.cu)."""
    d, m = w1.shape
    n = x.numel() // d
    dev, x2 = _check_save(
        name, dict(x=x, gamma=gamma, beta=beta, w1=w1, w2=w2, h1=h1, gp=gp,
                   do=do),
        dict(gamma=(d,), beta=(d,), h1=(n, m), gp=(n, m), do=tuple(x.shape)))
    lib = build.load()
    dx, dg, dbe = _bf(dev, n, d), _f32(dev, d), _f32(dev, d)
    dw1, db1, dw2, db2 = (_f32(dev, d, m), _f32(dev, m), _f32(dev, m, d),
                          _f32(dev, d))
    xn, dh1, dxn = _bf(dev, n, d), _bf(dev, n, m), _f32(dev, n, d)
    ws = _workspace(lib.vitax_ln_mlp_bwd_ws(n, d, m), dev)
    rc = lib.vitax_ln_mlp_bwd_fast(*(t.data_ptr() for t in (
        x2, gamma, beta, w1, w2, h1, gp, do, dx, dg, dbe, dw1, db1, dw2, db2,
        xn, dh1, dxn, ws)), n, d, m, eps, int(residual), _stream(dev))
    build.check(rc, name)
    return dx.view(x.shape), dg, dbe, dw1, db1, dw2, db2


def _gp_scale(like):
    """gpq's one static scale, for `scratch`."""
    return torch.full((1,), GP_DEQUANT, dtype=_F32, device=like.device)


def fused_ln_mlp_int8_save_ref(x, gamma, beta, w1, b1, w2, b2, eps, *,
                               scratch=None, residual=True):
    """K12-int8's forward with the TPU kernel's rounding points
    (_ln_mlp_fwd_int8_save_kernel, pallas_kernels.py:741-775): K4's out
    (without `x +` when not residual, :772), its h1q [N, M] and row scales
    sh [N] (vitax keeps sh as [N, 128] equal lanes), and
    gpq = clip(round(gelu_grad_q(a1)·127/1.13)) int8 [N, M]."""
    out, a1, h1q, sh = _ln_mlp_int8_twin(x, gamma, beta, w1, b1, w2, b2, eps,
                                         scratch, residual=residual)
    gpq = pack_i8(gelu_grad_q(a1) * GP_QSCALE)
    _keep(scratch, gpq=(gpq, _gp_scale(gpq)))
    return out, h1q, sh.reshape(-1), gpq


def fused_ln_mlp_int8_save(x, gamma, beta, w1, b1, w2, b2, eps,
                           residual=True, *, scratch=None):
    """K12-int8's forward (:2025): (out, h1q, sh, gpq), out
    `fused_ln_mlp_int8`'s to the bit (the same launches compute it). A
    `scratch` dict receives the codes, keyed and laid out as the twin's.
    residual=False is `fused_ln_mlp_int8_save_partial`."""
    if not residual:
        return fused_ln_mlp_int8_save_partial(x, gamma, beta, w1, b1, w2, b2,
                                              eps, scratch=scratch)
    if not x.is_cuda:
        return fused_ln_mlp_int8_save_ref(x, gamma, beta, w1, b1, w2, b2, eps,
                                          scratch=scratch)
    out = _ln_mlp_int8_save_fwd_cuda("fused_ln_mlp_int8_save", x, gamma,
                                     beta, w1, b1, w2, b2, eps, True, scratch)
    fused_ln_mlp_int8_save.launches += 1
    return out


fused_ln_mlp_int8_save.launches = 0


def fused_ln_mlp_int8_save_partial(x, gamma, beta, w1, b1, w2, b2, eps, *,
                                   scratch=None):
    """K12-int8's forward without `x +` (ln_mlp_int8_save.cu with residual
    0, vitax's :772): (partial, h1q, sh, gpq). Counted apart."""
    if not x.is_cuda:
        return fused_ln_mlp_int8_save_ref(x, gamma, beta, w1, b1, w2, b2, eps,
                                          scratch=scratch, residual=False)
    out = _ln_mlp_int8_save_fwd_cuda("fused_ln_mlp_int8_save_partial", x,
                                     gamma, beta, w1, b1, w2, b2, eps, False,
                                     scratch)
    fused_ln_mlp_int8_save_partial.launches += 1
    return out


fused_ln_mlp_int8_save_partial.launches = 0


def _ln_mlp_int8_save_fwd_cuda(name, x, gamma, beta, w1, b1, w2, b2, eps,
                               residual, scratch):
    """K12-int8's forward launch (ln_mlp_int8_save.cu)."""
    d, m = w1.shape
    n = x.numel() // d
    dev, x2 = _check_save(
        name, dict(x=x, gamma=gamma, beta=beta, w1=w1, b1=b1, w2=w2, b2=b2),
        dict(gamma=(d,), beta=(d,), b1=(m,), b2=(d,)))
    w1t, s1 = _i8(dev, m, d), _f32(dev, m)  # per column, as [N, K]
    w2t, s2 = _i8(dev, d, m), _f32(dev, d)
    xq, sx, g = _i8(dev, n, d), _f32(dev, n), _f32(dev, n, m)
    h1q, sh, gpq = _i8(dev, n, m), _f32(dev, n), _i8(dev, n, m)
    out = torch.empty_like(x2)
    rc = build.load().vitax_ln_mlp_int8_save_fwd(*(t.data_ptr() for t in (
        x2, gamma, beta, w1, b1, w2, b2, w1t, s1, w2t, s2, xq, sx, g, h1q, sh,
        gpq, out)), n, d, m, eps, int(residual), _stream(dev))
    build.check(rc, name)
    _keep(scratch, w1q=(w1t.t(), s1), w2q=(w2t.t(), s2), xq=(xq, sx),
          h1q=(h1q, sh), gpq=(gpq, _gp_scale(gpq)))
    return out.view(x.shape), h1q, sh, gpq


def fused_ln_mlp_int8_save_bwd_ref(x, gamma, beta, w1, w2, h1q, sh, gpq, do,
                                   eps, *, int8_dw=False, group=None,
                                   scratch=None, residual=True):
    """(dx, dγ, dβ, dW1, db1, dW2, db2) from the saved codes with the TPU
    kernel's rounding points (_ln_mlp_bwd_int8_save_kernel,
    pallas_kernels.py:789-864): dh1_32 = f32(doq·W2rᵀ)·(sdo·1.13/127)·s2r·
    f32(gpq), dxn = f32(dh1q·W1rᵀ)·sd·s1r, db1 = Σ dh1_32; dW2 =
    x.dtype(h1q)ᵀ·x.dtype(sh·do) and dW1 = xnᵀ·x.dtype(dh1_32), or with
    `int8_dw` the per-group int8 products over `group` rows (MLP_DW_GROUP by
    default): dW2 from h1q and the column codes of sh·do, dW1 from the
    column codes of xn·sd and dh1q. dx without `do +` when not residual
    (:862)."""
    dt = x.dtype
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    do2 = do.reshape(-1, d)
    sh = sh.reshape(-1, 1)
    w1r, s1r = quant_rows_host(w1)
    w2r, s2r = quant_rows_host(w2)
    xhat, rstd = _ln_stats(x2.float(), eps)
    xn = _affine(xhat, gamma, beta).to(dt)
    doq, sdo = quant_rows(do2.float())
    dh1_32 = (_dequant(int_mm(doq, w2r.t()), sdo * GP_DEQUANT, s2r)
              * gpq.float())
    dh1q, sd = quant_rows(dh1_32)
    if int8_dw:
        group = group or MLP_DW_GROUP
        dw2t, doc = _dw_int8(do2, sh, h1q, group)
        dw2 = dw2t.t()
        dw1, xnc = _dw_int8(xn, sd, dh1q, group)
        _keep(scratch, doc=doc, xnc=xnc)
    else:
        dw2 = matmul_f32(h1q.to(dt).t(), (sh * do2.float()).to(dt))
        dw1 = matmul_f32(xn.t(), dh1_32.to(dt))
    dxn = _dequant(int_mm(dh1q, w1r.t()), sd, s1r)
    dxln, dg, dbe = _ln_bwd_tail(dxn, xhat, rstd, gamma)
    _keep(scratch, w1r=(w1r, s1r), w2r=(w2r, s2r), doq=(doq, sdo),
          dh1q=(dh1q, sd))
    dx = do2 + dxln.to(dt) if residual else dxln.to(dt)
    return (dx.reshape(x.shape), dg, dbe, dw1, dh1_32.sum(dim=0), dw2,
            do2.float().sum(dim=0))


def fused_ln_mlp_int8_save_dw_bwd_ref(x, gamma, beta, w1, w2, h1q, sh, gpq,
                                      do, eps, *, scratch=None,
                                      residual=True):
    """The twin of `fused_ln_mlp_int8_save_dw_bwd`: int8_dw at the port's
    group (MLP_DW_GROUP rows)."""
    return fused_ln_mlp_int8_save_bwd_ref(x, gamma, beta, w1, w2, h1q, sh,
                                          gpq, do, eps, int8_dw=True,
                                          group=MLP_DW_GROUP, scratch=scratch,
                                          residual=residual)


def _ln_mlp_int8_save_bwd_cuda(name, x, gamma, beta, w1, w2, h1q, sh, gpq, do,
                               eps, int8_dw, scratch, residual=True):
    """K12-int8's backward launch (ln_mlp_int8_save.cu)."""
    d, m = w1.shape
    n = x.numel() // d
    dev, x2 = _check_save(
        name, dict(x=x, gamma=gamma, beta=beta, w1=w1, w2=w2, h1q=h1q, sh=sh,
                   gpq=gpq, do=do),
        dict(gamma=(d,), beta=(d,), h1q=(n, m), sh=(n,), gpq=(n, m),
             do=tuple(x.shape)))
    lib = build.load()
    w1r, s1r = _i8(dev, d, m), _f32(dev, d)  # per row
    w2r, s2r = _i8(dev, m, d), _f32(dev, m)
    dx, dg, dbe = torch.empty_like(x2), _f32(dev, d), _f32(dev, d)
    dw1, db1, dw2, db2 = (_f32(dev, d, m), _f32(dev, m), _f32(dev, m, d),
                          _f32(dev, d))
    xn, doq, sdo = _bf(dev, n, d), _i8(dev, n, d), _f32(dev, n)
    dh1f, dh1 = _f32(dev, n, m), _bf(dev, n, m)
    dh1q, sdh, dxn = _i8(dev, n, m), _f32(dev, n), _f32(dev, n, d)
    ws = _workspace(lib.vitax_ln_mlp_bwd_ws(n, d, m), dev)
    if int8_dw:  # doct, sdoc, h1qt, xnct, sxn, dh1qt (dw_int8.cuh)
        groups, kp = _dw_layout(n, MLP_DW_GROUP)
        extra = [None, None, _i8(dev, d, kp), _f32(dev, groups, d),
                 _i8(dev, m, kp), _i8(dev, d, kp), _f32(dev, groups, d),
                 _i8(dev, m, kp)]
    else:  # the bf16 dW2 operands, bf16(h1q) and bf16(sh·do)
        extra = [_bf(dev, n, m), _bf(dev, n, d)] + [None] * 6
    rc = lib.vitax_ln_mlp_int8_save_bwd(*(t.data_ptr() for t in (
        x2, gamma, beta, w1, w2, h1q, sh, gpq, do, dx, dg, dbe, dw1, db1, dw2,
        db2, w1r, s1r, w2r, s2r, xn, doq, sdo, dh1f, dh1, dh1q, sdh, dxn, ws)),
        *(None if t is None else t.data_ptr() for t in extra),
        n, d, m, MLP_DW_GROUP, int(int8_dw), eps, int(residual), _stream(dev))
    build.check(rc, name)
    _keep(scratch, w1r=(w1r, s1r), w2r=(w2r, s2r), doq=(doq, sdo),
          dh1q=(dh1q, sdh))
    if int8_dw:
        _keep(scratch, doc=(_group_codes(extra[2], n, MLP_DW_GROUP), extra[3]),
              xnc=(_group_codes(extra[5], n, MLP_DW_GROUP), extra[6]))
    return dx.view(x.shape), dg, dbe, dw1, db1, dw2, db2


def fused_ln_mlp_int8_save_bwd(x, gamma, beta, w1, w2, h1q, sh, gpq, do, eps,
                               *, scratch=None, residual=True):
    """K12-int8's backward (:2066, int8_dw off) from
    `fused_ln_mlp_int8_save`'s codes: dx (x's shape, bf16) and fp32 dγ, dβ
    [D], dW1 [D,M], db1 [M], dW2 [M,D], db2 [D]. residual=False is
    `fused_ln_mlp_int8_save_partial_bwd`."""
    if not residual:
        return fused_ln_mlp_int8_save_partial_bwd(
            x, gamma, beta, w1, w2, h1q, sh, gpq, do, eps, scratch=scratch)
    if not x.is_cuda:
        return fused_ln_mlp_int8_save_bwd_ref(x, gamma, beta, w1, w2, h1q, sh,
                                              gpq, do, eps, scratch=scratch)
    out = _ln_mlp_int8_save_bwd_cuda("fused_ln_mlp_int8_save_bwd", x, gamma,
                                     beta, w1, w2, h1q, sh, gpq, do, eps,
                                     False, scratch)
    fused_ln_mlp_int8_save_bwd.launches += 1
    return out


fused_ln_mlp_int8_save_bwd.launches = 0


def fused_ln_mlp_int8_save_partial_bwd(x, gamma, beta, w1, w2, h1q, sh, gpq,
                                       do, eps, *, scratch=None):
    """K12-int8's backward without the residual's dx (vitax's :862).
    Counted apart."""
    if not x.is_cuda:
        return fused_ln_mlp_int8_save_bwd_ref(x, gamma, beta, w1, w2, h1q, sh,
                                              gpq, do, eps, scratch=scratch,
                                              residual=False)
    out = _ln_mlp_int8_save_bwd_cuda("fused_ln_mlp_int8_save_partial_bwd", x,
                                     gamma, beta, w1, w2, h1q, sh, gpq, do,
                                     eps, False, scratch, residual=False)
    fused_ln_mlp_int8_save_partial_bwd.launches += 1
    return out


fused_ln_mlp_int8_save_partial_bwd.launches = 0


def fused_ln_mlp_int8_save_dw_bwd(x, gamma, beta, w1, w2, h1q, sh, gpq, do,
                                  eps, *, scratch=None, residual=True):
    """`fused_ln_mlp_int8_save_bwd` under int8_dw (:2066's `int8_dw`
    branch, :816-830): dW1 and dW2 per-group int8 products over groups of
    MLP_DW_GROUP rows, int32 inside a group and fp32 across groups in order;
    dW2 from h1q's codes and the column codes of sh·do (`scratch`: doc),
    dW1 as K4's (xnc). residual=False is
    `fused_ln_mlp_int8_save_partial_dw_bwd`."""
    if not residual:
        return fused_ln_mlp_int8_save_partial_dw_bwd(
            x, gamma, beta, w1, w2, h1q, sh, gpq, do, eps, scratch=scratch)
    if not x.is_cuda:
        return fused_ln_mlp_int8_save_dw_bwd_ref(x, gamma, beta, w1, w2, h1q,
                                                 sh, gpq, do, eps,
                                                 scratch=scratch)
    out = _ln_mlp_int8_save_bwd_cuda("fused_ln_mlp_int8_save_dw_bwd", x, gamma,
                                     beta, w1, w2, h1q, sh, gpq, do, eps,
                                     True, scratch)
    fused_ln_mlp_int8_save_dw_bwd.launches += 1
    return out


fused_ln_mlp_int8_save_dw_bwd.launches = 0


def fused_ln_mlp_int8_save_partial_dw_bwd(x, gamma, beta, w1, w2, h1q, sh,
                                          gpq, do, eps, *, scratch=None):
    """`fused_ln_mlp_int8_save_dw_bwd` without the residual's dx (:862 with
    its `int8_dw` branch). Counted apart."""
    if not x.is_cuda:
        return fused_ln_mlp_int8_save_dw_bwd_ref(x, gamma, beta, w1, w2, h1q,
                                                 sh, gpq, do, eps,
                                                 scratch=scratch,
                                                 residual=False)
    out = _ln_mlp_int8_save_bwd_cuda("fused_ln_mlp_int8_save_partial_dw_bwd",
                                     x, gamma, beta, w1, w2, h1q, sh, gpq, do,
                                     eps, True, scratch, residual=False)
    fused_ln_mlp_int8_save_partial_dw_bwd.launches += 1
    return out


fused_ln_mlp_int8_save_partial_dw_bwd.launches = 0


class FusedLnMlpSaveFn(torch.autograd.Function):
    """The save-acts MLP half (vitax's _ln_mlp_2d_save :1985-2004 and
    _ln_mlp_2d_int8s :2100-2118): the forward is K12's (`int8`: its W8A8
    tier), which also hands out h1 and g' (or h1q, sh and gpq); it saves
    them beside (x, γ, β, W1, W2), and the backward reads them: K12's
    (`int8_dw`: its per-group int8 weight grads). `residual=False`: the
    kernels' branches without `x +` and without `do +` in dx."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, eps, int8, int8_dw,
                residual=True):
        fwd = fused_ln_mlp_int8_save if int8 else fused_ln_mlp_save
        out, *acts = fwd(x, gamma, beta, w1, b1, w2, b2, eps,
                         residual=residual)
        ctx.save_for_backward(x, gamma, beta, w1, w2, *acts)
        ctx.eps = eps
        ctx.tier = (int8, int8_dw, residual)
        ctx.bias_dtypes = (b1.dtype, b2.dtype)
        return out

    @staticmethod
    def backward(ctx, do):
        x, gamma, beta, w1, w2, *acts = ctx.saved_tensors
        int8, int8_dw, residual = ctx.tier
        bwd = (fused_ln_mlp_bwd_fast if not int8
               else fused_ln_mlp_int8_save_dw_bwd if int8_dw
               else fused_ln_mlp_int8_save_bwd)
        dx, dg, dbe, dw1, db1, dw2, db2 = bwd(x, gamma, beta, w1, w2, *acts,
                                              do.contiguous(), ctx.eps,
                                              residual=residual)
        return (dx, dg.to(gamma.dtype), dbe.to(beta.dtype), dw1.to(w1.dtype),
                db1.to(ctx.bias_dtypes[0]), dw2.to(w2.dtype),
                db2.to(ctx.bias_dtypes[1]), None, None, None, None)


def fused_ln_qkvo_attention_int8_ref(x, gamma, beta, wqkv, bqkv, wo, bo, eps,
                                     seq_len, heads, head_dim, kv_heads=None,
                                     *, scratch=None):
    """K3 forward with the TPU kernel's rounding points
    (_ln_qkvo_fwd_int8_kernel, pallas_kernels.py:2699-2742): xq from the
    fp32 LN output, qkv = bf16(f32(xq·Wq)·sx·sw + b), the bf16 core with
    fp32 softmax, attn the fp32 heads' p·v (never rounded) quantized per
    row, out = bf16(f32(aq·Woq)·sa·swo + bo), no residual. kv_heads <
    heads: the packed GQA layout (_kv_off :2803; K7's int8 tier)."""
    return _qkvo_quant_fwd_ref(x, gamma, beta, wqkv, bqkv, wo, bo, eps,
                               seq_len, heads, head_dim, kv_heads, scratch,
                               False)


def _qkvo_quant_fwd_ref(x, gamma, beta, wqkv, bqkv, wo, bo, eps, seq_len,
                        heads, head_dim, kv_heads, scratch, int4):
    """K3's forward twin, or with `int4` K11-C's."""
    rows, cols_host, _ = _quantizers(int4)
    dt = x.dtype
    b, spq, d = x.shape
    w8, sw = cols_host(wqkv)
    wo8, swo = cols_host(wo)
    xhat, _ = _ln_stats(x.reshape(-1, d).float(), eps)
    xq, sx = rows(_affine(xhat, gamma, beta))
    qkv = _dequant(int_mm(xq, w8), sx, sw, bqkv).to(dt)
    *_, o32 = _attn_core(qkv.view(b, spq, -1), seq_len, heads, head_dim,
                         kv_heads)
    aq, sa = rows(_heads_to_rows(o32))
    y = _dequant(int_mm(aq, wo8), sa, swo, bo)
    _keep(scratch, w8=(w8, sw), wo8=(wo8, swo), xq=(xq, sx), aq=(aq, sa))
    return y.to(dt).view(b, spq, d)


def fused_ln_qkvo_attention_int8(x, gamma, beta, wqkv, bqkv, wo, bo, eps,
                                 seq_len, heads, head_dim, int8_grad=False,
                                 int8_dw=False, kv_heads=None, *,
                                 scratch=None):
    """`fused_ln_qkvo_attention` with W8A8 QKV and out-projections (K3); the
    attention core stays bf16 with fp32 softmax. Under autograd the
    backward is K3's int8 backward with `int8_grad` (with its int8 weight
    grads under `int8_dw`), else the bf16 K1 backward. kv_heads < heads:
    `fused_ln_qkvo_attention_int8_gqa` (K7's int8 tier). `scratch`: as
    `fused_ln_mlp_int8`'s."""
    if _gqa(heads, kv_heads):
        return fused_ln_qkvo_attention_int8_gqa(
            x, gamma, beta, wqkv, bqkv, wo, bo, eps, seq_len, heads, head_dim,
            kv_heads, int8_grad, int8_dw, scratch=scratch)
    if _needs_grad(x, gamma, beta, wqkv, bqkv, wo, bo):
        return FusedLnQkvoAttentionFn.apply(x, gamma, beta, wqkv, bqkv, wo, bo,
                                            eps, seq_len, heads, head_dim,
                                            True, int8_grad, int8_dw, None)
    if not x.is_cuda:
        return fused_ln_qkvo_attention_int8_ref(x, gamma, beta, wqkv, bqkv, wo,
                                                bo, eps, seq_len, heads,
                                                head_dim, scratch=scratch)
    out = _ln_qkvo_int8_cuda("fused_ln_qkvo_attention_int8", x, gamma, beta,
                             wqkv, bqkv, wo, bo, eps, seq_len, heads,
                             head_dim, heads, scratch)
    fused_ln_qkvo_attention_int8.launches += 1
    return out


fused_ln_qkvo_attention_int8.launches = 0


def fused_ln_qkvo_attention_int8_gqa(x, gamma, beta, wqkv, bqkv, wo, bo, eps,
                                     seq_len, heads, head_dim, kv_heads,
                                     int8_grad=False, int8_dw=False, *,
                                     scratch=None):
    """K7's int8 tier: `fused_ln_qkvo_attention_int8` with kv_heads < heads
    on the packed [q (H·Hd) | k (Hkv·Hd) | v (Hkv·Hd)] layout (the kv_heads
    branch of _ln_qkvo_fwd_int8_kernel :2690). Under autograd its backward
    is `fused_ln_qkvo_attention_int8_gqa_bwd` (`_dw_bwd` under int8_dw)
    with `int8_grad`, else K7's bf16 backward."""
    if _needs_grad(x, gamma, beta, wqkv, bqkv, wo, bo):
        return FusedLnQkvoAttentionFn.apply(x, gamma, beta, wqkv, bqkv, wo, bo,
                                            eps, seq_len, heads, head_dim,
                                            True, int8_grad, int8_dw, kv_heads)
    if not x.is_cuda:
        return fused_ln_qkvo_attention_int8_gqa_ref(
            x, gamma, beta, wqkv, bqkv, wo, bo, eps, seq_len, heads, head_dim,
            kv_heads, scratch=scratch)
    out = _ln_qkvo_int8_cuda("fused_ln_qkvo_attention_int8_gqa", x, gamma,
                             beta, wqkv, bqkv, wo, bo, eps, seq_len, heads,
                             head_dim, kv_heads, scratch)
    fused_ln_qkvo_attention_int8_gqa.launches += 1
    return out


fused_ln_qkvo_attention_int8_gqa.launches = 0


def fused_ln_qkvo_attention_int8_gqa_ref(x, gamma, beta, wqkv, bqkv, wo, bo,
                                         eps, seq_len, heads, head_dim,
                                         kv_heads, *, scratch=None):
    """The twin of `fused_ln_qkvo_attention_int8_gqa`: K3's twin on the
    packed GQA layout."""
    return fused_ln_qkvo_attention_int8_ref(x, gamma, beta, wqkv, bqkv, wo,
                                            bo, eps, seq_len, heads,
                                            head_dim, kv_heads,
                                            scratch=scratch)


def _ln_qkvo_int8_cuda(name, x, gamma, beta, wqkv, bqkv, wo, bo, eps, seq_len,
                       heads, head_dim, kv_heads, scratch, int4=False):
    """K3's forward launch (LN-quant, gemm_sm90.cuh's s8 qkv, K13's core
    with an fp32 out, the row codes, the s8 out-projection), or with `int4`
    K11-C's (G-F's with kv_heads < heads: the same sequence at L = 7, K13's
    core in its GQA geometry), at K13's limits; or K7's int8 tier's with
    kv_heads < heads (the first design: gemm.cuh's s8 products, the
    whole-row core)."""
    dev = _check_cuda(
        name,
        {"x": x, "gamma": gamma, "beta": beta, "wqkv": wqkv, "bqkv": bqkv,
         "wo": wo, "bo": bo},
        {"x": _BF, "gamma": _F32, "beta": _F32, "wqkv": _BF, "bqkv": _F32,
         "wo": _BF, "bo": _F32})
    b, spq, d = x.shape
    hhd = heads * head_dim
    first = ("K7's int8 tier" if _gqa(heads, kv_heads) and not int4
             else None)
    _check_qkvo(name, x, gamma, beta, wqkv, bqkv, wo, seq_len, heads,
                head_dim, qkv_attention_supported, kv_heads, first)
    _check_shape(name, "bo", bo, (d,))
    n, width = b * spq, wqkv.shape[1]
    w8t, sw = _i8(dev, width, d), _f32(dev, width)
    wo8t, swo = _i8(dev, d, hhd), _f32(dev, d)
    xq, aq = _i8(dev, n, d), _i8(dev, n, hhd)
    sx, sa = _f32(dev, n), _f32(dev, n)
    qkv, attn = _bf(dev, n, width), _f32(dev, n, hhd)
    out = torch.empty_like(x)
    ptrs = (t.data_ptr() for t in (x, gamma, beta, wqkv, bqkv, wo, bo, w8t,
                                   sw, wo8t, swo, xq, sx, qkv, attn, aq, sa,
                                   out))
    lib = build.load()
    fn = (lib.vitax_ln_qkvo_attention_int4_fwd if int4
          else lib.vitax_ln_qkvo_attention_int8_fwd)
    rc = fn(*ptrs, b, spq, d, seq_len, heads, kv_heads, head_dim, eps,
            1.0 / math.sqrt(head_dim), _stream(dev))
    build.check(rc, name)
    _keep(scratch, w8=(w8t.t(), sw), wo8=(wo8t.t(), swo), xq=(xq, sx),
          aq=(aq, sa))
    return out


def fused_ln_qkvo_attention_int8_bwd_ref(x, gamma, beta, wqkv, bqkv, wo, do,
                                         eps, seq_len, heads, head_dim,
                                         kv_heads=None, *, int8_dw=False,
                                         group=None, scratch=None):
    """(dx, dγ, dβ, dWqkv, dbqkv, dWo, dbo) of K3 under int8_grad with the
    TPU kernel's rounding points (_ln_qkvo_bwd_int8_kernel, pallas_kernels.py:
    3003-3088): the int8 qkv recompute from the fp32 LN output, the core
    recomputed with bf16 attn, dattn = bf16(f32(doq·Wo_rᵀ)·sdo·swor), the bf16
    core grads, dxn = f32(dqq·W_rᵀ)·sdq·swr. dW, dWo: bf16 products, or with
    `int8_dw` the per-group int8 products over `group` rows (by default
    whole images, `qkvo_dw_group`): dWo from attn·sdo and doq, dW from the
    fp32 xn·sdq and dqq. kv_heads < heads: the packed GQA layout, dK and dV
    of a kv group summed over its query heads in fp32 (K7's int8 tier)."""
    return _qkvo_quant_bwd_ref(x, gamma, beta, wqkv, bqkv, wo, do, eps,
                               seq_len, heads, head_dim, kv_heads, int8_dw,
                               group, scratch, False)


def _qkvo_quant_bwd_ref(x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len,
                        heads, head_dim, kv_heads, int8_dw, group, scratch,
                        int4):
    """K3's backward twin, or with `int4` K11-D's: every quantizer of the
    recompute and the dx-path on the int4 grid, and under `int8_dw` both
    operands of each weight grad packed fresh per column
    (`_dw_int8_cols`)."""
    rows, cols_host, rows_host = _quantizers(int4)
    dt = x.dtype
    b, spq, d = x.shape
    x2 = x.reshape(-1, d)
    do2 = do.reshape(-1, d)
    w8, sw = cols_host(wqkv)
    w8r, swr = rows_host(wqkv)
    wo8r, swor = rows_host(wo)
    xhat, rstd = _ln_stats(x2.float(), eps)
    xn32 = _affine(xhat, gamma, beta)
    xn = xn32.to(dt)
    xq, sx = rows(xn32)
    qkv = _dequant(int_mm(xq, w8), sx, sw, bqkv).to(dt)
    q, k, v, p, o32 = _attn_core(qkv.view(b, spq, -1), seq_len, heads,
                                 head_dim, kv_heads)
    o = o32.to(dt)
    doq, sdo = rows(do2.float())
    dattn = _dequant(int_mm(doq, wo8r.t()), sdo, swor).to(dt)
    dqkv = _attn_core_grads(q, k, v, p, o, dattn, 1.0 / math.sqrt(head_dim),
                            kv_heads)
    dqq, sdq = rows(dqkv.float())
    dxn = _dequant(int_mm(dqq, w8r.t()), sdq, swr)
    if int8_dw and int4:
        group = group or qkvo_dw_group(b, spq)
        dwo, atc, doc = _dw_int8_cols(_heads_to_rows(o), do2, group)
        dw, xnc, dqc = _dw_int8_cols(xn32, dqkv, group)
        _keep(scratch, atc=atc, doc=doc, xnc=xnc, dqc=dqc)
    elif int8_dw:
        group = group or qkvo_dw_group(b, spq)
        dwo, atc = _dw_int8(_heads_to_rows(o), sdo, doq, group)
        dw, xnc = _dw_int8(xn32, sdq, dqq, group)
        _keep(scratch, atc=atc, xnc=xnc)
    else:
        dwo = matmul_f32(_heads_to_rows(o).t(), do2)
        dw = matmul_f32(xn.t(), dqkv)
    dxln, dg, dbe = _ln_bwd_tail(dxn, xhat, rstd, gamma)
    _keep(scratch, w8=(w8, sw), w8r=(w8r, swr), wo8r=(wo8r, swor),
          xq=(xq, sx), doq=(doq, sdo), dqq=(dqq, sdq))
    return (dxln.to(dt).view(b, spq, d), dg, dbe, dw, dqkv.float().sum(dim=0),
            dwo, do2.float().sum(dim=0))


def fused_ln_qkvo_attention_int8_dw_bwd_ref(x, gamma, beta, wqkv, bqkv, wo, do,
                                            eps, seq_len, heads, head_dim,
                                            kv_heads=None, *, scratch=None):
    """The twin of `fused_ln_qkvo_attention_int8_dw_bwd`: int8_dw at the
    port's group (`qkvo_dw_group`)."""
    return fused_ln_qkvo_attention_int8_bwd_ref(
        x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads, head_dim,
        kv_heads, int8_dw=True, group=qkvo_dw_group(*x.shape[:2]),
        scratch=scratch)


def _ln_qkvo_int8_bwd_cuda(name, x, gamma, beta, wqkv, bqkv, wo, do, eps,
                           seq_len, heads, head_dim, kv_heads, int8_dw,
                           scratch, int4=False):
    """K3's backward launch (K7's int8 tier with kv_heads < heads), or with
    `int4` K11-D's (G-B's with kv_heads < heads), all on the Hopper design
    (K13's core, in its GQA geometry where kv_heads < heads, its row
    statistics the only attention scratch; gemm_sm90.cuh's s8 path) at
    K13's limits."""
    dev = _check_cuda(
        name,
        {"x": x, "gamma": gamma, "beta": beta, "wqkv": wqkv, "bqkv": bqkv,
         "wo": wo, "do": do},
        {"x": _BF, "gamma": _F32, "beta": _F32, "wqkv": _BF, "bqkv": _F32,
         "wo": _BF, "do": _BF})
    _check_qkvo(name, x, gamma, beta, wqkv, bqkv, wo, seq_len, heads,
                head_dim, qkv_attention_supported, kv_heads)
    _check_shape(name, "do", do, tuple(x.shape))
    b, spq, d = x.shape
    hhd = heads * head_dim
    n, width = b * spq, wqkv.shape[1]
    lib = build.load()
    w8t, sw = _i8(dev, width, d), _f32(dev, width)
    w8r, swr = _i8(dev, d, width), _f32(dev, d)
    wo8r, swor = _i8(dev, hhd, d), _f32(dev, hhd)
    dx, dg, dbe = torch.empty_like(x), _f32(dev, d), _f32(dev, d)
    dw, db = _f32(dev, d, width), _f32(dev, width)
    dwo, dbo = _f32(dev, hhd, d), _f32(dev, d)
    # xn: bf16 for the bf16 weight grads, fp32 (xn32) under int8_dw
    xn = (_f32 if int8_dw else _bf)(dev, n, d)
    qkv, attn, dattn = (_bf(dev, n, width), _bf(dev, n, hhd),
                        _bf(dev, n, hhd))
    # the core's only scratch: K13's row statistics
    stats = _workspace(lib.vitax_attention_core_bwd_ws(b, spq, heads), dev)
    dqkv, dxn = _bf(dev, n, width), _f32(dev, n, d)
    xq, doq, dqq = _i8(dev, n, d), _i8(dev, n, d), _i8(dev, n, width)
    sx, sdo, sdq = _f32(dev, n), _f32(dev, n), _f32(dev, n)
    ws = _workspace(lib.vitax_ln_qkvo_attention_bwd_ws(n, d, hhd, width), dev)
    group = qkvo_dw_group(b, spq)
    # int8_dw: (attn | do) column codes and scales for dWo, (xn | dqkv) for
    # dW; K3 reuses do's and dqkv's row codes, so it has no scales of its
    # own for them (K11-D's are the fourth and last)
    dwt = [None] * 8
    if int8_dw:
        groups, kp = _dw_layout(n, group)
        dwt = [_i8(dev, hhd, kp), _f32(dev, groups, hhd), _i8(dev, d, kp),
               _f32(dev, groups, d) if int4 else None, _i8(dev, d, kp),
               _f32(dev, groups, d), _i8(dev, width, kp),
               _f32(dev, groups, width) if int4 else None]
    ptrs = [None if t is None else t.data_ptr() for t in dwt]
    if not int4:
        del ptrs[7], ptrs[3]
    fn = (lib.vitax_ln_qkvo_attention_int4_bwd if int4
          else lib.vitax_ln_qkvo_attention_int8_bwd)
    head = (t.data_ptr() for t in (
        x, gamma, beta, bqkv, wqkv, wo, do, dx, dg, dbe, dw, db, dwo, dbo, w8t,
        sw, w8r, swr, wo8r, swor, xn, xq, sx, qkv, attn, doq, sdo, dattn))
    tail = (t.data_ptr() for t in (stats, dqkv, dqq, sdq, dxn, ws))
    rc = fn(*head, *tail, *ptrs, b, spq, d, seq_len, heads, kv_heads,
            head_dim, group, int(int8_dw), eps, 1.0 / math.sqrt(head_dim),
            _stream(dev))
    build.check(rc, name)
    _keep(scratch, w8=(w8t.t(), sw), w8r=(w8r, swr), wo8r=(wo8r, swor),
          xq=(xq, sx), doq=(doq, sdo), dqq=(dqq, sdq))
    if int8_dw and scratch is not None:  # the layout change copies
        kept = dict(atc=0, xnc=4, **(dict(doc=2, dqc=6) if int4 else {}))
        _keep(scratch, **{k: (_group_codes(dwt[i], n, group),
                              dwt[i + 1]) for k, i in kept.items()})
    return dx, dg, dbe, dw, db, dwo, dbo


def fused_ln_qkvo_attention_int8_bwd(x, gamma, beta, wqkv, bqkv, wo, do, eps,
                                     seq_len, heads, head_dim, kv_heads=None,
                                     *, scratch=None):
    """Backward of `fused_ln_qkvo_attention_int8` under int8_grad: dx
    [B, spq, D] bf16 and fp32 dγ, dβ [D], dWqkv [D, W], dbqkv [W], dWo
    [H·Hd, D], dbo [D], W = (H + 2·Hkv)·Hd. kv_heads < heads:
    `fused_ln_qkvo_attention_int8_gqa_bwd`."""
    if _gqa(heads, kv_heads):
        return fused_ln_qkvo_attention_int8_gqa_bwd(
            x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads, head_dim,
            kv_heads, scratch=scratch)
    if not x.is_cuda:
        return fused_ln_qkvo_attention_int8_bwd_ref(x, gamma, beta, wqkv, bqkv,
                                                    wo, do, eps, seq_len,
                                                    heads, head_dim,
                                                    scratch=scratch)
    out = _ln_qkvo_int8_bwd_cuda("fused_ln_qkvo_attention_int8_bwd", x, gamma,
                                 beta, wqkv, bqkv, wo, do, eps, seq_len,
                                 heads, head_dim, heads, False, scratch)
    fused_ln_qkvo_attention_int8_bwd.launches += 1
    return out


fused_ln_qkvo_attention_int8_bwd.launches = 0


def fused_ln_qkvo_attention_int8_gqa_bwd(x, gamma, beta, wqkv, bqkv, wo, do,
                                         eps, seq_len, heads, head_dim,
                                         kv_heads, *, scratch=None):
    """K7's int8 tier backward under int8_grad: the kv_heads branch of
    _ln_qkvo_bwd_int8_kernel (:2977), the outputs of
    `fused_ln_qkvo_attention_int8_bwd` on the packed GQA layout."""
    if not x.is_cuda:
        return fused_ln_qkvo_attention_int8_gqa_bwd_ref(
            x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads, head_dim,
            kv_heads, scratch=scratch)
    out = _ln_qkvo_int8_bwd_cuda("fused_ln_qkvo_attention_int8_gqa_bwd", x,
                                 gamma, beta, wqkv, bqkv, wo, do, eps, seq_len,
                                 heads, head_dim, kv_heads, False, scratch)
    fused_ln_qkvo_attention_int8_gqa_bwd.launches += 1
    return out


fused_ln_qkvo_attention_int8_gqa_bwd.launches = 0


def fused_ln_qkvo_attention_int8_gqa_bwd_ref(x, gamma, beta, wqkv, bqkv, wo,
                                             do, eps, seq_len, heads,
                                             head_dim, kv_heads, *,
                                             scratch=None):
    """The twin of `fused_ln_qkvo_attention_int8_gqa_bwd`."""
    return fused_ln_qkvo_attention_int8_bwd_ref(
        x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads, head_dim,
        kv_heads, scratch=scratch)


def fused_ln_qkvo_attention_int8_dw_bwd(x, gamma, beta, wqkv, bqkv, wo, do,
                                        eps, seq_len, heads, head_dim,
                                        kv_heads=None, *, scratch=None):
    """`fused_ln_qkvo_attention_int8_bwd` under int8_dw: dWqkv and dWo are
    per-group int8 products with row-scale folding, over groups of whole
    images (`qkvo_dw_group`: tile·spq rows), int32 inside a group and fp32
    across groups in order. `scratch` also receives the column codes, atc
    and xnc, as [rows, width] with one scale a column a group. kv_heads <
    heads: `fused_ln_qkvo_attention_int8_gqa_dw_bwd`."""
    if _gqa(heads, kv_heads):
        return fused_ln_qkvo_attention_int8_gqa_dw_bwd(
            x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads, head_dim,
            kv_heads, scratch=scratch)
    if not x.is_cuda:
        return fused_ln_qkvo_attention_int8_dw_bwd_ref(
            x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads, head_dim,
            scratch=scratch)
    out = _ln_qkvo_int8_bwd_cuda("fused_ln_qkvo_attention_int8_dw_bwd", x,
                                 gamma, beta, wqkv, bqkv, wo, do, eps, seq_len,
                                 heads, head_dim, heads, True, scratch)
    fused_ln_qkvo_attention_int8_dw_bwd.launches += 1
    return out


fused_ln_qkvo_attention_int8_dw_bwd.launches = 0


def fused_ln_qkvo_attention_int8_gqa_dw_bwd(x, gamma, beta, wqkv, bqkv, wo,
                                            do, eps, seq_len, heads, head_dim,
                                            kv_heads, *, scratch=None):
    """K7's int8 tier backward under int8_dw (the kv_heads branch of
    :2977 with its int8_dw branches :3041-3049, :3077-3084)."""
    if not x.is_cuda:
        return fused_ln_qkvo_attention_int8_gqa_dw_bwd_ref(
            x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads, head_dim,
            kv_heads, scratch=scratch)
    out = _ln_qkvo_int8_bwd_cuda("fused_ln_qkvo_attention_int8_gqa_dw_bwd", x,
                                 gamma, beta, wqkv, bqkv, wo, do, eps, seq_len,
                                 heads, head_dim, kv_heads, True, scratch)
    fused_ln_qkvo_attention_int8_gqa_dw_bwd.launches += 1
    return out


fused_ln_qkvo_attention_int8_gqa_dw_bwd.launches = 0


def fused_ln_qkvo_attention_int8_gqa_dw_bwd_ref(x, gamma, beta, wqkv, bqkv,
                                                wo, do, eps, seq_len, heads,
                                                head_dim, kv_heads, *,
                                                scratch=None):
    """The twin of `fused_ln_qkvo_attention_int8_gqa_dw_bwd`."""
    return fused_ln_qkvo_attention_int8_dw_bwd_ref(
        x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads, head_dim,
        kv_heads, scratch=scratch)


# =============================================================================
# K5 — the int8 block handoff (fused_block_int8_handoff, pallas_kernels.py:
# 3863). On the padded stream with all four int8 flags, each half's epilogue
# emits the next half's input already LN-normalized and quantized per row
# (codes int8 [B·spq, D] and one fp32 scale a row; vitax carries 8 broadcast
# scale lanes), and adds its residual in fp32: r1 = bf16(f32(x) + y) where
# the non-handoff path adds bf16(y) in bf16, one rounding apart in bf16 and
# the same in fp32 (ROADMAP Queue 3).
# =============================================================================

def pack_rows(x, gamma, beta, eps):
    """LN (fp32 statistics) + per-row int8 of the fp32 LN output, the
    handoff's packed form of a stream [..., D] (vitax's _ln_quant_rows
    :3660 and pack_stream :3840): (codes [rows, D], scales [rows])."""
    d = x.shape[-1]
    xhat, _ = _ln_stats(x.reshape(-1, d).float(), eps)
    q, s = quant_rows(_affine(xhat, gamma, beta))
    return q, s.reshape(-1)


def fused_ln_qkvo_attention_int8_ho_ref(x, xq, sx, g1, be1, g2, be2, wqkv,
                                        bqkv, wo, bo, eps, seq_len, heads,
                                        head_dim, *, scratch=None):
    """K5's attention half with the TPU kernel's rounding points
    (_ln_qkvo_fwd_int8_ho_kernel, pallas_kernels.py:3681-3729): K3's forward
    from the packed LN1 (xq, sx), r1 = bf16(f32(x) + f32(aq·Woq)·sa·swo + bo),
    then LN2(r1) packed: (r1 [B, spq, D], xq2 [B·spq, D], sx2 [B·spq]).
    xq None: the first block, which packs x itself with (g1, be1) first."""
    dt = x.dtype
    b, spq, d = x.shape
    if xq is None:
        xq, sx = pack_rows(x, g1, be1, eps)
    w8, sw = quant_cols_host(wqkv)
    wo8, swo = quant_cols_host(wo)
    qkv = _dequant(int_mm(xq, w8), sx.reshape(-1, 1), sw, bqkv).to(dt)
    *_, o32 = _attn_core(qkv.view(b, spq, -1), seq_len, heads, head_dim)
    aq, sa = quant_rows(_heads_to_rows(o32))
    y = _dequant(int_mm(aq, wo8), sa, swo, bo)
    r1 = (x.reshape(-1, d).float() + y).to(dt)
    xq2, sx2 = pack_rows(r1, g2, be2, eps)
    _keep(scratch, w8=(w8, sw), wo8=(wo8, swo), xq=(xq, sx), aq=(aq, sa),
          xq2=(xq2, sx2))
    return r1.view(b, spq, d), xq2, sx2


def fused_ln_qkvo_attention_int8_ho(x, xq, sx, g1, be1, g2, be2, wqkv, bqkv,
                                    wo, bo, eps, seq_len, heads, head_dim, *,
                                    scratch=None):
    """K5's attention half, forward only (its gradient is the block's,
    `FusedBlockInt8HandoffFn`): x [B, spq, D] bf16 (the padded stream), its
    packed LN1 xq int8 [B·spq, D] and sx fp32 [B·spq] (None: pack x here
    with g1/be1), LN2's g2/be2, the K3 weights. Returns (r1, xq2, sx2), r1
    with the residual added in fp32. On the card: the weights' column codes,
    (with the pack) the LN-quant of x, gemm_sm90.cuh's s8 qkv, K13's core
    with an fp32 out, the row codes, the s8 out-projection adding x in fp32
    (`s8_residual_f32`), the LN2-quant of r1; it takes the shapes K3's
    forward takes (K13's limits). `scratch` also gets the bf16 qkv."""
    if not x.is_cuda:
        return fused_ln_qkvo_attention_int8_ho_ref(
            x, xq, sx, g1, be1, g2, be2, wqkv, bqkv, wo, bo, eps, seq_len,
            heads, head_dim, scratch=scratch)
    name = "fused_ln_qkvo_attention_int8_ho"
    b, spq, d = x.shape
    n = b * spq
    pack = xq is None
    if pack:
        xq, sx = _i8(x.device, n, d), _f32(x.device, n)
    dev = _check_ho_attention(name, x, xq, sx, g1, be1, g2, be2, wqkv, bqkv,
                              wo, bo, seq_len, heads, head_dim)
    hhd = heads * head_dim
    w8t, sw = _i8(dev, 3 * hhd, d), _f32(dev, 3 * hhd)
    wo8t, swo = _i8(dev, d, hhd), _f32(dev, d)
    qkv, attn = _bf(dev, n, 3 * hhd), _f32(dev, n, hhd)
    aq, sa = _i8(dev, n, hhd), _f32(dev, n)
    r1, xq2, sx2 = torch.empty_like(x), _i8(dev, n, d), _f32(dev, n)
    ptrs = (t.data_ptr() for t in (x, xq, sx, g1, be1, g2, be2, wqkv, bqkv,
                                   wo, bo, w8t, sw, wo8t, swo, qkv, attn, aq,
                                   sa, r1, xq2, sx2))
    rc = build.load().vitax_ln_qkvo_attention_int8_ho_fwd(
        *ptrs, b, spq, d, seq_len, heads, head_dim, int(pack), eps,
        1.0 / math.sqrt(head_dim), _stream(dev))
    build.check(rc, name)
    fused_ln_qkvo_attention_int8_ho.launches += 1
    _keep(scratch, w8=(w8t.t(), sw), wo8=(wo8t.t(), swo), xq=(xq, sx),
          aq=(aq, sa), xq2=(xq2, sx2))
    if scratch is not None:
        scratch["qkv"] = qkv
    return r1, xq2, sx2


fused_ln_qkvo_attention_int8_ho.launches = 0


def _check_ho_attention(name, x, xq, sx, g1, be1, g2, be2, wqkv, bqkv, wo, bo,
                        seq_len, heads, head_dim):
    """The launch checks of K5's attention half, before it allocates
    anything: dtypes and the card, K3's gate (K13's limits: S <= 1024, a
    head dim of VITAX_K13_HEAD_DIMS, d % 16, at most 65535 images) and the
    packed input's shapes; returns the device."""
    b, spq, d = x.shape
    n = b * spq
    dev = _check_cuda(
        name,
        {"x": x, "xq": xq, "sx": sx, "g1": g1, "be1": be1, "g2": g2,
         "be2": be2, "wqkv": wqkv, "bqkv": bqkv, "wo": wo, "bo": bo},
        {"x": _BF, "xq": torch.int8, "sx": _F32, "g1": _F32, "be1": _F32,
         "g2": _F32, "be2": _F32, "wqkv": _BF, "bqkv": _F32, "wo": _BF,
         "bo": _F32})
    _check_qkvo(name, x, g2, be2, wqkv, bqkv, wo, seq_len, heads, head_dim,
                qkv_attention_supported)
    for key, t, shape in (("xq", xq, (n, d)), ("sx", sx, (n,)),
                          ("g1", g1, (d,)), ("be1", be1, (d,)),
                          ("bo", bo, (d,))):
        _check_shape(name, key, t, shape)
    return dev


def fused_ln_mlp_int8_ho_ref(x, xq, sx, gn, ben, w1, b1, w2, b2, eps, *,
                             scratch=None):
    """K5's MLP half with the TPU kernel's rounding points
    (_ln_mlp_fwd_int8_ho_kernel, pallas_kernels.py:3741-3765): K4's forward
    from the packed LN2 (xq, sx), r2 = bf16(f32(x) + f32(h1q·W2q)·sh·s2 + b2),
    then the next block's LN1 (gn, ben) of r2 packed: (r2 [..., D],
    xqn [rows, D], sxn [rows])."""
    d = x.shape[-1]
    w1q, s1 = quant_cols_host(w1)
    w2q, s2 = quant_cols_host(w2)
    a1 = _dequant(int_mm(xq, w1q), sx.reshape(-1, 1), s1, b1)
    h1q, sh = quant_rows(gelu_q(a1))
    y = _dequant(int_mm(h1q, w2q), sh, s2, b2)
    r2 = (x.reshape(-1, d).float() + y).to(x.dtype)
    xqn, sxn = pack_rows(r2, gn, ben, eps)
    _keep(scratch, w1q=(w1q, s1), w2q=(w2q, s2), h1q=(h1q, sh),
          xqn=(xqn, sxn))
    return r2.reshape(x.shape), xqn, sxn


def fused_ln_mlp_int8_ho(x, xq, sx, gn, ben, w1, b1, w2, b2, eps, *,
                         scratch=None):
    """K5's MLP half, forward only: x (= r1) [..., D] bf16 with its packed
    LN2 (xq, sx) from the attention half, the next block's LN1 gn/ben (the
    encoder norm's for the last block, whose packed output is not read), the
    K4 weights. Returns (r2, xqn, sxn), r2 with the residual added in fp32.
    On the card: the weights' column codes, fc1 on gemm_sm90.cuh's s8 path
    (`s8_gelu_q_f32`), the row codes, fc2 adding x in fp32
    (`s8_residual_f32`), the LN-quant of r2 with gn/ben."""
    if not x.is_cuda:
        return fused_ln_mlp_int8_ho_ref(x, xq, sx, gn, ben, w1, b1, w2, b2,
                                        eps, scratch=scratch)
    name = "fused_ln_mlp_int8_ho"
    dev = _check_cuda(
        name,
        {"x": x, "xq": xq, "sx": sx, "gn": gn, "ben": ben, "w1": w1, "b1": b1,
         "w2": w2, "b2": b2},
        {"x": _BF, "xq": torch.int8, "sx": _F32, "gn": _F32, "ben": _F32,
         "w1": _BF, "b1": _F32, "w2": _BF, "b2": _F32})
    d = x.shape[-1]
    m = w1.shape[1]
    x2 = x.view(-1, d)
    n = x2.shape[0]
    if not ln_mlp_supported(x2.unsqueeze(0), w1, w2):
        raise ValueError(f"{name}: unsupported shapes x {tuple(x.shape)} w1 "
                         f"{tuple(w1.shape)} w2 {tuple(w2.shape)}")
    for key, t, shape in (("xq", xq, (n, d)), ("sx", sx, (n,)),
                          ("gn", gn, (d,)), ("ben", ben, (d,)),
                          ("b1", b1, (m,)), ("b2", b2, (d,))):
        _check_shape(name, key, t, shape)
    w1t, s1 = _i8(dev, m, d), _f32(dev, m)
    w2t, s2 = _i8(dev, d, m), _f32(dev, d)
    g, h1q, sh = _f32(dev, n, m), _i8(dev, n, m), _f32(dev, n)
    out, xqn, sxn = torch.empty_like(x2), _i8(dev, n, d), _f32(dev, n)
    rc = build.load().vitax_ln_mlp_int8_ho_fwd(*(t.data_ptr() for t in (
        x2, xq, sx, gn, ben, w1, b1, w2, b2, w1t, s1, w2t, s2, g, h1q, sh,
        out, xqn, sxn)), n, d, m, eps, _stream(dev))
    build.check(rc, name)
    fused_ln_mlp_int8_ho.launches += 1
    _keep(scratch, w1q=(w1t.t(), s1), w2q=(w2t.t(), s2), h1q=(h1q, sh),
          xqn=(xqn, sxn))
    return out.view(x.shape), xqn, sxn


fused_ln_mlp_int8_ho.launches = 0


def _block_ho_forward(x, xq, sx, g1, be1, wqkv, bqkv, wo, bo, g2, be2, w1, b1,
                      w2, b2, gn, ben, eps, seq_len, heads, head_dim, ref):
    if ref:
        attn, mlp = (fused_ln_qkvo_attention_int8_ho_ref,
                     fused_ln_mlp_int8_ho_ref)
    else:
        attn, mlp = fused_ln_qkvo_attention_int8_ho, fused_ln_mlp_int8_ho
    r1, xq2, sx2 = attn(x, xq, sx, g1, be1, g2, be2, wqkv, bqkv, wo, bo, eps,
                        seq_len, heads, head_dim)
    r2, xqn, sxn = mlp(r1, xq2, sx2, gn, ben, w1, b1, w2, b2, eps)
    return r1, (r2, xqn, sxn)


class FusedBlockInt8HandoffFn(torch.autograd.Function):
    """One encoder block on the int8 handoff, (x, xq, sx) → (r2, xqn, sxn),
    as vitax's fused_block_int8_handoff custom VJP (pallas_kernels.py:
    3862-3928): the forward is K5's two kernels (`ref`: their twins); the
    packed outputs are forward-only data (straight-through: no cotangent);
    it saves x and r1, and the backward is K4's int8 backward on r1 with the
    residual, then K3's on x, dx = dx_att + dr1, both with `int8_dw` as
    configured (`ref`: the twins). xq, sx and the next block's LN1 gn/ben get
    no gradient here (gn/ben get theirs from the next block)."""

    @staticmethod
    def forward(ctx, x, xq, sx, g1, be1, wqkv, bqkv, wo, bo, g2, be2, w1, b1,
                w2, b2, gn, ben, eps, seq_len, heads, head_dim, int8_dw, ref):
        r1, out = _block_ho_forward(x, xq, sx, g1, be1, wqkv, bqkv, wo, bo, g2,
                                    be2, w1, b1, w2, b2, gn, ben, eps, seq_len,
                                    heads, head_dim, ref)
        ctx.save_for_backward(x, r1, g1, be1, wqkv, bqkv, wo, g2, be2, w1, b1,
                              w2)
        ctx.meta = (eps, seq_len, heads, head_dim)
        ctx.tier = (int8_dw, ref)
        ctx.dtypes = (bo.dtype, b2.dtype)
        ctx.mark_non_differentiable(out[1], out[2])
        return out

    @staticmethod
    def backward(ctx, dr2, _dxqn, _dsxn):
        x, r1, g1, be1, wqkv, bqkv, wo, g2, be2, w1, b1, w2 = ctx.saved_tensors
        eps, seq_len, heads, head_dim = ctx.meta
        int8_dw, ref = ctx.tier
        if ref:
            mlp_bwd = (fused_ln_mlp_int8_dw_bwd_ref if int8_dw
                       else fused_ln_mlp_int8_bwd_ref)
            attn_bwd = (fused_ln_qkvo_attention_int8_dw_bwd_ref if int8_dw
                        else fused_ln_qkvo_attention_int8_bwd_ref)
        else:
            mlp_bwd = (fused_ln_mlp_int8_dw_bwd if int8_dw
                       else fused_ln_mlp_int8_bwd)
            attn_bwd = (fused_ln_qkvo_attention_int8_dw_bwd if int8_dw
                        else fused_ln_qkvo_attention_int8_bwd)
        dr1, dg2, dbe2, dw1, db1, dw2, db2 = mlp_bwd(
            r1, g2, be2, w1, b1, w2, dr2.contiguous(), eps)
        dxa, dg1, dbe1, dw, db, dwo, dbo = attn_bwd(
            x, g1, be1, wqkv, bqkv, wo, dr1, eps, seq_len, heads, head_dim)
        bo_dtype, b2_dtype = ctx.dtypes
        return (dxa + dr1, None, None, dg1.to(g1.dtype), dbe1.to(be1.dtype),
                dw.to(wqkv.dtype), db.to(bqkv.dtype), dwo.to(wo.dtype),
                dbo.to(bo_dtype), dg2.to(g2.dtype), dbe2.to(be2.dtype),
                dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(b2_dtype), None, None, None, None, None, None, None,
                None)


def _block_ho(args, int8_dw, ref):
    x, _, _, *params = args[:15]  # xq, sx and gn, ben get no gradient
    if _needs_grad(x, *params):
        return FusedBlockInt8HandoffFn.apply(*args, int8_dw, ref)
    return _block_ho_forward(*args, ref)[1]


def fused_block_int8_handoff(x, xq, sx, g1, be1, wqkv, bqkv, wo, bo, g2, be2,
                             w1, b1, w2, b2, gn, ben, eps, seq_len, heads,
                             head_dim, int8_dw):
    """One encoder block on the int8 handoff (K5): x [B, spq, D] the padded
    stream, (xq, sx) its packed LN1 (None for the first block), the block's
    LN1/K3/LN2/K4 parameters, gn/ben the next block's LN1 (the encoder
    norm's for the last). Returns (r2, xqn, sxn); under autograd through
    `FusedBlockInt8HandoffFn`, whose backward is K4's and K3's int8
    backwards (their `int8_dw` variants with `int8_dw`)."""
    return _block_ho((x, xq, sx, g1, be1, wqkv, bqkv, wo, bo, g2, be2, w1, b1,
                      w2, b2, gn, ben, eps, seq_len, heads, head_dim),
                     int8_dw, False)


def fused_block_int8_handoff_ref(x, xq, sx, g1, be1, wqkv, bqkv, wo, bo, g2,
                                 be2, w1, b1, w2, b2, gn, ben, eps, seq_len,
                                 heads, head_dim, int8_dw):
    """The plain twin of `fused_block_int8_handoff`: the forward twins of
    K5's two kernels and, under autograd, the int8 backward twins."""
    return _block_ho((x, xq, sx, g1, be1, wqkv, bqkv, wo, bo, g2, be2, w1, b1,
                      w2, b2, gn, ben, eps, seq_len, heads, head_dim),
                     int8_dw, True)


# =============================================================================
# K8 — the rect (compacted-Q) attention half of Res-ViT's token compaction
# (fused_ln_qkvo_attention_rect, pallas_kernels.py:4410): LN of the cpq
# gathered rows xc → Q, LN of all spq rows x → K and V, the core over the spq
# keys, the out-projection, on the xc rows only; bf16 and W8A8. Each tier
# gives its square kernel's output rows (K1's, K3's) on x followed by a row
# gather, bit for bit on the card: it runs that kernel's launches, each per
# row, on the two row sets, with K13's core in a rect geometry.
# Its backward (:4491-4573) gives dxc on the gathered rows and dx on
# all rows (the caller's gather transpose adds them), dγ and dβ over both
# row sets, dWqkv = [dWq from xc's rows | dWkv from x's rows].
# =============================================================================

def qkv_attention_rect_supported(xc, x, wqkv, heads) -> bool:
    """Gate of the rect half: K1's gate at x's spq, and xc [B, cpq, D] on
    the same batch and width. K8 (bf16 and int8) and R-B run K13's core in
    its rect geometry and take what the gate takes; R-F keeps the first
    design's whole-row core, whose limits its wrapper checks and raises on
    (`_check_rect`)."""
    return (xc.ndim == 3 and qkv_attention_supported(x, wqkv, heads)
            and xc.shape[0] == x.shape[0] and xc.shape[2] == x.shape[2]
            and (xc.dtype == torch.bfloat16 or not xc.is_cuda))


def _check_rect(name, xc, x, gamma, beta, wqkv, bqkv, wo, bo, seq_len, heads,
                head_dim, backward=False, int4=False):
    """K8's launch checks, forward or `backward`, for its tier: the rect
    gate (K13's limits at x's spq), all that the bf16, int8 and int4
    backwards (R-B) need (K13's core in the rect geometry); with `int4` the
    forward, R-F, keeps the whole-row core, whose limits at x's spq it
    checks too (`_check_qkvo`'s first design)."""
    first_design = "R-F" if int4 and not backward else None
    b, cpq, d = xc.shape
    if cpq % 8 or not qkv_attention_rect_supported(xc, x, wqkv, heads):
        raise ValueError(f"{name}: unsupported shapes xc {tuple(xc.shape)} x "
                         f"{tuple(x.shape)} wqkv {tuple(wqkv.shape)}")
    _check_qkvo(name, x, gamma, beta, wqkv, bqkv, wo, seq_len, heads,
                head_dim, qkv_attention_supported, first_design=first_design,
                backward=backward)
    if bo is not None:
        _check_shape(name, "bo", bo, (d,))


def _rect_heads(q, kv, heads):
    """q [B, cpq, H·Hd], kv [B, spq, 2·H·Hd] (K columns, then V) → per-head
    q [B,H,cpq,Hd], k, v [B,H,spq,Hd]."""
    hhd = q.shape[-1]
    k, v = (_split_heads(kv[..., i * hhd:(i + 1) * hhd], heads)
            for i in range(2))
    return _split_heads(q, heads), k, v


def _rect_core(q, kv, seq_len, heads):
    """q [B, cpq, H·Hd], kv [B, spq, 2·H·Hd] → the fp32 head outputs p·v as
    rows [B·cpq, H·Hd] (_rect_core_recompute, pallas_kernels.py:3949-3974,
    before its cast)."""
    _, o32 = _softmax_pv(*_rect_heads(q, kv, heads), seq_len)
    return _heads_to_rows(o32)


def fused_ln_qkvo_attention_rect_ref(xc, x, gamma, beta, wqkv, bqkv, wo, bo,
                                     eps, seq_len, heads, head_dim):
    """K8 with the TPU kernel's rounding points (_ln_qkvo_rect_fwd_kernel,
    pallas_kernels.py:4039-4065): q = bf16(LN(xc)·Wq + bq), kv =
    bf16(LN(x)·Wkv + bkv) with Wq, Wkv the column slices of wqkv, the bf16
    core, out = bf16(attn·Wo + bo). xc [B, cpq, D] → [B, cpq, D]."""
    dt = xc.dtype
    b, cpq, d = xc.shape
    hhd = heads * head_dim
    q = (matmul_f32(layer_norm_ref(xc, gamma, beta, eps), wqkv[:, :hhd])
         + bqkv[:hhd].float()).to(dt)
    kv = (matmul_f32(layer_norm_ref(x, gamma, beta, eps), wqkv[:, hhd:])
          + bqkv[hhd:].float()).to(dt)
    attn = _rect_core(q, kv, seq_len, heads).to(dt)
    return (matmul_f32(attn, wo) + bo.float()).to(dt).view(b, cpq, d)


def fused_ln_qkvo_attention_rect_int8_ref(xc, x, gamma, beta, wqkv, bqkv, wo,
                                          bo, eps, seq_len, heads, head_dim,
                                          *, scratch=None):
    """K8's W8A8 tier with the TPU kernel's rounding points
    (_ln_qkvo_rect_fwd_int8_kernel, pallas_kernels.py:4076-4109): K3's
    twin on the two row sets, the weights' codes those of wqkv quantized
    whole (per column, so the same as its slices'). `scratch` as K3's twin's,
    xq/sx the codes of xc's rows and xqk of x's."""
    return _rect_quant_fwd_ref(xc, x, gamma, beta, wqkv, bqkv, wo, bo, eps,
                               seq_len, heads, head_dim, scratch, False)


def fused_ln_qkvo_attention_rect_int4_ref(xc, x, gamma, beta, wqkv, bqkv, wo,
                                          bo, eps, seq_len, heads, head_dim,
                                          *, scratch=None):
    """R-F with the TPU kernel's rounding points
    (_ln_qkvo_rect_fwd_int4_kernel, pallas_kernels.py:4120-4152): K8's int8
    twin on the int4 grid (_quant_rows4 of the two fp32 LN outputs and of
    the fp32 attn, _quant_cols_host4 of the weights). `scratch`: as the
    int8 twin's."""
    return _rect_quant_fwd_ref(xc, x, gamma, beta, wqkv, bqkv, wo, bo, eps,
                               seq_len, heads, head_dim, scratch, True)


def _rect_quant_fwd_ref(xc, x, gamma, beta, wqkv, bqkv, wo, bo, eps, seq_len,
                        heads, head_dim, scratch, int4):
    """K8's int8 forward twin, or with `int4` R-F's."""
    rows, cols_host, _ = _quantizers(int4)
    dt = xc.dtype
    b, cpq, d = xc.shape
    hhd = heads * head_dim
    w8, sw = cols_host(wqkv)
    wo8, swo = cols_host(wo)

    def quant_ln(t):
        xhat, _ = _ln_stats(t.reshape(-1, d).float(), eps)
        return rows(_affine(xhat, gamma, beta))

    xq, sx = quant_ln(xc)
    xqk, sxk = quant_ln(x)
    q = _dequant(int_mm(xq, w8[:, :hhd]), sx, sw[:hhd], bqkv[:hhd]).to(dt)
    kv = _dequant(int_mm(xqk, w8[:, hhd:]), sxk, sw[hhd:],
                  bqkv[hhd:]).to(dt)
    attn = _rect_core(q.view(b, cpq, -1), kv.view(b, x.shape[1], -1),
                      seq_len, heads)
    aq, sa = rows(attn)
    y = _dequant(int_mm(aq, wo8), sa, swo, bo)
    _keep(scratch, w8=(w8, sw), wo8=(wo8, swo), xq=(xq, sx), xqk=(xqk, sxk),
          aq=(aq, sa))
    return y.to(dt).view(b, cpq, d)


def _rect_fwd(int8, xc, x, gamma, beta, wqkv, bqkv, wo, bo, eps, seq_len,
              heads, head_dim, int8_grad=False, int8_dw=False, scratch=None,
              int4=False, int4_grad=False):
    """K8's forward: on the card the two LNs, gemm_sm90.cuh's q and kv on
    the column slices of Wqkv, K13's core in the rect geometry, the
    out-projection (`int8`: its W8A8 tier, LN-quant, the s8 q and kv, the
    core with an fp32 out, the row codes, the s8 out-projection; with
    `int4` too, R-F, the first design)."""
    if _needs_grad(xc, x, gamma, beta, wqkv, bqkv, wo, bo):
        return FusedLnQkvoAttentionRectFn.apply(xc, x, gamma, beta, wqkv, bqkv,
                                                wo, bo, eps, seq_len, heads,
                                                head_dim, int8, int8_grad,
                                                int8_dw, int4, int4_grad)
    args = (xc, x, gamma, beta, wqkv, bqkv, wo, bo, eps, seq_len, heads,
            head_dim)
    if not xc.is_cuda:
        if int4:
            return fused_ln_qkvo_attention_rect_int4_ref(*args,
                                                         scratch=scratch)
        if int8:
            return fused_ln_qkvo_attention_rect_int8_ref(*args,
                                                         scratch=scratch)
        return fused_ln_qkvo_attention_rect_ref(*args)
    name = ("fused_ln_qkvo_attention_rect_int4" if int4
            else "fused_ln_qkvo_attention_rect_int8" if int8
            else "fused_ln_qkvo_attention_rect")
    _check_cuda(name, {"xc": xc, "x": x, "gamma": gamma, "beta": beta,
                       "wqkv": wqkv, "bqkv": bqkv, "wo": wo, "bo": bo},
                {"xc": _BF, "x": _BF, "gamma": _F32, "beta": _F32,
                 "wqkv": _BF, "bqkv": _F32, "wo": _BF, "bo": _F32})
    _check_rect(name, xc, x, gamma, beta, wqkv, bqkv, wo, bo, seq_len, heads,
                head_dim, int4=int4)
    dev = xc.device
    b, cpq, d = xc.shape
    spq = x.shape[1]
    hhd = heads * head_dim
    nc, n = b * cpq, b * spq
    out = torch.empty_like(xc)
    q, kv = _bf(dev, nc, hhd), _bf(dev, n, 2 * hhd)
    lib = build.load()
    tail = (b, cpq, spq, d, seq_len, heads, head_dim, eps,
            1.0 / math.sqrt(head_dim), _stream(dev))
    if int8:
        w8t, sw = _i8(dev, 3 * hhd, d), _f32(dev, 3 * hhd)
        wo8t, swo = _i8(dev, d, hhd), _f32(dev, d)
        xq, sx, xqk, sxk = _i8(dev, nc, d), _f32(dev, nc), _i8(dev, n, d), \
            _f32(dev, n)
        attn, aq, sa = _f32(dev, nc, hhd), _i8(dev, nc, hhd), _f32(dev, nc)
        fn = (lib.vitax_ln_qkvo_attention_rect_int4_fwd if int4
              else lib.vitax_ln_qkvo_attention_rect_int8_fwd)
        rc = fn(*(t.data_ptr() for t in (
            xc, x, gamma, beta, wqkv, bqkv, wo, bo, w8t, sw, wo8t, swo, xq, sx,
            xqk, sxk, q, kv, attn, aq, sa, out)), *tail)
        build.check(rc, name)
        (fused_ln_qkvo_attention_rect_int4 if int4
         else fused_ln_qkvo_attention_rect_int8).launches += 1
        _keep(scratch, w8=(w8t.t(), sw), wo8=(wo8t.t(), swo), xq=(xq, sx),
              xqk=(xqk, sxk), aq=(aq, sa))
    else:
        xnc, xn, attn = _bf(dev, nc, d), _bf(dev, n, d), _bf(dev, nc, hhd)
        rc = lib.vitax_ln_qkvo_attention_rect_fwd(*(t.data_ptr() for t in (
            xc, x, gamma, beta, wqkv, bqkv, wo, bo, xnc, xn, q, kv, attn,
            out)), *tail)
        build.check(rc, name)
        fused_ln_qkvo_attention_rect.launches += 1
    return out


def fused_ln_qkvo_attention_rect(xc, x, gamma, beta, wqkv, bqkv, wo, bo, eps,
                                 seq_len, heads, head_dim):
    """K8: the attention half for the compacted rows. xc [B, cpq, D] bf16
    (the gathered rows, pad rows zero-filled), x [B, spq, D] bf16 (all rows,
    padded stream), wqkv [D, 3·H·Hd], wo [H·Hd, D] bf16; gamma, beta, bqkv, bo
    fp32. Returns [B, cpq, D] without the residual. Under autograd through
    `FusedLnQkvoAttentionRectFn`, whose backward is
    `fused_ln_qkvo_attention_rect_bwd`."""
    return _rect_fwd(False, xc, x, gamma, beta, wqkv, bqkv, wo, bo, eps,
                     seq_len, heads, head_dim)


fused_ln_qkvo_attention_rect.launches = 0


def fused_ln_qkvo_attention_rect_int8(xc, x, gamma, beta, wqkv, bqkv, wo, bo,
                                      eps, seq_len, heads, head_dim,
                                      int8_grad=False, int8_dw=False, *,
                                      scratch=None):
    """`fused_ln_qkvo_attention_rect` with W8A8 projections (K8's int8 tier):
    K3's quantization grid, the core bf16 with fp32 attn. Under autograd the
    backward is K8's int8 backward with `int8_grad` (its int8 weight grads
    under `int8_dw`), else the bf16 one, vitax's tier rule (:4526).
    `scratch`: as `fused_ln_qkvo_attention_int8`'s, with xqk the codes of
    x's rows."""
    return _rect_fwd(True, xc, x, gamma, beta, wqkv, bqkv, wo, bo, eps,
                     seq_len, heads, head_dim, int8_grad, int8_dw, scratch)


fused_ln_qkvo_attention_rect_int8.launches = 0


def fused_ln_qkvo_attention_rect_int4(xc, x, gamma, beta, wqkv, bqkv, wo, bo,
                                      eps, seq_len, heads, head_dim,
                                      int8_grad=False, int8_dw=False,
                                      int4_grad=False, *, scratch=None):
    """R-F: `fused_ln_qkvo_attention_rect` with A4W4 projections
    (ln_qkvo_attention_rect_int8.cu at L = 7), the core bf16 with fp32
    attn. Under autograd the backward follows vitax's (:4526): `int8_grad`
    (the caller's int8 and int8_grad) with `int4_grad` is R-B (R-B dw
    under `int8_dw`), `int8_grad` alone K8's int8 backward, else K8's bf16
    one. `scratch`: as `fused_ln_qkvo_attention_rect_int8`'s."""
    return _rect_fwd(True, xc, x, gamma, beta, wqkv, bqkv, wo, bo, eps,
                     seq_len, heads, head_dim, int8_grad, int8_dw, scratch,
                     True, int4_grad)


fused_ln_qkvo_attention_rect_int4.launches = 0


def _rect_bwd_ref(xc, x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads,
                  head_dim, int8, int8_dw=False, groups=None, scratch=None,
                  int4=False):
    """Every tier of K8's backward twin (bf16; int8_grad; with `int4` the
    int4_grad branch, R-B); see the public twins."""
    dt = xc.dtype
    b, cpq, d = xc.shape
    spq = x.shape[1]
    hhd = heads * head_dim
    scale = 1.0 / math.sqrt(head_dim)
    wq, wkv = wqkv[:, :hhd], wqkv[:, hhd:]
    do2 = do.reshape(-1, d)
    xhat_c, rstd_c = _ln_stats(xc.reshape(-1, d).float(), eps)
    xhat_k, rstd_k = _ln_stats(x.reshape(-1, d).float(), eps)
    rows, cols_host, rows_host = _quantizers(int4)
    if int8:
        w8, sw = cols_host(wqkv)
        wq8r, swqr = rows_host(wq)
        wkv8r, swkvr = rows_host(wkv)
        wo8r, swor = rows_host(wo)
        xnc32 = _affine(xhat_c, gamma, beta)
        xn32 = _affine(xhat_k, gamma, beta)
        xqc, sxc = rows(xnc32)
        xqk, sxk = rows(xn32)
        q = _dequant(int_mm(xqc, w8[:, :hhd]), sxc, sw[:hhd], bqkv[:hhd])
        kv = _dequant(int_mm(xqk, w8[:, hhd:]), sxk, sw[hhd:], bqkv[hhd:])
        xnc, xn = xnc32.to(dt), xn32.to(dt)
    else:
        xnc = (xhat_c * gamma.float() + beta.float()).to(dt)
        xn = (xhat_k * gamma.float() + beta.float()).to(dt)
        q = matmul_f32(xnc, wq) + bqkv[:hhd].float()
        kv = matmul_f32(xn, wkv) + bqkv[hhd:].float()
    qh, k, v = _rect_heads(q.to(dt).view(b, cpq, hhd),
                           kv.to(dt).view(b, spq, 2 * hhd), heads)
    p, o32 = _softmax_pv(qh, k, v, seq_len)
    o = o32.to(dt)
    attn = _heads_to_rows(o)
    if int8:
        doq, sdo = rows(do2.float())
        dattn = _dequant(int_mm(doq, wo8r.t()), sdo, swor).to(dt)
    else:
        dattn = matmul_f32(do2, wo.t()).to(dt)
    dqh, dk, dv = _core_grads(qh, k, v, p, o, dattn, scale)
    dq = _heads_to_rows(dqh)
    dkv = torch.cat([_heads_to_rows(dk), _heads_to_rows(dv)], dim=1)
    if int8:
        dqq, sdq = rows(dq.float())
        dkvq, sdkv = rows(dkv.float())
        dxnc = _dequant(int_mm(dqq, wq8r.t()), sdq, swqr)
        dxn = _dequant(int_mm(dkvq, wkv8r.t()), sdkv, swkvr)
        _keep(scratch, w8=(w8, sw), wq8r=(wq8r, swqr), wkv8r=(wkv8r, swkvr),
              wo8r=(wo8r, swor), xq=(xqc, sxc), xqk=(xqk, sxk),
              doq=(doq, sdo), dqq=(dqq, sdq), dkvq=(dkvq, sdkv))
    else:
        dxnc = matmul_f32(dq, wq.t())
        dxn = matmul_f32(dkv, wkv.t())
    if int8_dw and int4:
        group_c, group_k = groups or qkvo_rect_dw_groups(b, cpq, spq)
        dwo, atc, doc = _dw_int8_cols(attn, do2, group_c)
        dwq, xncc, dqc = _dw_int8_cols(xnc32, dq, group_c)
        dwkv, xnkc, dkvc = _dw_int8_cols(xn32, dkv, group_k)
        _keep(scratch, atc=atc, doc=doc, xnc=xncc, dqc=dqc, xnk=xnkc,
              dkvc=dkvc)
    elif int8_dw:
        group_c, group_k = groups or qkvo_rect_dw_groups(b, cpq, spq)
        dwo, atc = _dw_int8(attn, sdo, doq, group_c)
        dwq, xncc = _dw_int8(xnc32, sdq, dqq, group_c)
        dwkv, xnkc = _dw_int8(xn32, sdkv, dkvq, group_k)
        _keep(scratch, atc=atc, xnc=xncc, xnk=xnkc)
    else:
        dwo = matmul_f32(attn.t(), do2)
        dwq = matmul_f32(xnc.t(), dq)
        dwkv = matmul_f32(xn.t(), dkv)
    dxc, dg, dbe = _ln_bwd_tail(dxnc, xhat_c, rstd_c, gamma)
    dx, dg2, dbe2 = _ln_bwd_tail(dxn, xhat_k, rstd_k, gamma)
    return (dxc.to(dt).view(b, cpq, d), dx.to(dt).view(b, spq, d), dg + dg2,
            dbe + dbe2, torch.cat([dwq, dwkv], dim=1),
            torch.cat([dq.float().sum(dim=0), dkv.float().sum(dim=0)]), dwo,
            do2.float().sum(dim=0))


def fused_ln_qkvo_attention_rect_bwd_ref(xc, x, gamma, beta, wqkv, bqkv, wo,
                                         do, eps, seq_len, heads, head_dim):
    """(dxc, dx, dγ, dβ, dWqkv, dbqkv, dWo, dbo) of K8 with the TPU kernel's
    rounding points (_ln_qkvo_rect_bwd_kernel, pallas_kernels.py:4168-4228):
    q and kv bf16, p fp32 (bf16 into PV and dV), ds, dq, dk, dv, dattn in
    xc.dtype, dxnc and dxn fp32 into one LN backward each; dxc and dx in
    xc.dtype; dγ, dβ summed over both row sets; dWqkv = [xncᵀ·dq | xnᵀ·dkv],
    dbqkv, dWo, dbo fp32."""
    return _rect_bwd_ref(xc, x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len,
                         heads, head_dim, False)


def fused_ln_qkvo_attention_rect_int8_bwd_ref(xc, x, gamma, beta, wqkv, bqkv,
                                              wo, do, eps, seq_len, heads,
                                              head_dim, *, int8_dw=False,
                                              groups=None, scratch=None):
    """K8's backward under int8_grad with the TPU kernel's rounding points
    (_ln_qkvo_rect_bwd_int8_kernel, pallas_kernels.py:4273-4385): the int8
    q, kv recompute from the fp32 LN outputs, bf16 attn, dattn =
    bf16(f32(doq·Wo_rᵀ)·sdo·swor), the bf16 core grads, dxnc =
    f32(dqq·Wq_rᵀ)·sdq·swqr and dxn = f32(dkvq·Wkv_rᵀ)·sdkv·swkvr with the
    row codes of the slices Wq and Wkv. Weight grads: bf16 products, or with
    `int8_dw` the per-group int8 products over `groups` = (rows of xc, rows
    of x) a group, by default `qkvo_rect_dw_groups`. `scratch` receives the
    codes: w8, wq8r, wkv8r, wo8r, xq (xc's rows), xqk (x's), doq, dqq,
    dkvq; under int8_dw the column codes atc, xnc and xnk too."""
    return _rect_bwd_ref(xc, x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len,
                         heads, head_dim, True, int8_dw, groups, scratch)


def fused_ln_qkvo_attention_rect_int8_dw_bwd_ref(xc, x, gamma, beta, wqkv,
                                                 bqkv, wo, do, eps, seq_len,
                                                 heads, head_dim, *,
                                                 scratch=None):
    """The twin of `fused_ln_qkvo_attention_rect_int8_dw_bwd`."""
    return _rect_bwd_ref(xc, x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len,
                         heads, head_dim, True, True, None, scratch)


def fused_ln_qkvo_attention_rect_int4_bwd_ref(xc, x, gamma, beta, wqkv, bqkv,
                                              wo, do, eps, seq_len, heads,
                                              head_dim, *, int8_dw=False,
                                              groups=None, scratch=None):
    """R-B, K8's backward under int8_grad and int4_grad with the TPU
    kernel's rounding points (_ln_qkvo_rect_bwd_int8_kernel, pallas_kernels.
    py:4273-4385, _qr = _quant_rows4 :4272, the weights by _quant_cols_host4
    and _quant_rows_host4 :4523-4529): the int8 twin with every quantizer
    of the recompute and the dx-path on the int4 grid, the core grads bf16.
    Weight grads: bf16 products, or with `int8_dw` (R-B dw) Σ over groups
    of `groups` = (rows of xc, rows of x), by default `qkvo_rect_dw_groups`,
    of int8 products of both operands packed fresh per column (attn with
    do, the fp32 LN outputs with dq and dkv; pad rows included, as vitax's).
    `scratch`: the int8 twin's codes, and under int8_dw the column codes
    atc, doc (dWo), xnc, dqc (dWq), xnk, dkvc (dWkv)."""
    return _rect_bwd_ref(xc, x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len,
                         heads, head_dim, True, int8_dw, groups, scratch, True)


def fused_ln_qkvo_attention_rect_int4_dw_bwd_ref(xc, x, gamma, beta, wqkv,
                                                 bqkv, wo, do, eps, seq_len,
                                                 heads, head_dim, *,
                                                 scratch=None):
    """The twin of `fused_ln_qkvo_attention_rect_int4_dw_bwd`."""
    return _rect_bwd_ref(xc, x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len,
                         heads, head_dim, True, True, None, scratch, True)


def _rect_bwd_cuda(name, int8, int8_dw, xc, x, gamma, beta, wqkv, bqkv, wo,
                   do, eps, seq_len, heads, head_dim, scratch=None,
                   int4=False):
    """The launch of K8's backward, any tier (`int4`: R-B's, the int8
    tier's sequence at L = 7): the Hopper design (K13's three passes in the
    rect geometry, their row statistics the only attention scratch;
    gemm_sm90.cuh's products, the s8 path in the int8 and int4 tiers)."""
    dev = _check_cuda(
        name, {"xc": xc, "x": x, "gamma": gamma, "beta": beta, "wqkv": wqkv,
               "bqkv": bqkv, "wo": wo, "do": do},
        {"xc": _BF, "x": _BF, "gamma": _F32, "beta": _F32, "wqkv": _BF,
         "bqkv": _F32, "wo": _BF, "do": _BF})
    _check_rect(name, xc, x, gamma, beta, wqkv, bqkv, wo, None, seq_len, heads,
                head_dim, backward=True)
    _check_shape(name, "do", do, tuple(xc.shape))
    b, cpq, d = xc.shape
    spq = x.shape[1]
    hhd = heads * head_dim
    nc, n = b * cpq, b * spq
    lib = build.load()
    dxc, dx, dg, dbe = (torch.empty_like(xc), torch.empty_like(x),
                        _f32(dev, d), _f32(dev, d))
    dwq, dwkv, dbq, dbkv = (_f32(dev, d, hhd), _f32(dev, d, 2 * hhd),
                            _f32(dev, hhd), _f32(dev, 2 * hhd))
    dwo, dbo = _f32(dev, hhd, d), _f32(dev, d)
    outs = (dxc, dx, dg, dbe, dwq, dwkv, dbq, dbkv, dwo, dbo)
    q, kv, attn, dattn = (_bf(dev, nc, hhd), _bf(dev, n, 2 * hhd),
                          _bf(dev, nc, hhd), _bf(dev, nc, hhd))
    # the core's only scratch: K13's row statistics (padded from cpq)
    stats = _workspace(lib.vitax_attention_core_bwd_ws(b, cpq, heads), dev)
    dq, dkv = _bf(dev, nc, hhd), _bf(dev, n, 2 * hhd)
    dxnc, dxn, g2, b2 = (_f32(dev, nc, d), _f32(dev, n, d), _f32(dev, d),
                         _f32(dev, d))
    ws = _workspace(lib.vitax_ln_qkvo_attention_rect_bwd_ws(nc, n, d, hhd),
                    dev)
    scale = 1.0 / math.sqrt(head_dim)
    if not int8:
        xnc, xn = _bf(dev, nc, d), _bf(dev, n, d)
        rc = lib.vitax_ln_qkvo_attention_rect_bwd(*(t.data_ptr() for t in (
            xc, x, gamma, beta, wqkv, bqkv, wo, do, *outs, xnc, xn, q, kv,
            attn, dattn, stats, dq, dkv, dxnc, dxn, g2, b2, ws)), b, cpq, spq,
            d, seq_len, heads, head_dim, eps, scale, _stream(dev))
        build.check(rc, name)
        return outs[:4] + (torch.cat([dwq, dwkv], dim=1),
                           torch.cat([dbq, dbkv]), dwo, dbo)
    w8t, sw = _i8(dev, 3 * hhd, d), _f32(dev, 3 * hhd)
    wq8r, swqr = _i8(dev, d, hhd), _f32(dev, d)
    wkv8r, swkvr = _i8(dev, d, 2 * hhd), _f32(dev, d)
    wo8r, swor = _i8(dev, hhd, d), _f32(dev, hhd)
    # xnc, xn: bf16 for the bf16 weight grads, fp32 under int8_dw
    xnc, xn = (_f32 if int8_dw else _bf)(dev, nc, d), \
        (_f32 if int8_dw else _bf)(dev, n, d)
    xqc, sxc, xqk, sxk = _i8(dev, nc, d), _f32(dev, nc), _i8(dev, n, d), \
        _f32(dev, n)
    doq, sdo = _i8(dev, nc, d), _f32(dev, nc)
    dqq, sdq, dkvq, sdkv = _i8(dev, nc, hhd), _f32(dev, nc), \
        _i8(dev, n, 2 * hhd), _f32(dev, n)
    group_c, group_k = qkvo_rect_dw_groups(b, cpq, spq)
    # int8_dw: (attn | do) column codes and scales for dWo, (xnc | dq) for
    # dWq, (xn | dkv) for dWkv; K8 reuses do's, dq's and dkv's row codes,
    # so it has no scales of its own for them (R-B's are the fourth, eighth
    # and last)
    dwt = [None] * 12
    if int8_dw:
        groups, kpc = _dw_layout(nc, group_c)
        _, kpk = _dw_layout(n, group_k)
        dwt = [_i8(dev, hhd, kpc), _f32(dev, groups, hhd), _i8(dev, d, kpc),
               _f32(dev, groups, d) if int4 else None,
               _i8(dev, d, kpc), _f32(dev, groups, d), _i8(dev, hhd, kpc),
               _f32(dev, groups, hhd) if int4 else None,
               _i8(dev, d, kpk), _f32(dev, groups, d),
               _i8(dev, 2 * hhd, kpk),
               _f32(dev, groups, 2 * hhd) if int4 else None]
    ptrs = [None if t is None else t.data_ptr() for t in dwt]
    if not int4:
        del ptrs[11], ptrs[7], ptrs[3]
    fn = (lib.vitax_ln_qkvo_attention_rect_int4_bwd if int4
          else lib.vitax_ln_qkvo_attention_rect_int8_bwd)
    rc = fn(*(t.data_ptr() for t in (
        xc, x, gamma, beta, bqkv, wqkv, wo, do, *outs, w8t, sw, wq8r, swqr,
        wkv8r, swkvr, wo8r, swor, xnc, xqc, sxc, xn, xqk, sxk, q, kv, attn,
        doq, sdo, dattn, stats, dq, dkv, dqq, sdq, dkvq, sdkv, dxnc, dxn, g2,
        b2, ws)), *ptrs, b, cpq, spq, d, seq_len, heads, head_dim, group_c,
        group_k, int(int8_dw), eps, scale, _stream(dev))
    build.check(rc, name)
    _keep(scratch, w8=(w8t.t(), sw), wq8r=(wq8r, swqr), wkv8r=(wkv8r, swkvr),
          wo8r=(wo8r, swor), xq=(xqc, sxc), xqk=(xqk, sxk), doq=(doq, sdo),
          dqq=(dqq, sdq), dkvq=(dkvq, sdkv))
    if int8_dw:
        _keep(scratch, atc=(_group_codes(dwt[0], nc, group_c), dwt[1]),
              xnc=(_group_codes(dwt[4], nc, group_c), dwt[5]),
              xnk=(_group_codes(dwt[8], n, group_k), dwt[9]))
    if int8_dw and int4:
        _keep(scratch, doc=(_group_codes(dwt[2], nc, group_c), dwt[3]),
              dqc=(_group_codes(dwt[6], nc, group_c), dwt[7]),
              dkvc=(_group_codes(dwt[10], n, group_k), dwt[11]))
    return outs[:4] + (torch.cat([dwq, dwkv], dim=1), torch.cat([dbq, dbkv]),
                       dwo, dbo)


def fused_ln_qkvo_attention_rect_bwd(xc, x, gamma, beta, wqkv, bqkv, wo, do,
                                     eps, seq_len, heads, head_dim):
    """Backward of `fused_ln_qkvo_attention_rect`: dxc [B, cpq, D] and dx
    [B, spq, D] bf16, fp32 dγ, dβ [D], dWqkv [D, 3·H·Hd], dbqkv [3·H·Hd],
    dWo [H·Hd, D], dbo [D]; do [B, cpq, D] bf16."""
    if not xc.is_cuda:
        return fused_ln_qkvo_attention_rect_bwd_ref(
            xc, x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads,
            head_dim)
    out = _rect_bwd_cuda("fused_ln_qkvo_attention_rect_bwd", False, False, xc,
                         x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len,
                         heads, head_dim)
    fused_ln_qkvo_attention_rect_bwd.launches += 1
    return out


fused_ln_qkvo_attention_rect_bwd.launches = 0


def fused_ln_qkvo_attention_rect_int8_bwd(xc, x, gamma, beta, wqkv, bqkv, wo,
                                          do, eps, seq_len, heads, head_dim,
                                          *, scratch=None):
    """Backward of `fused_ln_qkvo_attention_rect_int8` under int8_grad, the
    outputs of `fused_ln_qkvo_attention_rect_bwd`. `scratch`: as the
    twin's."""
    if not xc.is_cuda:
        return fused_ln_qkvo_attention_rect_int8_bwd_ref(
            xc, x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads,
            head_dim, scratch=scratch)
    out = _rect_bwd_cuda("fused_ln_qkvo_attention_rect_int8_bwd", True, False,
                         xc, x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len,
                         heads, head_dim, scratch)
    fused_ln_qkvo_attention_rect_int8_bwd.launches += 1
    return out


fused_ln_qkvo_attention_rect_int8_bwd.launches = 0


def fused_ln_qkvo_attention_rect_int8_dw_bwd(xc, x, gamma, beta, wqkv, bqkv,
                                             wo, do, eps, seq_len, heads,
                                             head_dim, *, scratch=None):
    """`fused_ln_qkvo_attention_rect_int8_bwd` under int8_dw: dWo and dWq
    per-group int8 products over tile·cpq rows of xc, dWkv over tile·spq
    rows of x (`qkvo_rect_dw_groups`); `scratch` also receives the column
    codes atc, xnc and xnk, as [rows, width] with one scale a column a
    group."""
    if not xc.is_cuda:
        return fused_ln_qkvo_attention_rect_int8_dw_bwd_ref(
            xc, x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads,
            head_dim, scratch=scratch)
    out = _rect_bwd_cuda("fused_ln_qkvo_attention_rect_int8_dw_bwd", True,
                         True, xc, x, gamma, beta, wqkv, bqkv, wo, do, eps,
                         seq_len, heads, head_dim, scratch)
    fused_ln_qkvo_attention_rect_int8_dw_bwd.launches += 1
    return out


fused_ln_qkvo_attention_rect_int8_dw_bwd.launches = 0


def fused_ln_qkvo_attention_rect_int4_bwd(xc, x, gamma, beta, wqkv, bqkv, wo,
                                          do, eps, seq_len, heads, head_dim,
                                          *, scratch=None):
    """R-B: the backward of `fused_ln_qkvo_attention_rect_int4` under
    int8_grad and int4_grad (ln_qkvo_attention_rect_int8_bwd.cu at L = 7),
    the outputs of `fused_ln_qkvo_attention_rect_bwd`. `scratch`: as the
    twin's."""
    if not xc.is_cuda:
        return fused_ln_qkvo_attention_rect_int4_bwd_ref(
            xc, x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads,
            head_dim, scratch=scratch)
    out = _rect_bwd_cuda("fused_ln_qkvo_attention_rect_int4_bwd", True, False,
                         xc, x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len,
                         heads, head_dim, scratch, int4=True)
    fused_ln_qkvo_attention_rect_int4_bwd.launches += 1
    return out


fused_ln_qkvo_attention_rect_int4_bwd.launches = 0


def fused_ln_qkvo_attention_rect_int4_dw_bwd(xc, x, gamma, beta, wqkv, bqkv,
                                             wo, do, eps, seq_len, heads,
                                             head_dim, *, scratch=None):
    """R-B dw: `fused_ln_qkvo_attention_rect_int4_bwd` under int8_dw, dWo and
    dWq over tile·cpq rows of xc, dWkv over tile·spq rows of x
    (`qkvo_rect_dw_groups`), both operands of each packed fresh per column;
    `scratch` also receives those column codes, atc, doc, xnc, dqc, xnk and
    dkvc, as [rows, width] with one scale a column a group."""
    if not xc.is_cuda:
        return fused_ln_qkvo_attention_rect_int4_dw_bwd_ref(
            xc, x, gamma, beta, wqkv, bqkv, wo, do, eps, seq_len, heads,
            head_dim, scratch=scratch)
    out = _rect_bwd_cuda("fused_ln_qkvo_attention_rect_int4_dw_bwd", True,
                         True, xc, x, gamma, beta, wqkv, bqkv, wo, do, eps,
                         seq_len, heads, head_dim, scratch, int4=True)
    fused_ln_qkvo_attention_rect_int4_dw_bwd.launches += 1
    return out


fused_ln_qkvo_attention_rect_int4_dw_bwd.launches = 0


class FusedLnQkvoAttentionRectFn(torch.autograd.Function):
    """K8 under autograd, saving (xc, x, γ, β, Wqkv, bqkv, Wo) as vitax's
    custom VJP (_fused_ln_qkvo_rect_fwd :4480): the forward is the kernel
    (`int8`: its W8A8 tier; `int4`: R-F); the backward, as vitax's
    (:4526), is for `int8` with `int8_grad` R-B under `int4_grad`, else
    K8's int8 backward (each one's int8_dw variant under `int8_dw`), else
    the bf16 one."""

    @staticmethod
    def forward(ctx, xc, x, gamma, beta, wqkv, bqkv, wo, bo, eps, seq_len,
                heads, head_dim, int8, int8_grad, int8_dw, int4=False,
                int4_grad=False):
        ctx.save_for_backward(xc, x, gamma, beta, wqkv, bqkv, wo)
        ctx.meta = (eps, seq_len, heads, head_dim)
        ctx.tier = (int8 and int8_grad, int8_dw, int4_grad)
        ctx.bo_dtype = bo.dtype
        fwd = (fused_ln_qkvo_attention_rect_int4 if int4
               else fused_ln_qkvo_attention_rect_int8 if int8
               else fused_ln_qkvo_attention_rect)
        return fwd(xc, x, gamma, beta, wqkv, bqkv, wo, bo, eps, seq_len, heads,
                   head_dim)

    @staticmethod
    def backward(ctx, do):
        xc, x, gamma, beta, wqkv, bqkv, wo = ctx.saved_tensors
        int8_grad, int8_dw, int4_grad = ctx.tier
        bwd = (fused_ln_qkvo_attention_rect_bwd if not int8_grad
               else fused_ln_qkvo_attention_rect_int4_dw_bwd
               if int4_grad and int8_dw
               else fused_ln_qkvo_attention_rect_int4_bwd if int4_grad
               else fused_ln_qkvo_attention_rect_int8_dw_bwd if int8_dw
               else fused_ln_qkvo_attention_rect_int8_bwd)
        dxc, dx, dg, dbe, dw, db, dwo, dbo = bwd(
            xc, x, gamma, beta, wqkv, bqkv, wo, do.contiguous(), *ctx.meta)
        return (dxc, dx, dg.to(gamma.dtype), dbe.to(beta.dtype),
                dw.to(wqkv.dtype), db.to(bqkv.dtype), dwo.to(wo.dtype),
                dbo.to(ctx.bo_dtype), None, None, None, None, None, None,
                None, None, None)


# =============================================================================
# K10 — fused QKV projection + attention core, no LN and no out-projection
# (fused_qkv_attention :2369, pallas_calls :2307 and :2334), on the first
# launches of K1's Hopper sequence: what vitax's Res-ViT `attention` runs
# for fused_qkv without fused_qkvo (vitax/models/resvit.py:278)
# =============================================================================

def fused_qkv_attention_supported(x, wqkv, heads) -> bool:
    """K10's gate: x̂ [B, S, D] (S padded to spq by the caller), wqkv [D,
    3·H·Hd]: the shapes of K1's Hopper sequence, as K9's
    (`_k13_shapes_fit`: K13's core and gemm_sm90.cuh's products), without a
    dtype test, so that a CUDA fp32 input reaches the wrapper, which raises
    (`check_k10_dtype`)."""
    return _k13_shapes_fit(x, wqkv, heads)


def fused_qkv_attention_bwd_supported(x, wqkv, heads) -> bool:
    """K10's gate in training: the forward's (K13's backward passes take
    what its forward takes)."""
    return fused_qkv_attention_supported(x, wqkv, heads)


def check_k10_dtype(name: str, dtype: torch.dtype) -> None:
    """K10's kernels are bf16 only. vitax's K10 takes any dtype, so an fp32
    Res-ViT on the card reaches it in fp32, which is a later slice of the
    port; raise rather than run another function."""
    if dtype != _BF:
        raise NotImplementedError(
            f"{name}: {dtype} on the card: K10's kernels take bf16 only; "
            'fp32 tiers of the fused kernels are ROADMAP Queue 1 item 9, '
            '"fp32 models on the card". Run the model in bf16, or with '
            "fused_qkv=False")


def fused_qkv_attention_ref(x, wqkv, bqkv, seq_len, heads, head_dim):
    """K10's twin, at the TPU kernel's rounding points (_qkv_attn_fwd_kernel,
    pallas_kernels.py:2216-2237): qkv = (x̂ W + b) in x's dtype, per head the
    fp32 softmax p of q·kᵀ/√Hd (key cols ≥ seq_len masked) and o = (p in x's
    dtype)·v cast to x's dtype, heads side by side. x [B, spq, D] →
    [B, spq, H·Hd]."""
    b, spq, _ = x.shape
    *_, o = _qkvo_core(x, wqkv, bqkv, seq_len, heads, head_dim)
    return _heads_to_rows(o).view(b, spq, heads * head_dim)


def fused_qkv_attention(x, wqkv, bqkv, seq_len, heads, head_dim):
    """K10 forward (csrc/qkv_attention.cu: the qkv product and K13's core,
    qkvo_sm90.cuh's `qkv_core`, so that its head outputs are the ones K9
    projects on the same input): x̂ [B, spq, D] (the LN output,
    pad rows past seq_len allowed) bf16, wqkv [D, 3·H·Hd] bf16 with columns
    [q heads | k heads | v heads], bqkv [3·H·Hd] fp32 → the heads' attention
    outputs side by side, [B, spq, H·Hd], before the out-projection. CPU
    tensors take the twin; CUDA bf16 tensors inside the gate the kernel; a
    CUDA fp32 input raises (`check_k10_dtype`). Under autograd the backward
    is `fused_qkv_attention_bwd` (`FusedQkvAttentionFn`)."""
    if _needs_grad(x, wqkv, bqkv):
        return FusedQkvAttentionFn.apply(x, wqkv, bqkv, seq_len, heads,
                                         head_dim)
    if not x.is_cuda:
        return fused_qkv_attention_ref(x, wqkv, bqkv, seq_len, heads,
                                       head_dim)
    name = "fused_qkv_attention"
    dev = _check_k10(name, {"x": x, "wqkv": wqkv, "bqkv": bqkv}, seq_len,
                     heads, head_dim, fused_qkv_attention_supported)
    b, spq, d = x.shape
    qkv = _bf(dev, b * spq, 3 * heads * head_dim)
    out = _bf(dev, b, spq, heads * head_dim)
    rc = build.load().vitax_qkv_attention_fwd(
        x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), qkv.data_ptr(),
        out.data_ptr(), b, spq, d, seq_len, heads, head_dim,
        1.0 / math.sqrt(head_dim), _stream(dev))
    build.check(rc, name)
    fused_qkv_attention.launches += 1
    return out


fused_qkv_attention.launches = 0


def _check_k10(name, tensors, seq_len, heads, head_dim, gate):
    """K10's launch checks: bf16 only (Queue 1 item 9's raise), then device,
    dtypes, contiguity and shapes; returns the device."""
    for key in ("x", "wqkv"):
        if tensors[key].is_cuda:
            check_k10_dtype(name, tensors[key].dtype)
    dev = _check_cuda(name, tensors, {"x": _BF, "wqkv": _BF, "bqkv": _F32,
                                      "do": _BF})
    x, wqkv = tensors["x"], tensors["wqkv"]
    b, spq, d = x.shape
    width = 3 * heads * head_dim
    if (spq % 8 or not 0 < seq_len <= spq or tuple(wqkv.shape) != (d, width)
            or not gate(x, wqkv, heads)):
        raise ValueError(
            f"{name}: unsupported shapes x {tuple(x.shape)} wqkv "
            f"{tuple(wqkv.shape)} seq_len {seq_len} heads {heads} head_dim "
            f"{head_dim}")
    _check_shape(name, "bqkv", tensors["bqkv"], (width,))
    if "do" in tensors:
        _check_shape(name, "do", tensors["do"], (b, spq, heads * head_dim))
    return dev


def fused_qkv_attention_bwd_ref(x, wqkv, bqkv, do, seq_len, heads,
                                head_dim):
    """(dx, dWqkv, dbqkv) of K10 at the TPU kernel's rounding points
    (_qkv_attn_bwd_kernel, pallas_kernels.py:2239-2303): qkv and p
    recomputed as the forward's, dd = Σ fp32(dO)·o32 with o32 the fp32 p·v
    before its cast (K1's backward takes the cast one), ds, dq, dk, dv in
    x's dtype, dx = dqkv Wᵀ in x's dtype, dW = x̂ᵀ dqkv and db = Σ
    fp32(dqkv) in fp32. do [B, spq, H·Hd]."""
    dt = x.dtype
    b, spq, d = x.shape
    qkv = (matmul_f32(x, wqkv) + bqkv.float()).to(dt)
    q, k, v, p, o32 = _attn_core(qkv, seq_len, heads, head_dim)
    dqkv = _attn_core_grads(q, k, v, p, o32, do.reshape(b * spq, -1),
                            1.0 / math.sqrt(head_dim))
    dx = matmul_f32(dqkv, wqkv.t()).to(dt).view(b, spq, d)
    return dx, matmul_f32(x.reshape(-1, d).t(), dqkv), dqkv.float().sum(0)


def fused_qkv_attention_bwd(x, wqkv, bqkv, do, seq_len, heads, head_dim):
    """K10 backward (csrc/qkv_attention_bwd.cu: the qkv recompute, K13's
    row pass with dd from the fp32 head outputs, its key and query passes,
    the QKV projection's grads as K9's; K13's row statistics its only
    attention scratch, no P, ds or fp32 head outputs): from the saved
    (x̂, W, b) and dO [B, spq, H·Hd] bf16, dx [B, spq, D] bf16 and fp32
    dWqkv [D, 3·H·Hd] and dbqkv [3·H·Hd]."""
    if not x.is_cuda:
        return fused_qkv_attention_bwd_ref(x, wqkv, bqkv, do, seq_len, heads,
                                           head_dim)
    name = "fused_qkv_attention_bwd"
    dev = _check_k10(name, {"x": x, "wqkv": wqkv, "bqkv": bqkv, "do": do},
                     seq_len, heads, head_dim,
                     fused_qkv_attention_bwd_supported)
    b, spq, d = x.shape
    n, w = b * spq, 3 * heads * head_dim
    lib = build.load()
    dx, dw, db = torch.empty_like(x), _f32(dev, d, w), _f32(dev, w)
    qkv, dqkv = _bf(dev, n, w), _bf(dev, n, w)
    stats = _workspace(lib.vitax_attention_core_bwd_ws(b, spq, heads), dev)
    ws = _workspace(lib.vitax_qkv_attention_bwd_ws(n, d, w), dev)
    rc = lib.vitax_qkv_attention_bwd(*(t.data_ptr() for t in (
        x, wqkv, bqkv, do, dx, dw, db, qkv, stats, dqkv, ws)), b, spq, d,
        seq_len, heads, head_dim, 1.0 / math.sqrt(head_dim), _stream(dev))
    build.check(rc, name)
    fused_qkv_attention_bwd.launches += 1
    return dx, dw, db


fused_qkv_attention_bwd.launches = 0


class FusedQkvAttentionFn(torch.autograd.Function):
    """K10 with its backward kernel, saving (x̂, Wqkv, bqkv) as vitax's
    custom VJP (pallas_kernels.py:2369-2391): dW comes back in W's dtype
    (bf16 in a bf16 model, before the fp32 params and the LoRA fold see
    it) and db in bqkv's (fp32), as vitax's VJP casts them."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, seq_len, heads, head_dim):
        ctx.save_for_backward(x, wqkv, bqkv)
        ctx.meta = (seq_len, heads, head_dim)
        return fused_qkv_attention(x, wqkv, bqkv, seq_len, heads, head_dim)

    @staticmethod
    def backward(ctx, do):
        x, wqkv, bqkv = ctx.saved_tensors
        dx, dw, db = fused_qkv_attention_bwd(x, wqkv, bqkv, do.contiguous(),
                                             *ctx.meta)
        return dx, dw.to(wqkv.dtype), db.to(bqkv.dtype), None, None, None


# =============================================================================
# K9 — the QKV projection, the attention core and the out-projection of the
# LN'd input (fused_qkvo_attention :2551, pallas_calls :2559 and :2593), on
# K1's Hopper sequence without its LN: what vitax's Res-ViT `attention` runs
# under a mesh (vitax/models/resvit.py:266-277), and per model shard under
# tensor parallelism (vitax/parallel/tp_kernels.py:75-103)
# =============================================================================

def fused_qkvo_attention_supported(x, wqkv, heads) -> bool:
    """K9's gate: x̂ [B, S, D] (S padded to spq by the caller), wqkv [D,
    3·H·Hd]: the shapes of K1's Hopper sequence (`_k13_shapes_fit`: K13's
    core and gemm_sm90.cuh's products) without a dtype test, so that a
    CUDA fp32 input reaches the wrapper, which raises (`check_k9_dtype`)."""
    return _k13_shapes_fit(x, wqkv, heads)


def fused_qkvo_attention_bwd_supported(x, wqkv, heads) -> bool:
    """K9's gate in training: the forward's (K13's backward passes take
    what its forward takes)."""
    return fused_qkvo_attention_supported(x, wqkv, heads)


def check_k9_dtype(name: str, dtype: torch.dtype) -> None:
    """K9's kernels are bf16 only. vitax's K9 takes any dtype, so an fp32
    Res-ViT under a mesh reaches it in fp32, which is a later slice of the
    port; raise rather than run another function."""
    if dtype != _BF:
        raise NotImplementedError(
            f"{name}: {dtype} on the card: K9's kernels take bf16 only; "
            'fp32 tiers of the fused kernels are ROADMAP Queue 1 item 9, '
            '"fp32 models on the card". Run the model in bf16')


def fused_qkvo_attention_ref(x, wqkv, bqkv, wo, bo, seq_len, heads,
                             head_dim):
    """K9's twin, at the TPU kernel's rounding points (_qkvo_attn_fwd_kernel,
    pallas_kernels.py:2396-2429): K10's twin (qkv in x's dtype, per head the
    fp32 softmax p with key cols >= seq_len masked, o = (p in x's dtype)·v
    cast to x's dtype), then attn·Wo + bo with bo added in fp32, cast to x's
    dtype. x [B, spq, D] → [B, spq, Wo's columns]."""
    b, spq, _ = x.shape
    *_, o = _qkvo_core(x, wqkv, bqkv, seq_len, heads, head_dim)
    y = matmul_f32(_heads_to_rows(o), wo) + bo.float()
    return y.to(x.dtype).view(b, spq, wo.shape[1])


def fused_qkvo_attention(x, wqkv, bqkv, wo, bo, seq_len, heads, head_dim):
    """K9 forward (csrc/qkvo_attention.cu: K1's Hopper sequence after its
    LN, qkvo_sm90.cuh, so that K9 on LN(x) is K1 on x to the bit): x̂ [B,
    spq, D] (the LN output, pad rows past seq_len allowed) bf16, wqkv [D,
    3·H·Hd] bf16 with columns [q heads | k heads | v heads], bqkv [3·H·Hd]
    fp32, wo [H·Hd, D] bf16, bo [D] fp32 → the projected attention output
    [B, spq, D], no residual. CPU
    tensors take the twin; CUDA bf16 tensors inside the gate the kernel; a
    CUDA fp32 input raises (`check_k9_dtype`). Under autograd the backward
    is `fused_qkvo_attention_bwd` (`FusedQkvoAttentionFn`)."""
    if _needs_grad(x, wqkv, bqkv, wo, bo):
        return FusedQkvoAttentionFn.apply(x, wqkv, bqkv, wo, bo, seq_len,
                                          heads, head_dim)
    if not x.is_cuda:
        return fused_qkvo_attention_ref(x, wqkv, bqkv, wo, bo, seq_len, heads,
                                        head_dim)
    name = "fused_qkvo_attention"
    dev = _check_k9(name, {"x": x, "wqkv": wqkv, "bqkv": bqkv, "wo": wo,
                           "bo": bo}, seq_len, heads, head_dim,
                    fused_qkvo_attention_supported)
    b, spq, d = x.shape
    n, hhd = b * spq, heads * head_dim
    qkv, attn = _bf(dev, n, 3 * hhd), _bf(dev, n, hhd)
    out = torch.empty_like(x)
    rc = build.load().vitax_qkvo_attention_fwd(
        x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(),
        bo.data_ptr(), qkv.data_ptr(), attn.data_ptr(), out.data_ptr(), b,
        spq, d, seq_len, heads, head_dim, 1.0 / math.sqrt(head_dim),
        _stream(dev))
    build.check(rc, name)
    fused_qkvo_attention.launches += 1
    return out


fused_qkvo_attention.launches = 0


def _check_k9(name, tensors, seq_len, heads, head_dim, gate):
    """K9's launch checks: bf16 only (Queue 1 item 9's raise), then device,
    dtypes, contiguity and shapes; returns the device."""
    for key in ("x", "wqkv", "wo"):
        if tensors[key].is_cuda:
            check_k9_dtype(name, tensors[key].dtype)
    dev = _check_cuda(name, tensors, {"x": _BF, "wqkv": _BF, "bqkv": _F32,
                                      "wo": _BF, "bo": _F32, "do": _BF})
    x, wqkv = tensors["x"], tensors["wqkv"]
    b, spq, d = x.shape
    hhd = heads * head_dim
    if (spq % 8 or not 0 < seq_len <= spq
            or tuple(wqkv.shape) != (d, 3 * hhd) or not gate(x, wqkv, heads)):
        raise ValueError(
            f"{name}: unsupported shapes x {tuple(x.shape)} wqkv "
            f"{tuple(wqkv.shape)} seq_len {seq_len} heads {heads} head_dim "
            f"{head_dim}")
    _check_shape(name, "bqkv", tensors["bqkv"], (3 * hhd,))
    _check_shape(name, "wo", tensors["wo"], (hhd, d))
    if "bo" in tensors:
        _check_shape(name, "bo", tensors["bo"], (d,))
    if "do" in tensors:
        _check_shape(name, "do", tensors["do"], (b, spq, d))
    return dev


def fused_qkvo_attention_bwd_ref(x, wqkv, bqkv, wo, do, seq_len, heads,
                                 head_dim):
    """(dx, dWqkv, dbqkv, dWo, dbo) of K9 at the TPU kernel's rounding points
    (_qkvo_attn_bwd_kernel, pallas_kernels.py:2432-2530): qkv, p and the
    head outputs o (in x's dtype) recomputed as the forward's, dattn = dY Woᵀ
    in x's dtype, dWo = attnᵀ dY and dbo = Σ fp32(dY); the core's grads with
    dd = Σ fp32(dO)·fp32(o), o the cast head output (:2487-2491; K10's
    takes the fp32 one); dx = dqkv Wᵀ in x's dtype, dW = x̂ᵀ dqkv and db =
    Σ fp32(dqkv). The weight and bias grads in fp32. do [B, spq, D]."""
    dt = x.dtype
    b, spq, d = x.shape
    do2 = do.reshape(b * spq, -1)
    q, k, v, p, o = _qkvo_core(x, wqkv, bqkv, seq_len, heads, head_dim)
    attn = _heads_to_rows(o)
    dattn = matmul_f32(do2, wo.t()).to(dt)
    dwo = matmul_f32(attn.t(), do2)
    dbo = do2.float().sum(0)
    dqkv = _attn_core_grads(q, k, v, p, o, dattn, 1.0 / math.sqrt(head_dim))
    dx = matmul_f32(dqkv, wqkv.t()).to(dt).view(b, spq, d)
    return (dx, matmul_f32(x.reshape(-1, d).t(), dqkv), dqkv.float().sum(0),
            dwo, dbo)


def fused_qkvo_attention_bwd(x, wqkv, bqkv, wo, do, seq_len, heads,
                             head_dim):
    """K9 backward (csrc/qkvo_attention_bwd.cu: K1's Hopper backward without
    its LN recompute and tail, qkvo_sm90.cuh; K13's row statistics its only
    attention scratch, no P or ds): from the saved (x̂, Wqkv, bqkv, Wo) and
    dY [B, spq, D] bf16, dx [B, spq, D] bf16 and fp32 dWqkv [D, 3·H·Hd],
    dbqkv [3·H·Hd], dWo [H·Hd, D] and dbo [D]."""
    if not x.is_cuda:
        return fused_qkvo_attention_bwd_ref(x, wqkv, bqkv, wo, do, seq_len,
                                            heads, head_dim)
    name = "fused_qkvo_attention_bwd"
    dev = _check_k9(name, {"x": x, "wqkv": wqkv, "bqkv": bqkv, "wo": wo,
                           "do": do}, seq_len, heads, head_dim,
                    fused_qkvo_attention_bwd_supported)
    b, spq, d = x.shape
    n, hhd = b * spq, heads * head_dim
    w = 3 * hhd
    lib = build.load()
    dx, dw, db = torch.empty_like(x), _f32(dev, d, w), _f32(dev, w)
    dwo, dbo = _f32(dev, hhd, d), _f32(dev, d)
    qkv, attn, dattn = _bf(dev, n, w), _bf(dev, n, hhd), _bf(dev, n, hhd)
    stats = _workspace(lib.vitax_attention_core_bwd_ws(b, spq, heads), dev)
    dqkv = _bf(dev, n, w)
    ws = _workspace(lib.vitax_qkvo_attention_bwd_ws(n, d, hhd, w), dev)
    rc = lib.vitax_qkvo_attention_bwd(*(t.data_ptr() for t in (
        x, wqkv, bqkv, wo, do, dx, dw, db, dwo, dbo, qkv, attn, dattn, stats,
        dqkv, ws)), b, spq, d, seq_len, heads, head_dim,
        1.0 / math.sqrt(head_dim), _stream(dev))
    build.check(rc, name)
    fused_qkvo_attention_bwd.launches += 1
    return dx, dw, db, dwo, dbo


fused_qkvo_attention_bwd.launches = 0


class FusedQkvoAttentionFn(torch.autograd.Function):
    """K9 with its backward kernel, saving (x̂, Wqkv, bqkv, Wo) as vitax's
    custom VJP (pallas_kernels.py:2596-2628) and recomputing the rest: dW
    and dWo come back in their weights' dtype, db in bqkv's, and dbo as the
    kernel gives it, fp32 (vitax's `_fused_qkvo_bwd` returns it uncast)."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wo, bo, seq_len, heads, head_dim):
        ctx.save_for_backward(x, wqkv, bqkv, wo)
        ctx.meta = (seq_len, heads, head_dim)
        return fused_qkvo_attention(x, wqkv, bqkv, wo, bo, seq_len, heads,
                                    head_dim)

    @staticmethod
    def backward(ctx, do):
        x, wqkv, bqkv, wo = ctx.saved_tensors
        dx, dw, db, dwo, dbo = fused_qkvo_attention_bwd(
            x, wqkv, bqkv, wo, do.contiguous(), *ctx.meta)
        return (dx, dw.to(wqkv.dtype), db.to(bqkv.dtype), dwo.to(wo.dtype),
                dbo, None, None, None)


KERNELS = (layer_norm, fused_ln_qkvo_attention, fused_ln_mlp, layer_norm_bwd,
           fused_ln_qkvo_attention_bwd, fused_ln_mlp_bwd,
           fused_ln_qkvo_attention_int8, fused_ln_mlp_int8,
           fused_ln_qkvo_attention_int8_bwd, fused_ln_mlp_int8_bwd,
           fused_ln_qkvo_attention_int8_ho, fused_ln_mlp_int8_ho,
           fused_ln_qkvo_attention_int8_dw_bwd, fused_ln_mlp_int8_dw_bwd,
           fused_ln_qkvo_attention_gqa, fused_ln_qkvo_attention_rect,
           fused_ln_qkvo_attention_rect_int8, fused_ln_qkvo_attention_rect_bwd,
           fused_ln_qkvo_attention_rect_int8_bwd,
           fused_ln_qkvo_attention_rect_int8_dw_bwd,
           fused_ln_qkvo_attention_gqa_bwd, fused_ln_qkvo_attention_flash,
           fused_ln_qkvo_attention_flash_bwd, fused_ln_mlp_bwd_wide,
           flash_attention, flash_attention_bwd,
           fused_ln_qkvo_attention_int8_gqa,
           fused_ln_qkvo_attention_int8_gqa_bwd,
           fused_ln_qkvo_attention_int8_gqa_dw_bwd, fused_ln_mlp_save,
           fused_ln_mlp_bwd_fast, fused_ln_mlp_int8_save,
           fused_ln_mlp_int8_save_bwd, fused_ln_mlp_int8_save_dw_bwd,
           fused_ln_mlp_int4, fused_ln_mlp_int4_bwd, fused_ln_mlp_int4_dw_bwd,
           fused_ln_qkvo_attention_int4, fused_ln_qkvo_attention_int4_bwd,
           fused_ln_qkvo_attention_int4_dw_bwd,
           fused_ln_qkvo_attention_rect_int4,
           fused_ln_qkvo_attention_rect_int4_bwd,
           fused_ln_qkvo_attention_rect_int4_dw_bwd,
           fused_ln_qkvo_attention_int4_gqa,
           fused_ln_qkvo_attention_int4_gqa_bwd,
           fused_ln_qkvo_attention_int4_gqa_dw_bwd, fused_qkv_attention,
           fused_qkv_attention_bwd, fused_qkvo_attention,
           fused_qkvo_attention_bwd, fused_ln_mlp_partial,
           fused_ln_mlp_partial_bwd, fused_ln_mlp_int8_partial,
           fused_ln_mlp_int8_partial_bwd, fused_ln_mlp_int8_partial_dw_bwd,
           fused_ln_mlp_int4_partial, fused_ln_mlp_int4_partial_bwd,
           fused_ln_mlp_int4_partial_dw_bwd, fused_ln_mlp_save_partial,
           fused_ln_mlp_bwd_fast_partial, fused_ln_mlp_int8_save_partial,
           fused_ln_mlp_int8_save_partial_bwd,
           fused_ln_mlp_int8_save_partial_dw_bwd,
           fused_ln_mlp_bwd_wide_partial)
