"""Hand-written Hopper kernels of the serving path, each beside its plain
PyTorch version (counterpart of vitax/ops/pallas_kernels.py).

| wrapper                   | CUDA source (csrc/)     | replaces (pallas_kernels.py) |
|---------------------------|-------------------------|------------------------------|
| `layer_norm`              | layernorm.cu            | `_ln_fwd_kernel` :267        |
| `fused_ln_qkvo_attention` | ln_qkvo_attention.cu    | `_ln_qkvo_fwd_kernel` :2640  |
| `fused_ln_mlp`            | ln_mlp.cu               | `_ln_mlp_fwd_kernel` :587    |

A wrapper given CPU tensors returns its `*_ref` (the CPU tests run those). A
wrapper given CUDA tensors launches its kernel or raises: there is no
fallback. Forward only: with grad mode on and an input that requires grad,
a CUDA call raises (the autograd Functions come with the backward kernels).

Each wrapper counts its launches in a plain int attribute, `wrapper.launches`,
incremented once per launch of its kernel and nowhere else, so a run can
show that its main path went through the kernels (`launch_counts`).

The `*_supported` gates are this port's own (Hopper shared memory, the GEMM
tile constraints, bf16 only on the card), mirroring the shape gates that send
vitax to its XLA path.
"""

from __future__ import annotations

import math

import torch

from vitax_torch.kernels import build
from vitax_torch.ops.common import matmul_f32
from vitax_torch.ops.layernorm import layer_norm_ref
from vitax_torch.ops.mlp import gelu_exact

SMEM_LIMIT = 232448  # bytes of shared memory a block may opt into (227 KB)
ATTN_HEAD_DIMS = (32, 64, 128)


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
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in tensors.values()):
        raise RuntimeError(
            f"{name}: the Hopper kernel is forward-only; its backward comes "
            "with the training port (ROADMAP Queue 2). Run under "
            "torch.no_grad() / torch.inference_mode().")
    return dev


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_shape(name: str, key: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


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
    if not x.is_cuda:
        return layer_norm_ref(x, scale, bias, eps)
    d = x.shape[-1]
    dev = _check_cuda("layer_norm", {"x": x, "scale": scale, "bias": bias},
                      {"x": x.dtype, "scale": torch.float32,
                       "bias": torch.float32})
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


# =============================================================================
# K2 — fused LN2 + fc1 + GELU + fc2 + residual (forward)
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


def fused_ln_mlp_ref(x, gamma, beta, w1, b1, w2, b2, eps):
    """x + bf16(fc2(bf16(GELU(fc1(bf16(LN(x))))))) with the TPU kernel's
    rounding points (pallas_kernels.py:603-615)."""
    xn = layer_norm_ref(x, gamma, beta, eps)
    a1 = matmul_f32(xn, w1) + b1.float()
    h1 = gelu_exact(a1).to(x.dtype)
    y = matmul_f32(h1, w2) + b2.float()
    return x + y.to(x.dtype)


def fused_ln_mlp(x, gamma, beta, w1, b1, w2, b2, eps):
    """out = x + fc2(GELU_exact(fc1(LN(x)))) for x [..., D]; x.dtype out.
    Weights bf16 [D,M], [M,D]; gamma/beta/b1/b2 fp32."""
    if not x.is_cuda:
        return fused_ln_mlp_ref(x, gamma, beta, w1, b1, w2, b2, eps)
    bf = torch.bfloat16
    f32 = torch.float32
    dev = _check_cuda(
        "fused_ln_mlp",
        {"x": x, "gamma": gamma, "beta": beta, "w1": w1, "b1": b1, "w2": w2,
         "b2": b2},
        {"x": bf, "gamma": f32, "beta": f32, "w1": bf, "b1": f32, "w2": bf,
         "b2": f32})
    d = x.shape[-1]
    m = w1.shape[1]
    x2 = x.view(-1, d)
    if not ln_mlp_supported(x2.unsqueeze(0), w1, w2):
        raise ValueError(f"fused_ln_mlp: unsupported shapes x {tuple(x.shape)}"
                         f" w1 {tuple(w1.shape)} w2 {tuple(w2.shape)}")
    for key, t, n in (("gamma", gamma, d), ("beta", beta, d), ("b1", b1, m),
                      ("b2", b2, d)):
        _check_shape("fused_ln_mlp", key, t, (n,))
    n = x2.shape[0]
    xn = torch.empty_like(x2)
    h1 = torch.empty((n, m), dtype=bf, device=dev)
    out = torch.empty_like(x2)
    rc = build.load().vitax_ln_mlp_fwd(
        x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), xn.data_ptr(),
        h1.data_ptr(), out.data_ptr(), n, d, m, eps, _stream(dev))
    build.check(rc, "fused_ln_mlp")
    fused_ln_mlp.launches += 1
    return out.view(x.shape)


fused_ln_mlp.launches = 0


# =============================================================================
# K1 — fused LN1 + QKV + attention core + out-projection (forward)
# =============================================================================

def attention_smem_bytes(spq: int, head_dim: int, warps: int = 1) -> int:
    """Shared memory of one attention-core block (ln_qkvo_attention.cu)."""
    rows = (spq + 15) // 16 * 16
    sw = max(rows, head_dim)
    return (2 * rows * head_dim * 2
            + warps * (16 * head_dim * 2 + 16 * sw * 4 + 16 * rows * 2))


def qkv_attention_supported(x, wqkv, heads) -> bool:
    """Gate of the fused attention half: x [B, S, D] (S padded to spq =
    round_up(S, 8) by the caller), merged wqkv [D, 3·H·Hd]."""
    if x.ndim != 3 or wqkv.ndim != 2:
        return False
    b, s, d = x.shape
    if wqkv.shape[0] != d or wqkv.shape[1] % (3 * heads):
        return False
    hhd = wqkv.shape[1] // 3
    hd = hhd // heads
    if x.is_cuda and x.dtype != torch.bfloat16:
        return False
    spq = (s + 7) // 8 * 8
    return (hd in ATTN_HEAD_DIMS and d % 32 == 0 and hhd % 32 == 0
            and attention_smem_bytes(spq, hd) <= SMEM_LIMIT)


def fused_ln_qkvo_attention_ref(x, gamma, beta, wqkv, bqkv, wo, bo, eps,
                                seq_len, heads, head_dim):
    """LN1 → qkv → per-head softmax(qkᵀ/√hd, cols ≥ seq_len masked)·v →
    out-projection, with the TPU kernel's rounding points
    (pallas_kernels.py:2646-2686). x [B, spq, D] → [B, spq, D], no residual."""
    dt = x.dtype
    b, spq, d = x.shape
    hhd = heads * head_dim
    scale = 1.0 / math.sqrt(head_dim)
    xn = layer_norm_ref(x, gamma, beta, eps)
    qkv = (matmul_f32(xn, wqkv) + bqkv.float()).to(dt)
    q, k, v = (qkv[..., i * hhd:(i + 1) * hhd]
               .reshape(b, spq, heads, head_dim).transpose(1, 2)
               for i in range(3))
    s = matmul_f32(q, k.transpose(-1, -2)) * scale
    if seq_len < spq:
        col = torch.arange(spq, device=x.device)
        s = torch.where(col < seq_len, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))
    o = matmul_f32(p.to(dt), v).to(dt)
    attn = o.transpose(1, 2).reshape(b, spq, hhd)
    return (matmul_f32(attn, wo) + bo.float()).to(dt)


def fused_ln_qkvo_attention(x, gamma, beta, wqkv, bqkv, wo, bo, eps, seq_len,
                            heads, head_dim):
    """LN + QKV projection + attention core + out-projection, forward.
    x [B, spq, D] bf16 (pad rows past seq_len allowed), wqkv [D, 3·H·Hd]
    columns [q heads | k heads | v heads], wo [H·Hd, D] bf16; gamma, beta,
    bqkv, bo fp32. Returns [B, spq, D] without the residual."""
    if not x.is_cuda:
        return fused_ln_qkvo_attention_ref(x, gamma, beta, wqkv, bqkv, wo, bo,
                                           eps, seq_len, heads, head_dim)
    bf = torch.bfloat16
    f32 = torch.float32
    dev = _check_cuda(
        "fused_ln_qkvo_attention",
        {"x": x, "gamma": gamma, "beta": beta, "wqkv": wqkv, "bqkv": bqkv,
         "wo": wo, "bo": bo},
        {"x": bf, "gamma": f32, "beta": f32, "wqkv": bf, "bqkv": f32,
         "wo": bf, "bo": f32})
    b, spq, d = x.shape
    hhd = heads * head_dim
    if (spq % 8 or not 0 < seq_len <= spq
            or not qkv_attention_supported(x, wqkv, heads)
            or hhd != wqkv.shape[1] // 3):
        raise ValueError(
            f"fused_ln_qkvo_attention: unsupported shapes x {tuple(x.shape)} "
            f"wqkv {tuple(wqkv.shape)} seq_len {seq_len} heads {heads} "
            f"head_dim {head_dim}")
    for key, t, shape in (("gamma", gamma, (d,)), ("beta", beta, (d,)),
                          ("bqkv", bqkv, (3 * hhd,)), ("wo", wo, (hhd, d)),
                          ("bo", bo, (d,))):
        _check_shape("fused_ln_qkvo_attention", key, t, shape)
    n = b * spq
    xn = torch.empty((n, d), dtype=bf, device=dev)
    qkv = torch.empty((n, 3 * hhd), dtype=bf, device=dev)
    attn = torch.empty((n, hhd), dtype=bf, device=dev)
    out = torch.empty_like(x)
    rc = build.load().vitax_ln_qkvo_attention_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wqkv.data_ptr(),
        bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(), xn.data_ptr(),
        qkv.data_ptr(), attn.data_ptr(), out.data_ptr(), b, spq, d, seq_len,
        heads, head_dim, eps, 1.0 / math.sqrt(head_dim), _stream(dev))
    build.check(rc, "fused_ln_qkvo_attention")
    fused_ln_qkvo_attention.launches += 1
    return out


fused_ln_qkvo_attention.launches = 0

KERNELS = (layer_norm, fused_ln_qkvo_attention, fused_ln_mlp)
