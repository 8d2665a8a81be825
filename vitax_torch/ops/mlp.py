"""Transformer feed-forward block: Linear → GELU(exact) → Linear
(counterpart of vitax/ops/mlp.py). GELU is the exact erf flavour, in fp32;
the int8 tiers' kernels use the sigmoid form `gelu_q` and its derivative."""

from __future__ import annotations

import math

import torch

from vitax_torch.ops.common import matmul_f32


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    return (0.5 * x32 * (1.0 + torch.erf(x32 * 2.0 ** -0.5))).to(x.dtype)


def gelu_exact_grad(a: torch.Tensor) -> torch.Tensor:
    """d/da GELU_exact in fp32: Phi(a) + a·phi(a) (vitax's _gelu_grad,
    pallas_kernels.py:577-584)."""
    a = a.float()
    phi = 0.5 * (1.0 + torch.erf(a * 2.0 ** -0.5))
    pdf = torch.exp(-0.5 * a * a) * (2.0 * math.pi) ** -0.5
    return phi + a * pdf


def _sigmoid_1702(a: torch.Tensor) -> torch.Tensor:
    """σ(1.702a) written as vitax writes it: rsqrt(1 + exp(-1.702a))²."""
    r = torch.rsqrt(1.0 + torch.exp(a * -1.702))
    return r * r


def gelu_q(a: torch.Tensor) -> torch.Tensor:
    """The int8 tiers' GELU in fp32: the sigmoid form a·σ(1.702a), vitax's
    default (pallas_kernels.py:547-561)."""
    a = a.float()
    return a * _sigmoid_1702(a)


def gelu_grad_q(a: torch.Tensor) -> torch.Tensor:
    """d/da gelu_q in fp32: σ·(1 + 1.702a·(1 − σ))
    (pallas_kernels.py:564-571)."""
    a = a.float()
    s = _sigmoid_1702(a)
    # 1 + (1.702a)(1 − s) as one fused multiply-add, as XLA contracts it
    return s * torch.addcmul(torch.ones_like(a), 1.702 * a, 1.0 - s)


# The int8 save-acts tier's static grid for GELU' (vitax's _GP_AMAX,
# pallas_kernels.py:723-729): |gelu_grad_q| <= 1.13, so its codes are
# clip(round(g'·127/1.13)) with no scale to keep, read back as q·1.13/127.
GP_AMAX = 1.13
GP_QSCALE = 127.0 / GP_AMAX
GP_DEQUANT = GP_AMAX / 127.0


def mlp_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
            w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    h = matmul_f32(x, w1.to(x.dtype)) + b1.float()
    h = gelu_exact(h).to(x.dtype)
    out = matmul_f32(h, w2.to(x.dtype)) + b2.float()
    return out.to(x.dtype)
