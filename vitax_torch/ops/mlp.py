"""Transformer feed-forward block: Linear → GELU(exact) → Linear
(counterpart of vitax/ops/mlp.py). GELU is the exact erf flavour, in fp32."""

from __future__ import annotations

import torch

from vitax_torch.ops.common import matmul_f32


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    return (0.5 * x32 * (1.0 + torch.erf(x32 * 2.0 ** -0.5))).to(x.dtype)


def mlp_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
            w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    h = matmul_f32(x, w1.to(x.dtype)) + b1.float()
    h = gelu_exact(h).to(x.dtype)
    out = matmul_f32(h, w2.to(x.dtype)) + b2.float()
    return out.to(x.dtype)
