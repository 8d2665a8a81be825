"""LayerNorm with fp32 statistics (counterpart of vitax/ops/layernorm.py).

Statistics are computed in float32 whatever the compute dtype; the result is
cast back. On CUDA the row LN kernel (ops/cuda_kernels.py) serves it.
"""

from __future__ import annotations

from typing import Optional

import torch

from vitax_torch.ops.common import use_kernels as _use_kernels


def layer_norm_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) / torch.sqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6, use_kernels: Optional[bool] = None
               ) -> torch.Tensor:
    if _use_kernels(use_kernels, x):
        from vitax_torch.ops import cuda_kernels as ck
        if ck.layernorm_supported(x):
            return ck.layer_norm(x.contiguous(), scale.float().contiguous(),
                                 bias.float().contiguous(), eps)
    return layer_norm_ref(x, scale, bias, eps)
