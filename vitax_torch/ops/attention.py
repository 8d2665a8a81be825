"""Multi-head self attention core (counterpart of vitax/ops/attention.py).

scores = q·kᵀ / sqrt(head_dim), softmax in float32, probabilities cast to the
value dtype before ·v. The standalone attention kernel vitax reaches here
(`flash_attention_bhsd`) has no Hopper port yet: the serving path runs the
attention core inside the fused K1 kernel instead.
"""

from __future__ import annotations

from typing import Optional

import torch

from vitax_torch.ops.common import matmul_f32
from vitax_torch.ops.common import use_kernels as _use_kernels


def softmax_fp32(scores: torch.Tensor) -> torch.Tensor:
    s = scores.float()
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    return e / e.sum(dim=-1, keepdim=True)


def mha_ref_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                 ) -> torch.Tensor:
    """q,k,v: [B, H, S, Hd] → [B, H, S, Hd]. Softmax in fp32."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = matmul_f32(q, k.transpose(-1, -2)) * scale
    weights = softmax_fp32(scores)
    out = matmul_f32(weights.to(v.dtype), v)
    return out.to(q.dtype)


def multi_head_attention_bhsd(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              use_kernels: Optional[bool] = None
                              ) -> torch.Tensor:
    if _use_kernels(use_kernels, q) and q.is_cuda:
        raise NotImplementedError(
            "flash_attention_bhsd has no Hopper kernel yet (ROADMAP Queue 2, "
            "K13); run with the fused attention kernel (fused_qkv) or with "
            "use_pallas=False / --no-pallas")
    return mha_ref_bhsd(q, k, v)
