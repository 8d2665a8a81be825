"""Multi-head self attention core (counterpart of vitax/ops/attention.py).

scores = q·kᵀ / sqrt(head_dim), softmax in float32, probabilities cast to the
value dtype before ·v. With kernels on (`use_kernels`, None: on the card) and
inside vitax's gate (`cuda_kernels.attention_supported`: S <= 1024, Hd <= 128,
Hd % 8 == 0) both layouts run K13, the standalone attention core
(`cuda_kernels.flash_attention{,_bhsd}`: its twin on CPU tensors, the kernel
on CUDA bf16 ones; CUDA fp32 raises); outside the gate `mha_ref`, as vitax
falls back to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from vitax_torch.ops import cuda_kernels as ck
from vitax_torch.ops.common import matmul_f32
from vitax_torch.ops.common import use_kernels as _use_kernels


def softmax_fp32(scores: torch.Tensor) -> torch.Tensor:
    s = scores.float()
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    return e / e.sum(dim=-1, keepdim=True)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
            ) -> torch.Tensor:
    """q,k,v: [B, S, H, Hd] → [B, S, H, Hd]. Softmax in fp32."""
    out = mha_ref_bhsd(*(t.transpose(1, 2) for t in (q, k, v)))
    return out.transpose(1, 2)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         use_kernels: Optional[bool] = None) -> torch.Tensor:
    """[B,S,H,Hd]³ → [B,S,H,Hd] (vitax's multi_head_attention)."""
    if _use_kernels(use_kernels, q) and ck.attention_supported(q, k, v):
        return ck.flash_attention(q, k, v)
    return mha_ref(q, k, v)


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
    """[B,H,S,Hd]³ → [B,H,S,Hd] (vitax's multi_head_attention_bhsd: its gate
    on q's shape alone)."""
    probe = q.transpose(1, 2)
    if _use_kernels(use_kernels, q) and ck.attention_supported(probe, probe,
                                                               probe):
        return ck.flash_attention_bhsd(q, k, v)
    return mha_ref_bhsd(q, k, v)
