"""Shared helpers for the ops layer.

Every hot op has two implementations behind one API, as in vitax:
  * a plain PyTorch version — right everywhere, the CPU path, and the golden
    value that each kernel is held against on the card;
  * a hand-written Hopper kernel (ops/cuda_kernels.py, csrc/).

`use_kernels(None, x)` resolves to "x is on CUDA", the counterpart of vitax's
`default_use_pallas` ("running on a TPU"). False forces the plain ops, as
`--no-pallas` does.
"""

from __future__ import annotations

from typing import Optional

import torch


def use_kernels(flag: Optional[bool], x: torch.Tensor) -> bool:
    return x.is_cuda if flag is None else flag


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with fp32 products and sums: the plain twin of JAX's
    `einsum(..., preferred_element_type=float32)` on bf16 operands (bf16
    values are exact in fp32). Needs TF32 off on the card, the default for
    matmuls."""
    return torch.matmul(a.float(), b.float())
