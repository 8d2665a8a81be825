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


def _first_exp_on_one_thread() -> None:
    """Runs torch's CPU `exp` (and `erf`, the other vector-math call of
    the GELU twins) once on this thread, at import.

    On CPU builds linked with MKL, `torch.exp` of fp32 tensors calls MKL's
    vector math library, split over the intra-op threads in chunks of at
    least 2048 elements. When the first such call of a process ran on eight
    threads at once, one worker's chunk came out with a relative error of
    1.5e-4 (the int8 GELU twins against vitax on 20000 values: the last
    2500, in about half of the runs after another test had started the
    thread pool; never with one thread, never after a first call on one
    thread). A first call here, on one thread and before any op of the port
    runs, keeps the later ones at the library's accuracy."""
    x = torch.zeros(8)
    torch.exp(x)
    torch.erf(x)


_first_exp_on_one_thread()


def use_kernels(flag: Optional[bool], x: torch.Tensor) -> bool:
    return x.is_cuda if flag is None else flag


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with fp32 products and sums: the plain twin of JAX's
    `einsum(..., preferred_element_type=float32)` on bf16 operands (bf16
    values are exact in fp32). Needs TF32 off on the card, the default for
    matmuls."""
    return torch.matmul(a.float(), b.float())
