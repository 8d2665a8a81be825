"""Symmetric int8 quantizers of the W8A8 tiers (counterpart of vitax's
_pack_i8, _quant_rows, _quant_cols, _quant_cols_host and _quant_rows_host,
vitax/ops/pallas_kernels.py:659-680, :888-914).

The grid is vitax's, so that the integer products are the same integers:

- activations, per row (inside the kernels): amax = max(max|x|, 1e-12),
  s = amax·(1/127), q = clip(round(x·(127/amax)), ±127), a multiply by the
  reciprocal, not a divide;
- weights, per output column or per row (once per call; vitax does it in
  XLA outside its kernels, the port's kernels in their first launches,
  csrc/quant.cuh, with the same divisions): s = max(amax, 1e-12)/127,
  q = clip(round(w/s), ±127), a divide.

These functions are the plain twins' quantizers.

`torch.round` rounds half to even, as `jnp.round`. Every division here is
tensor by tensor: torch turns `scalar / tensor` into a reciprocal times the
scalar, and on CUDA `tensor / scalar` into a multiply by the reciprocal,
either of which moves codes at the .5 ties.

`int_mm` is the plain twin of an s8×s8 product with exact int32
accumulation: float64 products of the codes (exact below 2^53, where fp32
is not: 127·127·3072 > 2^24), cast to fp32 as `astype(float32)` of the
int32 sum does.
"""

from __future__ import annotations

import torch

QMAX = 127.0


def pack_i8(r: torch.Tensor) -> torch.Tensor:
    """fp32 already scaled to ±127 → int8, round half to even."""
    return torch.clamp(torch.round(r), -QMAX, QMAX).to(torch.int8)


def _div(num: float, den: torch.Tensor) -> torch.Tensor:
    return torch.div(torch.full_like(den, num), den)


def quant_rows(x32: torch.Tensor, limit: float = QMAX):
    """Per-row int8 of fp32 rows: (codes, scale [..., 1]) with x ≈ q·s."""
    amax = torch.clamp_min(x32.abs().amax(dim=-1, keepdim=True), 1e-12)
    s = amax * (1.0 / limit)
    return pack_i8(x32 * _div(limit, amax)), s


def quant_cols(x32: torch.Tensor, limit: float = QMAX):
    """Per-column int8 over the row axis: (codes, scale [1, N])."""
    amax = torch.clamp_min(x32.abs().amax(dim=0, keepdim=True), 1e-12)
    s = amax * (1.0 / limit)
    return pack_i8(x32 * _div(limit, amax)), s


def _quant_host(w: torch.Tensor, dim: int):
    w32 = w.float()
    amax = torch.clamp_min(w32.abs().amax(dim=dim, keepdim=True), 1e-12)
    s = torch.div(amax, torch.full_like(amax, QMAX))
    q = pack_i8(torch.div(w32, s.expand_as(w32)))
    return q, s.squeeze(dim)


def quant_cols_host(w: torch.Tensor):
    """Per-output-column int8 of a [K, N] weight: (codes [K, N], scale [N])."""
    return _quant_host(w, 0)


def quant_rows_host(w: torch.Tensor):
    """Per-row int8 of a [K, N] weight contracted over N: (codes, scale
    [K])."""
    return _quant_host(w, 1)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of int8 codes, exact, as fp32."""
    return torch.matmul(a.double(), b.double()).float()
