"""Symmetric quantizers of the W8A8 and A4W4 tiers (counterpart of vitax's
_pack_i8, _quant_rows, _quant_cols, _quant_cols_host and _quant_rows_host,
vitax/ops/pallas_kernels.py:659-680, :888-914, and of their int4 forms
_pack_i4, _quant_rows4, _quant_cols_host4 and _quant_rows_host4, :917-957).

The grids are vitax's, so that the integer products are the same integers.
With limit L = 127 (int8) or 7 (int4):

- activations, per row (inside the kernels): amax = max(max|x|, 1e-12),
  s = amax·(1/L), q = clip(round(x·(L/amax)), ±L), a multiply by the
  reciprocal, not a divide;
- weights, per output column or per row (once per call; vitax does it in
  XLA outside its kernels, the port's kernels in their first launches,
  csrc/quant.cuh, with the same divisions): s = max(amax, 1e-12)/L,
  q = clip(round(w/s), ±L), a divide.

int4 codes live in int8 tensors, as in vitax's interpret mode (_i4_dtype
:917): a product of codes in [-7, 7] has the int4 product's int32 sums.

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
QMAX4 = 7.0


def pack_i8(r: torch.Tensor, limit: float = QMAX) -> torch.Tensor:
    """fp32 already scaled to ±limit → int8 codes, round half to even."""
    return torch.clamp(torch.round(r), -limit, limit).to(torch.int8)


def _div(num: float, den: torch.Tensor) -> torch.Tensor:
    return torch.div(torch.full_like(den, num), den)


def quant_rows(x32: torch.Tensor, limit: float = QMAX):
    """Per-row codes of fp32 rows on the grid of `limit`: (codes, scale
    [..., 1]) with x ≈ q·s."""
    amax = torch.clamp_min(x32.abs().amax(dim=-1, keepdim=True), 1e-12)
    s = amax * (1.0 / limit)
    return pack_i8(x32 * _div(limit, amax), limit), s


def quant_cols(x32: torch.Tensor, limit: float = QMAX):
    """Per-column codes over the row axis: (codes, scale [1, N])."""
    amax = torch.clamp_min(x32.abs().amax(dim=0, keepdim=True), 1e-12)
    s = amax * (1.0 / limit)
    return pack_i8(x32 * _div(limit, amax), limit), s


def quant_rows4(x32: torch.Tensor):
    """Per-row int4 of fp32 rows (vitax's _quant_rows4)."""
    return quant_rows(x32, QMAX4)


def _quant_host(w: torch.Tensor, dim: int, limit: float = QMAX):
    w32 = w.float()
    amax = torch.clamp_min(w32.abs().amax(dim=dim, keepdim=True), 1e-12)
    s = torch.div(amax, torch.full_like(amax, limit))
    q = pack_i8(torch.div(w32, s.expand_as(w32)), limit)
    return q, s.squeeze(dim)


def quant_cols_host(w: torch.Tensor):
    """Per-output-column int8 of a [K, N] weight: (codes [K, N], scale [N])."""
    return _quant_host(w, 0)


def quant_rows_host(w: torch.Tensor):
    """Per-row int8 of a [K, N] weight contracted over N: (codes, scale
    [K])."""
    return _quant_host(w, 1)


def quant_cols_host4(w: torch.Tensor):
    """Per-output-column int4 of a [K, N] weight (vitax's
    _quant_cols_host4)."""
    return _quant_host(w, 0, QMAX4)


def quant_rows_host4(w: torch.Tensor):
    """Per-row int4 of a [K, N] weight contracted over N (vitax's
    _quant_rows_host4)."""
    return _quant_host(w, 1, QMAX4)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of int8 codes, exact, as fp32."""
    return torch.matmul(a.double(), b.double()).float()
