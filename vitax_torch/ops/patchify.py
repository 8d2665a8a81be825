"""Patch embedding as a single matmul (counterpart of vitax/ops/patchify.py).

    [B, gh·P, gw·P, 3] → [B, gh, gw, P, P, 3] → [B, N, P·P·3] @ [P·P·3, D]

The kernel parameter stays in HWIO layout `[P, P, 3, D]`, the npz layout. The
product is a plain large matmul (XLA's in vitax), so torch.matmul serves it.
"""

from __future__ import annotations

import torch

from vitax_torch.ops.common import matmul_f32


def extract_patches(images: torch.Tensor, patch: tuple) -> torch.Tensor:
    """[B, H, W, C] → [B, N, ph*pw*C] with (ph, pw, c) flattened row-major.
    Non-divisible sizes crop the remainder, like a strided conv."""
    b, h, w, c = images.shape
    ph, pw = patch
    gh, gw = h // ph, w // pw
    images = images[:, :gh * ph, :gw * pw]
    x = images.reshape(b, gh, ph, gw, pw, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, ph * pw * c)


def patchify_matmul(images: torch.Tensor, kernel: torch.Tensor,
                    bias: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """images [B,H,W,3] (NHWC), kernel [ph,pw,3,D] (HWIO), bias [D]
    → patch tokens [B, N, D]; fp32 sums, bias added in fp32 before the cast."""
    ph, pw, c, d = kernel.shape
    patches = extract_patches(images, (ph, pw)).to(dtype)
    w = kernel.reshape(ph * pw * c, d).to(dtype)
    return (matmul_f32(patches, w) + bias.float()).to(dtype)
