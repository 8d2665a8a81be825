"""Routing-decision overlay PNGs — parity with `save_routing_visualization`
(res-vit/utils.py:586-676); a copy of vitax/utils/routing_viz.py (numpy and
PIL only).

For each block-head and block position, writes one PNG per epoch showing the
input image with kept (full-transformer) patches tinted gray and routed-away
(low-rank) patches tinted green.

Faithful-behavior note carried from the reference: de-normalization uses the
ImageNet mean/std (res-vit/utils.py:606-607) even though the loaders
normalize with 0.5/0.5 — the overlay colors are slightly off in exactly the
same way.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

_IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def denormalize(img_chw_or_hwc: np.ndarray) -> np.ndarray:
    """[-…,…] float image → uint8 HWC using ImageNet stats (reference quirk)."""
    img = np.asarray(img_chw_or_hwc, np.float32)
    if img.ndim == 3 and img.shape[0] == 3:
        img = np.transpose(img, (1, 2, 0))
    img = img * _IMAGENET_STD + _IMAGENET_MEAN
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def save_routing_visualization(images: np.ndarray,
                               routing_maps: Dict[int, np.ndarray],
                               epoch: int, out_dir: str,
                               patch_size: int = 16,
                               reserve_initials: int = 1,
                               alpha: float = 0.55,
                               max_images: int = 4) -> int:
    """images: [B,H,W,3] normalized floats (NHWC); routing_maps:
    {block_id: [B, N, block_size]} keep-bits incl. the cls token at position
    0. Writes `epoch{E}_block{B}_pos{P}_img{I}.png`; returns file count."""
    try:
        from PIL import Image
    except Exception:  # pragma: no cover
        return 0
    os.makedirs(out_dir, exist_ok=True)
    images = np.asarray(images)
    n_files = 0
    green = np.asarray([80, 200, 120], np.float32)
    gray = np.asarray([128, 128, 128], np.float32)
    for block_id, rmap in sorted(routing_maps.items()):
        rmap = np.asarray(rmap)
        b, n, bs = rmap.shape
        for img_idx in range(min(b, max_images)):
            base = denormalize(images[img_idx]).astype(np.float32)
            h, w, _ = base.shape
            gh, gw = h // patch_size, w // patch_size
            for pos in range(bs):
                # token 0 is cls; patch tokens start at 1
                keep = rmap[img_idx, 1:1 + gh * gw, pos].reshape(gh, gw)
                overlay = base.copy()
                for py in range(gh):
                    for px in range(gw):
                        tint = gray if keep[py, px] > 0.5 else green
                        ys = slice(py * patch_size, (py + 1) * patch_size)
                        xs = slice(px * patch_size, (px + 1) * patch_size)
                        overlay[ys, xs] = ((1 - alpha) * overlay[ys, xs]
                                           + alpha * tint)
                fname = (f"epoch{epoch}_block{block_id}_pos{pos}"
                         f"_img{img_idx}.png")
                Image.fromarray(overlay.astype(np.uint8)).save(
                    os.path.join(out_dir, fname))
                n_files += 1
    return n_files
