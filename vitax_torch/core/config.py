"""Model/arch configuration dataclasses and preset registry.

Counterpart of `vitax/core/config.py` with torch dtypes: the same fields,
defaults, presets and dataset table, so a configuration means the same model
in both packages. Fields of tiers the port has not ported (int8/int4) are
kept so the two configurations stay field-for-field equal; `vit.apply`
rejects them. Res-ViT's configuration comes with the Res-ViT port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Standard Vision Transformer configuration (see vitax's ViTConfig)."""

    image_size: Tuple[int, int] = (224, 224)
    patch_size: Tuple[int, int] = (16, 16)
    emb_dim: int = 768
    mlp_dim: int = 3072
    num_heads: int = 12
    num_layers: int = 12
    num_classes: int = 1000
    attn_dropout_rate: float = 0.0
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: object = False
    # None = auto: the hand-written kernels run where the tensors are on CUDA
    use_pallas: Optional[bool] = None
    # fused LN1+QKV+attention+out-proj kernel (ops/cuda_kernels.py, K1)
    fused_qkv: bool = False
    # fused LN2+fc1+GELU+fc2+residual kernel (ops/cuda_kernels.py, K2)
    fused_mlp: bool = False
    fused_mlp_save: bool = False
    int8_mlp: bool = False
    int8_attn: bool = False
    int8_mlp_grad: bool = False
    int8_attn_grad: bool = False
    int8_dw: bool = False
    int4_mlp: bool = False
    int4_attn: bool = False
    int4_grad: bool = False
    token_keep: float = 1.0

    def __post_init__(self):
        if not (0.0 < self.token_keep <= 1.0):
            raise ValueError(
                f"token_keep must be in (0, 1], got {self.token_keep!r} — "
                "values <= 0 would train on cls + a single patch token and "
                "values > 1 would silently no-op")

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.image_size[0] // self.patch_size[0],
                self.image_size[1] // self.patch_size[1])

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid
        return gh * gw

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # +1 cls token

    @property
    def head_dim(self) -> int:
        return self.emb_dim // self.num_heads

    def replace(self, **kw) -> "ViTConfig":
        return dataclasses.replace(self, **kw)


# Arch presets — identical numerology to vitax (and its reference,
# src/config.py:57-104). All presets use dropout 0.
ARCH_PRESETS = {
    "tiny": dict(patch=16, emb_dim=96, mlp_dim=192, num_heads=3, num_layers=3),
    "b16": dict(patch=16, emb_dim=768, mlp_dim=3072, num_heads=12, num_layers=12),
    "b32": dict(patch=32, emb_dim=768, mlp_dim=3072, num_heads=12, num_layers=12),
    "l16": dict(patch=16, emb_dim=1024, mlp_dim=4096, num_heads=16, num_layers=24),
    "l32": dict(patch=32, emb_dim=1024, mlp_dim=4096, num_heads=16, num_layers=24),
    "h14": dict(patch=14, emb_dim=1280, mlp_dim=5120, num_heads=16, num_layers=32),
}

DATASET_NUM_CLASSES = {
    "CIFAR10": 10,
    "CIFAR100": 100,
    "ImageNet": 1000,
    "TinyImageNet": 200,
    "Synthetic": 10,
}


def num_classes_for_dataset(dataset: str, default: int = 1000) -> int:
    return DATASET_NUM_CLASSES.get(dataset, default)


def arch_config(arch: str, image_size: int = 224, num_classes: int = 1000,
                **overrides) -> ViTConfig:
    """Build a ViTConfig from a preset name ('b16'..'h14')."""
    if arch not in ARCH_PRESETS:
        raise ValueError(f"unknown arch {arch!r}; choose from {sorted(ARCH_PRESETS)}")
    p = ARCH_PRESETS[arch]
    return ViTConfig(
        image_size=(image_size, image_size),
        patch_size=(p["patch"], p["patch"]),
        emb_dim=p["emb_dim"],
        mlp_dim=p["mlp_dim"],
        num_heads=p["num_heads"],
        num_layers=p["num_layers"],
        num_classes=num_classes,
        attn_dropout_rate=0.0,
        dropout_rate=0.0,
        **overrides,
    )
