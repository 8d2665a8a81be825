"""ViT `.npz` checkpoint interop.

The pretrained ViT checkpoints are flat npz dicts keyed
`Transformer/encoderblock_{i}/...` with JAX-native layouts: q/k/v kernels
`[D, H, Hd]`, out kernel `[H, Hd, D]`, conv kernel HWIO. The reference has to
transpose these into torch layouts (src/checkpoint.py:80-115); vitax keeps the
npz layout as its canonical parameter layout, so loading is pure key-mapping +
per-layer stacking — no transposition at all.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from vitax_torch.core.config import ViTConfig


def _stack(arrs):
    return np.stack(arrs, axis=0)


def flat_npz_to_params(flat: Dict[str, np.ndarray], num_layers: int,
                       num_classes: int = None) -> Dict[str, Any]:
    """Map a flat ViT npz dict to the vitax ViT param pytree.

    If `num_classes` differs from the checkpoint head, the head is dropped
    (caller re-inits it — mirrors src/train.py:117-121).
    """
    g = lambda k: np.asarray(flat[k])
    attn = "MultiHeadDotProductAttention_1"
    mlp = "MlpBlock_3"

    def layer_key(i, suffix):
        return f"Transformer/encoderblock_{i}/{suffix}"

    L = num_layers
    params: Dict[str, Any] = {
        "embedding": {"kernel": g("embedding/kernel"), "bias": g("embedding/bias")},
        "cls_token": g("cls"),
        "pos_embedding": g("Transformer/posembed_input/pos_embedding"),
        "layers": {
            "ln1": {
                "scale": _stack([g(layer_key(i, "LayerNorm_0/scale")) for i in range(L)]),
                "bias": _stack([g(layer_key(i, "LayerNorm_0/bias")) for i in range(L)]),
            },
            "attn": {
                name: {
                    "kernel": _stack([g(layer_key(i, f"{attn}/{name}/kernel")) for i in range(L)]),
                    "bias": _stack([g(layer_key(i, f"{attn}/{name}/bias")) for i in range(L)]),
                }
                for name in ("query", "key", "value", "out")
            },
            "ln2": {
                "scale": _stack([g(layer_key(i, "LayerNorm_2/scale")) for i in range(L)]),
                "bias": _stack([g(layer_key(i, "LayerNorm_2/bias")) for i in range(L)]),
            },
            "mlp": {
                "fc1": {
                    "kernel": _stack([g(layer_key(i, f"{mlp}/Dense_0/kernel")) for i in range(L)]),
                    "bias": _stack([g(layer_key(i, f"{mlp}/Dense_0/bias")) for i in range(L)]),
                },
                "fc2": {
                    "kernel": _stack([g(layer_key(i, f"{mlp}/Dense_1/kernel")) for i in range(L)]),
                    "bias": _stack([g(layer_key(i, f"{mlp}/Dense_1/bias")) for i in range(L)]),
                },
            },
        },
        "encoder_norm": {"scale": g("Transformer/encoder_norm/scale"),
                         "bias": g("Transformer/encoder_norm/bias")},
    }
    head_kernel = flat.get("head/kernel")
    if head_kernel is not None and (
            num_classes is None or head_kernel.shape[-1] == num_classes):
        params["classifier"] = {"kernel": np.asarray(head_kernel),
                                "bias": g("head/bias")}
    return params


def params_to_flat_npz(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Inverse of `flat_npz_to_params` (unstacks layers)."""
    flat: Dict[str, np.ndarray] = {
        "embedding/kernel": np.asarray(params["embedding"]["kernel"]),
        "embedding/bias": np.asarray(params["embedding"]["bias"]),
        "cls": np.asarray(params["cls_token"]),
        "Transformer/posembed_input/pos_embedding": np.asarray(params["pos_embedding"]),
        "Transformer/encoder_norm/scale": np.asarray(params["encoder_norm"]["scale"]),
        "Transformer/encoder_norm/bias": np.asarray(params["encoder_norm"]["bias"]),
    }
    if "classifier" in params:
        flat["head/kernel"] = np.asarray(params["classifier"]["kernel"])
        flat["head/bias"] = np.asarray(params["classifier"]["bias"])
    layers = params["layers"]
    L = np.asarray(layers["ln1"]["scale"]).shape[0]
    attn = "MultiHeadDotProductAttention_1"
    mlp = "MlpBlock_3"
    for i in range(L):
        pre = f"Transformer/encoderblock_{i}"
        flat[f"{pre}/LayerNorm_0/scale"] = np.asarray(layers["ln1"]["scale"][i])
        flat[f"{pre}/LayerNorm_0/bias"] = np.asarray(layers["ln1"]["bias"][i])
        flat[f"{pre}/LayerNorm_2/scale"] = np.asarray(layers["ln2"]["scale"][i])
        flat[f"{pre}/LayerNorm_2/bias"] = np.asarray(layers["ln2"]["bias"][i])
        for name in ("query", "key", "value", "out"):
            flat[f"{pre}/{attn}/{name}/kernel"] = np.asarray(layers["attn"][name]["kernel"][i])
            flat[f"{pre}/{attn}/{name}/bias"] = np.asarray(layers["attn"][name]["bias"][i])
        flat[f"{pre}/{mlp}/Dense_0/kernel"] = np.asarray(layers["mlp"]["fc1"]["kernel"][i])
        flat[f"{pre}/{mlp}/Dense_0/bias"] = np.asarray(layers["mlp"]["fc1"]["bias"][i])
        flat[f"{pre}/{mlp}/Dense_1/kernel"] = np.asarray(layers["mlp"]["fc2"]["kernel"][i])
        flat[f"{pre}/{mlp}/Dense_1/bias"] = np.asarray(layers["mlp"]["fc2"]["bias"][i])
    return flat


def load_npz_params(path: str, cfg: ViTConfig) -> Dict[str, Any]:
    with open(path, "rb") as f:
        flat = dict(np.load(f, allow_pickle=False))
    return flat_npz_to_params(flat, cfg.num_layers, cfg.num_classes)


def save_npz_params(path: str, params: Dict[str, Any]) -> None:
    np.savez(path, **params_to_flat_npz(params))
