"""Standard Vision Transformer, inference path (counterpart of
vitax/models/vit.py).

Parameters are a plain dict in vitax's npz layout, with the encoder layers as
a list of per-layer dicts instead of `[L, ...]`-stacked leaves:

    {"embedding": {"kernel" [P,P,3,D] (HWIO), "bias" [D]},
     "cls_token" [1,1,D], "pos_embedding" [1,N+1,D],
     "layers": [{"ln1": {scale, bias},
                 "attn": {"query"|"key"|"value": {"kernel" [D,H,Hd],
                                                  "bias" [H,Hd]},
                          "out": {"kernel" [H,Hd,D], "bias" [D]}},
                 "ln2": {scale, bias},
                 "mlp": {"fc1": {"kernel" [D,M], "bias" [M]},
                         "fc2": {"kernel" [M,D], "bias" [D]}}}, ...],
     "encoder_norm": {scale, bias},
     "classifier": {"kernel" [D,C], "bias" [C]}}

`params_from_jax` turns vitax's pytree (as numpy arrays) into this layout, so
both packages compute the same function. `apply` is the deterministic
(eval) forward: with `fused_qkv` and `fused_mlp` each encoder block is two
fused kernels on a residual stream padded once to a multiple of 8 rows; with
them off, it is plain PyTorch ops. Training (dropout, token dropping,
gradients) comes with the training port.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from vitax_torch.core.config import ViTConfig
from vitax_torch.ops import cuda_kernels as ck
from vitax_torch.ops.attention import multi_head_attention_bhsd
from vitax_torch.ops.common import matmul_f32
from vitax_torch.ops.layernorm import layer_norm
from vitax_torch.ops.mlp import mlp_ref
from vitax_torch.ops.patchify import patchify_matmul

Params = Dict[str, Any]

# torch's nn.LayerNorm default eps, which the reference model uses
LN_EPS = 1e-5


def init_params(gen: torch.Generator, cfg: ViTConfig,
                device: torch.device | str = "cpu") -> Params:
    """Random parameters (truncated-normal lecun weights, zero biases, as
    vitax's init_params), drawn on the host from `gen`, then moved."""
    d, m = cfg.emb_dim, cfg.mlp_dim
    h, hd = cfg.num_heads, cfg.head_dim
    ph, pw = cfg.patch_size
    n = cfg.num_patches
    pdt = cfg.param_dtype

    def lecun(shape, fan_in):
        t = torch.empty(shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(t, std=1.0, a=-2.0, b=2.0, generator=gen)
        return (t * fan_in ** -0.5).to(device=device, dtype=pdt)

    def zeros(*shape):
        return torch.zeros(shape, dtype=pdt, device=device)

    def ln():
        return {"scale": torch.ones(d, dtype=pdt, device=device),
                "bias": zeros(d)}

    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "ln1": ln(),
            "attn": {
                "query": {"kernel": lecun((d, h, hd), d), "bias": zeros(h, hd)},
                "key": {"kernel": lecun((d, h, hd), d), "bias": zeros(h, hd)},
                "value": {"kernel": lecun((d, h, hd), d), "bias": zeros(h, hd)},
                "out": {"kernel": lecun((h, hd, d), d), "bias": zeros(d)},
            },
            "ln2": ln(),
            "mlp": {
                "fc1": {"kernel": lecun((d, m), d), "bias": zeros(m)},
                "fc2": {"kernel": lecun((m, d), m), "bias": zeros(d)},
            },
        })
    pos = torch.randn((1, n + 1, d), generator=gen) * 0.02
    return {
        "embedding": {"kernel": lecun((ph, pw, 3, d), ph * pw * 3),
                      "bias": zeros(d)},
        "cls_token": zeros(1, 1, d),
        "pos_embedding": pos.to(device=device, dtype=pdt),
        "layers": layers,
        "encoder_norm": ln(),
        "classifier": {"kernel": lecun((d, cfg.num_classes), d),
                       "bias": zeros(cfg.num_classes)},
    }


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: Params, device: torch.device | str = "cpu"
                    ) -> Params:
    """vitax's parameter pytree (numpy arrays, e.g.
    `jax.tree.map(np.asarray, params)` or `checkpointing.npz.load_npz_params`)
    → this package's parameters, unstacking the `[L, ...]` layer leaves."""
    def to_torch(a):
        return torch.from_numpy(np.array(a)).to(device)

    layers = tree["layers"]
    num_layers = np.asarray(layers["ln1"]["scale"]).shape[0]
    out = {k: _tree_map(to_torch, v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [_tree_map(lambda a, i=i: to_torch(np.asarray(a)[i]), layers)
                     for i in range(num_layers)]
    return out


def _attention(x: torch.Tensor, p: Params, cfg: ViTConfig) -> torch.Tensor:
    """SelfAttention with LinearGeneral-layout weights, plain ops: q/k/v in
    [B,H,S,Hd], fp32 sums and biases, cast to the compute dtype."""
    dt = x.dtype

    def proj(name):
        y = torch.einsum("bnd,dhk->bhnk", x.float(),
                         p[name]["kernel"].to(dt).float())
        return (y + p[name]["bias"].float()[None, :, None, :]).to(dt)

    out = multi_head_attention_bhsd(proj("query"), proj("key"), proj("value"),
                                    use_kernels=cfg.use_pallas)
    y = torch.einsum("bhnk,hkd->bnd", out.float(),
                     p["out"]["kernel"].to(dt).float())
    return (y + p["out"]["bias"].float()).to(dt)


def _merged_qkv(p: Params, dt: torch.dtype):
    """wqkv [D, 3·H·Hd] with columns [q heads | k heads | v heads] and the
    matching fp32 bias (vitax/models/vit.py:216-232)."""
    d = p["query"]["kernel"].shape[0]
    names = ("query", "key", "value")
    wqkv = torch.cat([p[k]["kernel"].to(dt).reshape(d, -1) for k in names],
                     dim=1)
    bqkv = torch.cat([p[k]["bias"].reshape(-1) for k in names]).float()
    return wqkv, bqkv


def _fused_block_attention(x: torch.Tensor, lp: Params, cfg: ViTConfig,
                           seq_len: Optional[int] = None
                           ) -> Optional[torch.Tensor]:
    """LN1 + QKV + attention + out-projection through the fused K1 kernel.
    Returns None when the gate rejects. `seq_len`: padded-stream mode — x
    already carries pad rows up to spq; return [B, spq, D]."""
    dt = x.dtype
    b, s, d = x.shape
    if seq_len is not None:
        s = seq_len
    h, hd = cfg.num_heads, cfg.head_dim
    p = lp["attn"]
    wqkv, bqkv = _merged_qkv(p, dt)
    if not ck.qkv_attention_supported(x, wqkv, h):
        return None
    wo = p["out"]["kernel"].to(dt).reshape(h * hd, d)
    spq = (s + 7) // 8 * 8
    xp = x if seq_len is not None else F.pad(x, (0, 0, 0, spq - s))
    out = ck.fused_ln_qkvo_attention(
        xp.contiguous(), lp["ln1"]["scale"].float(), lp["ln1"]["bias"].float(),
        wqkv, bqkv, wo, p["out"]["bias"].float(), LN_EPS, s, h, hd)
    if seq_len is None:
        out = out[:, :s]
    return out.to(dt)


def _fused_block_mlp(x: torch.Tensor, lp: Params, cfg: ViTConfig
                     ) -> Optional[torch.Tensor]:
    """LN2 + fc1 + GELU + fc2 + residual through the fused K2 kernel.
    Returns None when the gate rejects."""
    w1 = lp["mlp"]["fc1"]["kernel"].to(x.dtype)
    w2 = lp["mlp"]["fc2"]["kernel"].to(x.dtype)
    if not ck.ln_mlp_supported(x, w1, w2):
        return None
    return ck.fused_ln_mlp(
        x.contiguous(), lp["ln2"]["scale"].float(), lp["ln2"]["bias"].float(),
        w1, lp["mlp"]["fc1"]["bias"].float(), w2,
        lp["mlp"]["fc2"]["bias"].float(), LN_EPS)


def _block(x: torch.Tensor, lp: Params, cfg: ViTConfig,
           seq_len: Optional[int] = None) -> torch.Tensor:
    """Pre-LN encoder block, deterministic."""
    h = _fused_block_attention(x, lp, cfg, seq_len) if cfg.fused_qkv else None
    if h is None and seq_len is not None:
        # the plain attention has no sequence mask: pad K/V would leak
        raise RuntimeError("padded-stream block requires the fused "
                           "attention kernel; gate mismatch in apply()")
    if h is None:
        h = layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"], LN_EPS,
                       use_kernels=cfg.use_pallas)
        h = _attention(h, lp["attn"], cfg)
    x = x + h
    if cfg.fused_mlp:
        y = _fused_block_mlp(x, lp, cfg)
        if y is not None:
            return y
    if seq_len is not None:
        raise RuntimeError("padded-stream block requires the fused MLP "
                           "kernel; gate mismatch in apply()")
    h = layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"], LN_EPS,
                   use_kernels=cfg.use_pallas)
    mlp = lp["mlp"]
    return x + mlp_ref(h, mlp["fc1"]["kernel"], mlp["fc1"]["bias"],
                       mlp["fc2"]["kernel"], mlp["fc2"]["bias"])


def embed(params: Params, images: torch.Tensor, cfg: ViTConfig
          ) -> torch.Tensor:
    """Patchify + cls token + position embedding → [B, N+1, D] tokens."""
    if images.ndim != 4 or tuple(images.shape[1:]) != (*cfg.image_size, 3):
        raise ValueError(
            f"expected NHWC images [B, {cfg.image_size[0]}, {cfg.image_size[1]}, 3] "
            f"for this config, got {tuple(images.shape)}")
    tokens = patchify_matmul(images, params["embedding"]["kernel"],
                             params["embedding"]["bias"], dtype=cfg.dtype)
    b, _, d = tokens.shape
    cls = params["cls_token"].to(cfg.dtype).expand(b, 1, d)
    tokens = torch.cat([cls, tokens], dim=1)
    # fp32 add of the position embedding, then back to compute dtype
    return (tokens.float() + params["pos_embedding"].float()).to(cfg.dtype)


def _padded_stream_len(x: torch.Tensor, params: Params, cfg: ViTConfig
                       ) -> Optional[int]:
    """spq if the whole encoder can run on one [B, spq, D] stream padded once,
    else None. Requires both fused kernels (the plain attention has no
    sequence mask), so the gates mirror _fused_block_attention/_mlp."""
    b, s, d = x.shape
    spq = (s + 7) // 8 * 8
    if spq == s or not (cfg.fused_qkv and cfg.fused_mlp):
        return None
    h, hd = cfg.num_heads, cfg.head_dim
    wqkv = torch.empty((d, 3 * h * hd), device="meta")
    if not ck.qkv_attention_supported(x, wqkv, h):
        return None
    mlp = params["layers"][0]["mlp"]
    if not ck.ln_mlp_supported(x, mlp["fc1"]["kernel"], mlp["fc2"]["kernel"]):
        return None
    return spq


def apply(params: Params, images: torch.Tensor, cfg: ViTConfig
          ) -> torch.Tensor:
    """Eval forward: NHWC images [B,H,W,3] → fp32 logits [B, num_classes]."""
    if cfg.int8_mlp or cfg.int8_attn or cfg.int4_mlp or cfg.int4_attn:
        raise NotImplementedError(
            "the int8/int4 tiers have no Hopper kernels yet (ROADMAP Queue 2, "
            "K3/K4/K11)")
    x = embed(params, images, cfg)
    seq_len = None
    spq = _padded_stream_len(x, params, cfg)
    if spq is not None:
        seq_len = x.shape[1]
        x = F.pad(x, (0, 0, 0, spq - seq_len))
    for lp in params["layers"]:
        x = _block(x, lp, cfg, seq_len)
    # pad rows (if any) carry confined garbage; the head reads only cls
    x = layer_norm(x, params["encoder_norm"]["scale"],
                   params["encoder_norm"]["bias"], LN_EPS,
                   use_kernels=cfg.use_pallas)
    cls = x[:, 0].float()
    return matmul_f32(cls, params["classifier"]["kernel"]) \
        + params["classifier"]["bias"].float()


def apply_nchw(params: Params, images_nchw: torch.Tensor, cfg: ViTConfig
               ) -> torch.Tensor:
    """Convenience wrapper accepting the reference's NCHW layout."""
    return apply(params, images_nchw.permute(0, 2, 3, 1), cfg)
