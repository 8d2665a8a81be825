"""Token-compaction inference for Residual ViT in the reference's shape
(counterpart of vitax/models/resvit_compact.py), the eval CLI's
`--legacy-compact` path and its path where the fused attention kernels are
off.

A static capacity C keeps ceil(C·N) tokens per routed layer, ranked active
first (stable by index); attention runs with Q from the kept tokens and K/V
from all tokens, the FFN on the kept tokens only, and the results scatter
back into place. Inactive tokens keep x and take their path id's low-rank
approximators as in the dense path; actives beyond capacity stay identity
(DynamicViT's capacity semantics). Exact against the dense path while the
capacity covers every active token.

Its products are plain PyTorch ops (vitax leaves them to XLA); only its
LayerNorms take the LN kernel on the card.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from vitax_torch.core.config import ResViTConfig
from vitax_torch.models import resvit
from vitax_torch.models.resvit_utils import lra_path_ids
from vitax_torch.ops.attention import softmax_fp32
from vitax_torch.ops.common import matmul_f32
from vitax_torch.ops.layernorm import layer_norm


def _scatter_tokens(full: torch.Tensor, idx: torch.Tensor,
                    values: torch.Tensor) -> torch.Tensor:
    """full [B,N,D] with rows at idx [B,C] replaced by values [B,C,D]."""
    return full.scatter(1, idx[..., None].expand(-1, -1, full.shape[-1]),
                        values)


def _compact_attention(xq: torch.Tensor, x_all: torch.Tensor, p: Any,
                       cfg: ResViTConfig) -> torch.Tensor:
    """Asymmetric attention: Q from compacted tokens [B,C,D], KV from all
    tokens [B,N,D] (res-vit/model.py:237-299 with x_kv)."""
    b, c, _ = xq.shape
    n = x_all.shape[1]
    h, hkv, hd = cfg.n_heads, (cfg.n_kv_heads or cfg.n_heads), cfg.head_dim
    lin, lora = resvit._linear, resvit._lora
    q = lin(xq, p["wq"])
    k = lin(x_all, p["wk"])
    v = lin(x_all, p["wv"])
    if cfg.use_lora and "lora_q" in p:
        q = q + lora(xq, p["lora_q"])
        k = k + lora(x_all, p["lora_k"])
        v = v + lora(x_all, p["lora_v"])
    q = q.reshape(b, c, h, hd).transpose(1, 2)
    k = resvit._repeat_kv(k.reshape(b, n, hkv, hd), h // hkv).transpose(1, 2)
    v = resvit._repeat_kv(v.reshape(b, n, hkv, hd), h // hkv).transpose(1, 2)
    scores = matmul_f32(q, k.transpose(-1, -2)) / math.sqrt(hd)
    w = softmax_fp32(scores)
    out = matmul_f32(w.to(v.dtype), v).to(xq.dtype)
    return lin(out.transpose(1, 2).reshape(b, c, h * hd), p["wo"])


def apply_compact(params: Any, images: torch.Tensor, cfg: ResViTConfig, *,
                  capacity: float = 0.75
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Inference forward with token compaction. NHWC images → (logits, aux).

    `capacity` is the kept-token fraction per routed layer (C =
    ceil(capacity · N)). Reserved tokens always rank first."""
    if not cfg.use_reslr:
        raise ValueError("compaction requires use_reslr")
    roles = resvit.layer_roles(cfg)
    lra = lra_path_ids(cfg.block_size)

    x = resvit.embed(params, images, cfg)
    b, n, d = x.shape
    dev = x.device
    cap = min(n, max(1, math.ceil(capacity * n)))
    res = cfg.dynamic_reserve_initials
    ln = lambda t, lnp: layer_norm(t, lnp["scale"], lnp["bias"],  # noqa: E731
                                   cfg.norm_eps, use_kernels=cfg.use_pallas)

    acts = []
    routing_maps: Dict[int, torch.Tensor] = {}
    r_entropy = torch.zeros((), device=dev)
    r_entropy_rows = torch.zeros((b,), device=dev)
    block_ctx: Dict[str, Any] = {}

    for lid, role in enumerate(roles):
        lp = params["layers"][lid]
        if not role["routed"]:
            x = resvit.plain_block(x, lp, cfg)
            acts.append(torch.ones((b, n, 1), device=dev))
            continue

        if role["is_block_head"]:
            hard, path_ids, entropy, _soft, ent_rows = resvit.router_forward(
                x, lp["router"], cfg)
            block_ctx = {"hard": hard[..., 1], "path_ids": path_ids,
                         "approx": lp["approximators"]}
            r_entropy = r_entropy + entropy
            r_entropy_rows = r_entropy_rows + ent_rows
            routing_maps[role["block_id"]] = block_ctx["hard"]

        pos = role["block_pos"]
        lora_ids, trans_ids, _ = lra[pos]
        path_ids = block_ctx["path_ids"]
        active = resvit._isin(path_ids, trans_ids)
        if res > 0:  # reserved tokens always active and first
            active = active | (torch.arange(n, device=dev) < res)[None, :]

        # rank: active tokens first, stable by original index
        order = torch.argsort(resvit._compact_rank_key(active), dim=-1,
                              stable=True)
        keep_idx = order[:, :cap]

        # compacted pre-LN block on kept tokens, KV over all tokens
        xq = resvit._rows(x, keep_idx)
        x_norm = ln(x, lp["attention_norm"])
        xq_norm = resvit._rows(x_norm, keep_idx)
        h = xq + _compact_attention(xq_norm, x_norm, lp["attention"], cfg)
        out_c = h + resvit.feed_forward(ln(h, lp["ffn_norm"]),
                                        lp["feed_forward"])

        # scatter back; tokens that were gathered but not active keep x
        kept_active = torch.gather(active, 1, keep_idx)
        out_c = torch.where(kept_active[..., None], out_c, xq)
        x = _scatter_tokens(x, keep_idx, out_c)

        # low-rank approximators on their path ids (dense, cheap)
        x = resvit.apply_approximators(x, block_ctx["approx"], path_ids,
                                       lora_ids)
        acts.append(block_ctx["hard"][:, :, pos:pos + 1])

    x = ln(x, params["norm"])
    logits = resvit._linear(x[:, 0].float(), params["classifier"],
                            dtype=torch.float32)
    aux = {"r_entropy": r_entropy, "r_entropy_rows": r_entropy_rows,
           "acts": torch.cat(acts, dim=-1),
           "routing_maps": routing_maps, "capacity": cap / n}
    return logits, aux


def apply_compact_nchw(params, images_nchw, cfg, **kw):
    return apply_compact(params, images_nchw.permute(0, 2, 3, 1), cfg, **kw)
