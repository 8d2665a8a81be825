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
both packages compute the same function. `apply` is the forward, eval or
train: with `fused_qkv` and `fused_mlp` each encoder block is two fused
kernels (the attention half K1, or K6, its KV-chunked core, where K1's
whole-row core does not fit, as for ViT-H/14; the MLP half K2) on a
residual stream padded once to a multiple of 8 rows (under
autograd, their backward kernels run through `torch.autograd.Function`s;
under a mesh with a model axis > 1, each half per model shard in its tier,
parallel/tp_kernels.py, or where vitax hands the sharded weights to XLA,
the plain half on the gathered weights),
in bf16 or, with `int8_attn`/`int8_mlp` (and their `_grad` flags and
`int8_dw`), in the W8A8 tiers, which on short or very long streams hand
each block's packed int8 input over from the previous one (K5, vitax's auto
gate); with them off, it is plain PyTorch ops. Train mode adds token
dropping and dropout, with their random numbers drawn from an explicit
`torch.Generator`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from vitax_torch.core.config import ViTConfig
from vitax_torch.ops import cuda_kernels as ck, gates
from vitax_torch.ops.attention import multi_head_attention_bhsd
from vitax_torch.ops.common import matmul_f32
from vitax_torch.ops.layernorm import layer_norm
from vitax_torch.ops.mlp import gelu_exact
from vitax_torch.ops.patchify import patchify_matmul
from vitax_torch.parallel.mesh import Mesh, draw_rows, tp_size

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


def reinit_classifier(params: Params, gen: torch.Generator, num_classes: int
                      ) -> Params:
    """Re-initialize the classification head for a new class count (vitax's
    reinit_classifier, the reference's head re-init on class mismatch)."""
    kernel = params["classifier"]["kernel"]
    d = kernel.shape[0]
    t = torch.empty((d, num_classes), dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, std=1.0, a=-2.0, b=2.0, generator=gen)
    new = dict(params)
    new["classifier"] = {
        "kernel": (t * d ** -0.5).to(device=kernel.device, dtype=kernel.dtype),
        "bias": torch.zeros(num_classes, dtype=kernel.dtype,
                            device=kernel.device)}
    return new


def _uniform(gen: torch.Generator, shape, mesh: Optional[Mesh] = None
             ) -> torch.Tensor:
    """U[0, 1) of `shape` from `gen` on its own device; under a mesh this
    rank's rows of the global batch's draw (`draw_rows`)."""
    return draw_rows(mesh, shape, lambda sh: torch.rand(
        sh, generator=gen, device=gen.device))


def _dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator],
             deterministic: bool, mesh: Optional[Mesh] = None
             ) -> torch.Tensor:
    """Inverted dropout, plain ops (every preset has rate 0). The mask is
    drawn from `gen` on its own device (the global batch's under a mesh)."""
    if deterministic or rate <= 0.0 or gen is None:
        return x
    keep = 1.0 - rate
    mask = _uniform(gen, x.shape, mesh) < keep
    mask = mask.to(x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


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
    """SelfAttention with LinearGeneral-layout weights: plain projections
    (q/k/v in [B,H,S,Hd], fp32 sums and biases, cast to the compute dtype)
    around the attention core, K13 with the kernels on (their [B,S,H,Hd]
    memory goes to the kernel as it is)."""
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


def _attention_kernel(x: torch.Tensor, wqkv: torch.Tensor, heads: int
                      ) -> Optional[str]:
    """Which fused attention half takes x: "k1" (the whole-row core) where
    vitax's gate and the port's pass, else "k6" (the KV-chunked core) where
    vitax's flash gate and the port's pass, as vitax's
    _fused_block_attention chooses (vitax/models/vit.py:220-227; vitax's
    gates copied in ops/gates.py); None where neither does. Under autograd
    the port's gates are the backward kernels' (the MLP half's backward has
    its forward's constraints)."""
    train = torch.is_grad_enabled()
    if gates.qkv_attention_supported(x, wqkv) and (
            ck.qkv_attention_bwd_supported if train
            else ck.qkv_attention_supported)(x, wqkv, heads):
        return "k1"
    if gates.qkv_attention_flash_supported(x, wqkv) and (
            ck.qkv_attention_flash_bwd_supported if train
            else ck.qkv_attention_flash_supported)(x, wqkv, heads):
        return "k6"
    return None


def _low_precision(cfg: ViTConfig) -> bool:
    return (cfg.int8_attn or cfg.int8_mlp or cfg.int8_attn_grad
            or cfg.int8_mlp_grad or cfg.int8_dw or cfg.int4_mlp
            or cfg.int4_attn or cfg.int4_grad)


_WIDE_TIERS = ("the int8/int4 tiers are not ported at d > 1024 or on the "
               "KV-chunked attention half (K6), where vitax demotes them to "
               "bf16 without a word; ROADMAP Queue 1 item 8, \"int8/int4 "
               "tiers at d > 1024\". Run this model in bf16")


def check_tiers(cfg: ViTConfig) -> None:
    """Raise for a low-precision tier at a width the port does not run it
    (d > 1024, vitax's _MLP_MONO_MAX_D): the CLIs call it before they build
    the model, `apply` before it runs."""
    if _low_precision(cfg) and cfg.emb_dim > ck.MLP_MONO_MAX_D:
        raise NotImplementedError(f"d {cfg.emb_dim}: {_WIDE_TIERS}")


def check_tp(cfg: ViTConfig, tp: int) -> None:
    """Raise for heads or an MLP width that a model axis of `tp` does not
    split: `shard_params` cannot cut them, as vitax's placement of an
    uneven sharding cannot. (The tiers at d > 1024 raise in `check_tiers`.)
    The CLIs call it before they build the mesh, `apply` before it runs."""
    what = (f"{cfg.num_heads} heads" if cfg.num_heads % tp
            else f"MLP width {cfg.mlp_dim}" if cfg.mlp_dim % tp else None)
    if tp > 1 and what is not None:
        raise ValueError(f"--n-model {tp} does not split {what} evenly "
                         "over the model axis; vitax's sharding of the "
                         "parameters refuses it too")


def tp_attention_supported(x: torch.Tensor, cfg: ViTConfig, tp: int
                           ) -> bool:
    """Whether the attention half runs per model shard: K1's gate at the
    shard width 3·(H/tp)·Hd, vitax's (vitax/models/vit.py:190-194) and the
    port's (its backward's under autograd)."""
    d, h, hd = x.shape[-1], cfg.num_heads, cfg.head_dim
    wqkv = torch.empty((d, 3 * (h // tp) * hd), device="meta", dtype=x.dtype)
    gate = (ck.qkv_attention_bwd_supported if torch.is_grad_enabled()
            else ck.qkv_attention_supported)
    return (h % tp == 0 and gates.qkv_attention_supported(x, wqkv)
            and gate(x, wqkv, h // tp))


def tp_mlp_supported(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
                     ) -> bool:
    """Whether the MLP half runs per model shard on this rank's shards w1
    [D, M/tp], w2 [M/tp, D]: vitax's gate (vitax/models/vit.py:276-279)
    and the port's."""
    return (gates.ln_mlp_supported(x, w1, w2)
            and ck.ln_mlp_supported(x, w1, w2))


def _tp_attention(x: torch.Tensor, lp: Params, cfg: ViTConfig, mesh: Mesh
                  ) -> Optional[torch.Tensor]:
    """The attention half per model shard (vitax/models/vit.py:190-214): K1,
    K3 or K11-C with the tier on this rank's heads, on x padded to spq;
    None where vitax's gate or the port's declines (ViT-H/14), and the block
    runs vitax's plain attention on the gathered weights. The gate grows
    with the width, so the whole weights' K9 gate of vitax's `_attention`
    declines there too; vitax's plain attention drops the int8/int4 tier,
    which the port does not do silently (Queue 1 item 8)."""
    from vitax_torch.parallel.tp_kernels import fused_ln_qkvo_attention_tp
    dt = x.dtype
    b, s, d = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    if not tp_attention_supported(x, cfg, tp_size(mesh)):
        if cfg.int8_attn or cfg.int4_attn:
            raise NotImplementedError(
                f"x {tuple(x.shape)}, {h // tp_size(mesh)} heads a shard: "
                f"the attention half is vitax's plain one; {_WIDE_TIERS}")
        return None
    p = lp["attn"]
    spq = (s + 7) // 8 * 8
    out = fused_ln_qkvo_attention_tp(
        F.pad(x, (0, 0, 0, spq - s)).contiguous(),
        lp["ln1"]["scale"].float(), lp["ln1"]["bias"].float(),
        *(p[k]["kernel"].to(dt) for k in ("query", "key", "value")),
        *(p[k]["bias"].float() for k in ("query", "key", "value")),
        p["out"]["kernel"].to(dt), p["out"]["bias"].float(), mesh, LN_EPS, s,
        h, hd, cfg.int8_attn, cfg.int8_attn_grad, cfg.int8_dw, cfg.int4_attn,
        cfg.int4_grad and cfg.int4_attn)
    return out[:, :s].to(dt)


def _tp_mlp(x: torch.Tensor, lp: Params, cfg: ViTConfig, mesh: Mesh
            ) -> Optional[torch.Tensor]:
    """The MLP half per model shard (vitax/models/vit.py:272-287): K2, K4
    or K11-A without the residual, with the tier's backward, on this rank's
    M/tp columns of fc1 and rows of fc2; None where vitax's gate or the
    port's declines at the shard width (the plain MLP runs)."""
    from vitax_torch.parallel.tp_kernels import fused_ln_mlp_tp
    mlp = lp["mlp"]
    w1, w2 = (mlp[k]["kernel"].to(x.dtype) for k in ("fc1", "fc2"))
    if not tp_mlp_supported(x, w1, w2):
        return None
    return fused_ln_mlp_tp(x.contiguous(), lp["ln2"]["scale"].float(),
                           lp["ln2"]["bias"].float(), w1,
                           mlp["fc1"]["bias"].float(), w2,
                           mlp["fc2"]["bias"].float(), mesh, LN_EPS,
                           int8=cfg.int8_mlp, int8_grad=cfg.int8_mlp_grad,
                           int8_dw=cfg.int8_dw, int4=cfg.int4_mlp,
                           int4_grad=cfg.int4_grad)


def _gathered(p: Params, half: str, mesh: Mesh) -> Params:
    """A half's parameters (lp["attn"] or lp["mlp"]) whole, each sharded
    leaf gathered over the model axis (`gather_from_model`): the weights
    vitax's XLA gathers around its plain halves."""
    from vitax_torch.parallel.mesh import MODEL_AXIS, vit_param_spec
    from vitax_torch.parallel.tp_kernels import gather_from_model

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in t.items()}
        spec = vit_param_spec(path)
        return (gather_from_model(t, spec.index(MODEL_AXIS), mesh)
                if MODEL_AXIS in spec else t)
    return walk(p, "/" + half)


def _fused_block_attention(x: torch.Tensor, lp: Params, cfg: ViTConfig,
                           seq_len: Optional[int] = None
                           ) -> Optional[torch.Tensor]:
    """LN1 + QKV + attention + out-projection through a fused kernel: K1,
    else K6 (`_attention_kernel`). Returns None when both gates reject.
    `seq_len`: padded-stream mode — x already carries pad rows up to spq;
    return [B, spq, D]."""
    dt = x.dtype
    b, s, d = x.shape
    if seq_len is not None:
        s = seq_len
    h, hd = cfg.num_heads, cfg.head_dim
    p = lp["attn"]
    wqkv, bqkv = _merged_qkv(p, dt)
    kernel = _attention_kernel(x, wqkv, h)
    if kernel is None:
        return None
    wo = p["out"]["kernel"].to(dt).reshape(h * hd, d)
    spq = (s + 7) // 8 * 8
    xp = x if seq_len is not None else F.pad(x, (0, 0, 0, spq - s))
    args = (xp.contiguous(), lp["ln1"]["scale"].float(),
            lp["ln1"]["bias"].float(), wqkv, bqkv, wo,
            p["out"]["bias"].float(), LN_EPS, s, h, hd)
    if kernel == "k6":  # bf16 only: apply() raises for the other tiers
        out = ck.fused_ln_qkvo_attention_flash(*args)
    elif cfg.int4_attn:  # A4W4 projections (vitax/models/vit.py:247-252);
        # its backward as vitax's: K11-D only with int8 and int8_grad
        out = ck.fused_ln_qkvo_attention_int4(
            *args, int8_grad=cfg.int8_attn and cfg.int8_attn_grad,
            int8_dw=cfg.int8_dw, int4_grad=cfg.int4_grad)
    elif cfg.int8_attn:  # W8A8 projections (vitax/models/vit.py:247-252)
        out = ck.fused_ln_qkvo_attention_int8(*args,
                                              int8_grad=cfg.int8_attn_grad,
                                              int8_dw=cfg.int8_dw)
    else:
        out = ck.fused_ln_qkvo_attention(*args)
    if seq_len is None:
        out = out[:, :s]
    return out.to(dt)


def _fused_block_mlp(x: torch.Tensor, lp: Params, cfg: ViTConfig
                     ) -> Optional[torch.Tensor]:
    """LN2 + fc1 + GELU + fc2 + residual through the fused K2 kernel (K4
    with int8_mlp; K11-A with int4_mlp, ahead of both; K12 under autograd
    with fused_mlp_save, vitax's dispatch, pallas_kernels.py:2152-2166).
    Returns None when the gate rejects."""
    w1 = lp["mlp"]["fc1"]["kernel"].to(x.dtype)
    w2 = lp["mlp"]["fc2"]["kernel"].to(x.dtype)
    if not ck.ln_mlp_supported(x, w1, w2):
        return None
    args = (x.contiguous(), lp["ln2"]["scale"].float(),
            lp["ln2"]["bias"].float(), w1, lp["mlp"]["fc1"]["bias"].float(),
            w2, lp["mlp"]["fc2"]["bias"].float(), LN_EPS)
    if cfg.int4_mlp:  # A4W4 fc1/fc2 (vitax/models/vit.py:289-298)
        return ck.fused_ln_mlp_int4(*args, int8_grad=cfg.int8_mlp_grad,
                                    int8_dw=cfg.int8_dw,
                                    int4_grad=cfg.int4_grad)
    if cfg.int8_mlp:  # W8A8 fc1/fc2 (vitax/models/vit.py:289-298)
        return ck.fused_ln_mlp_int8(*args, int8_grad=cfg.int8_mlp_grad,
                                    int8_dw=cfg.int8_dw,
                                    save_acts=cfg.fused_mlp_save)
    return ck.fused_ln_mlp(*args, save_acts=cfg.fused_mlp_save)


def _block(x: torch.Tensor, lp: Params, cfg: ViTConfig,
           gen: Optional[torch.Generator] = None, deterministic: bool = True,
           seq_len: Optional[int] = None, mesh: Optional[Mesh] = None
           ) -> torch.Tensor:
    """Pre-LN encoder block (vitax's _block); under a model axis > 1 each
    fused half per model shard, and where vitax hands the sharded weights
    to XLA (a gate declines, a fused half off, the MLP half under active
    dropout) the plain half on the gathered weights."""
    tp = tp_size(mesh) > 1
    if not cfg.fused_qkv:
        h = None
    elif tp:
        h = _tp_attention(x, lp, cfg, mesh)
    else:
        h = _fused_block_attention(x, lp, cfg, seq_len)
    if h is None and seq_len is not None:
        # the plain attention has no sequence mask: pad K/V would leak
        raise RuntimeError("padded-stream block requires the fused "
                           "attention kernel; gate mismatch in apply()")
    if h is None:
        h = layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"], LN_EPS,
                       use_kernels=cfg.use_pallas)
        h = _attention(h, _gathered(lp["attn"], "attn", mesh) if tp
                       else lp["attn"], cfg)
    x = x + _dropout(h, cfg.dropout_rate, gen, deterministic, mesh)
    if cfg.fused_mlp and (deterministic or cfg.dropout_rate <= 0.0):
        y = _tp_mlp(x, lp, cfg, mesh) if tp else _fused_block_mlp(x, lp, cfg)
        if y is not None:
            return y
    if seq_len is not None:
        raise RuntimeError("padded-stream block requires the fused MLP "
                           "kernel; gate mismatch in apply()")
    h = layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"], LN_EPS,
                   use_kernels=cfg.use_pallas)
    # MlpBlock with its two dropouts, fp32 sums and GELU (ops/mlp.py:mlp_ref)
    dt = x.dtype
    mlp = _gathered(lp["mlp"], "mlp", mesh) if tp else lp["mlp"]
    h1 = matmul_f32(h, mlp["fc1"]["kernel"].to(dt)) + mlp["fc1"]["bias"].float()
    h1 = _dropout(gelu_exact(h1).to(dt), cfg.dropout_rate, gen, deterministic,
                  mesh)
    h2 = matmul_f32(h1, mlp["fc2"]["kernel"].to(dt)) + mlp["fc2"]["bias"].float()
    return x + _dropout(h2.to(dt), cfg.dropout_rate, gen, deterministic,
                        mesh)


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


def drop_tokens(x: torch.Tensor, gen: Optional[torch.Generator],
                keep_ratio: float, n_pinned: int = 1,
                idx: Optional[torch.Tensor] = None,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """PatchDropout/FLIP token dropping (train only; vitax's drop_tokens).

    Keeps the first `n_pinned` tokens (cls) plus a uniform-random
    round(keep_ratio·n) subset of the other n tokens per image, in their
    original order: [B, n_pinned + k, D]. The subset is drawn from `gen`, or
    given as `idx` [B, n_pinned + k] (the gathered positions, pins included),
    so a test can hand both packages the same kept tokens. Under a mesh the
    draw is the global batch's, of which x holds this rank's rows."""
    b, s, d = x.shape
    n_pinned = max(1, min(n_pinned, s))
    n = s - n_pinned
    if n <= 0:
        return x
    k = max(1, min(n, int(round(keep_ratio * n))))
    if k >= n:
        return x
    if idx is None:
        noise = _uniform(gen, (b, n), mesh)
        keep = torch.sort(torch.argsort(noise, dim=1)[:, :k], dim=1).values
        pins = torch.arange(n_pinned, device=keep.device).expand(b, n_pinned)
        idx = torch.cat([pins, keep + n_pinned], dim=1)
    idx = idx.to(device=x.device, dtype=torch.long)
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, d))


def _padded_stream_len(x: torch.Tensor, params: Params, cfg: ViTConfig,
                       deterministic: bool = True,
                       mesh: Optional[Mesh] = None) -> Optional[int]:
    """spq if the whole encoder can run on one [B, spq, D] stream padded once,
    else None. Requires both fused kernels (the plain attention has no
    sequence mask) and no active dropout, so the gates mirror
    _fused_block_attention/_mlp (either attention half, K1 or K6, as
    vitax/models/vit.py:431-433; under autograd, with the backward gates).
    None under a model axis > 1, whose per-shard halves pad their own input
    (vitax/models/vit.py:424-426)."""
    b, s, d = x.shape
    spq = (s + 7) // 8 * 8
    if spq == s or not (cfg.fused_qkv and cfg.fused_mlp) or tp_size(mesh) > 1:
        return None
    if not (deterministic or cfg.dropout_rate <= 0.0):
        return None
    h, hd = cfg.num_heads, cfg.head_dim
    wqkv = torch.empty((d, 3 * h * hd), device="meta")
    if _attention_kernel(x, wqkv, h) is None:
        return None
    mlp = params["layers"][0]["mlp"]
    if not ck.ln_mlp_supported(x, mlp["fc1"]["kernel"], mlp["fc2"]["kernel"]):
        return None
    return spq


def _int8_handoff(x: torch.Tensor, cfg: ViTConfig,
                  deterministic: bool) -> bool:
    """Whether the padded stream x [B, spq, D] runs the int8 block handoff
    (K5): vitax's auto gate (vitax/models/vit.py:506-513): no dropout, all
    four int8 flags, no int4 or save-acts, and short sequences (spq <= 128,
    the token-drop phase) or streams of >= 51200 rows. The shapes were
    checked by `_padded_stream_len`: K5's halves take what K3 and K4 take."""
    b, spq, _ = x.shape
    return (deterministic and cfg.int8_attn and cfg.int8_mlp
            and cfg.int8_attn_grad and cfg.int8_mlp_grad
            and not (cfg.int4_mlp or cfg.int4_attn or cfg.int4_grad)
            and not cfg.fused_mlp_save
            and (spq <= 128 or b * spq >= 51200))


def _handoff_block(x: torch.Tensor, xq: Optional[torch.Tensor],
                   sx: Optional[torch.Tensor], lp: Params, ln_next: Params,
                   cfg: ViTConfig, seq_len: int):
    """One block through K5 (vitax/models/vit.py:531-557): (x, xq, sx) →
    (r2, xqn, sxn), ln_next the next block's LN1 (the encoder norm's for the
    last block)."""
    dt = x.dtype
    d = x.shape[-1]
    h, hd = cfg.num_heads, cfg.head_dim
    p, mlp = lp["attn"], lp["mlp"]
    wqkv, bqkv = _merged_qkv(p, dt)
    return ck.fused_block_int8_handoff(
        x, xq, sx, lp["ln1"]["scale"].float(), lp["ln1"]["bias"].float(),
        wqkv, bqkv, p["out"]["kernel"].to(dt).reshape(h * hd, d),
        p["out"]["bias"].float(), lp["ln2"]["scale"].float(),
        lp["ln2"]["bias"].float(), mlp["fc1"]["kernel"].to(dt),
        mlp["fc1"]["bias"].float(), mlp["fc2"]["kernel"].to(dt),
        mlp["fc2"]["bias"].float(), ln_next["scale"].float(),
        ln_next["bias"].float(), LN_EPS, seq_len, h, hd, cfg.int8_dw)


def apply(params: Params, images: torch.Tensor, cfg: ViTConfig, *,
          train: bool = False, gen: Optional[torch.Generator] = None,
          mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Forward: NHWC images [B,H,W,3] → fp32 logits [B, num_classes].
    `train` turns on token dropping (cfg.token_keep < 1) and dropout, whose
    random numbers come from `gen`. `mesh`: images are this rank's rows of
    the global batch, whose random numbers are drawn whole; with a model
    axis > 1, params are this rank's shards (`parallel.shard_params`) and
    each block runs per model shard, without the padded stream and the
    int8 handoff (vitax/models/vit.py:424-426, :506), and without K6, which
    vitax does not run per shard. With a data axis alone the dispatch is
    one process's."""
    check_tiers(cfg)
    check_tp(cfg, tp_size(mesh))
    if cfg.remat:
        raise NotImplementedError(
            f"remat={cfg.remat!r}: block rematerialization is not ported yet "
            "(ROADMAP Queue 1 item 6); with both fused kernels vitax picks "
            "no remat, as the port does")
    deterministic = not train or cfg.dropout_rate <= 0.0
    x = embed(params, images, cfg)
    if train and cfg.token_keep < 1.0:
        if gen is None:
            raise ValueError("token_keep < 1.0 requires a generator in "
                             "training")
        x = drop_tokens(x, gen, cfg.token_keep, mesh=mesh)
    x = _dropout(x, cfg.dropout_rate, gen, deterministic, mesh)
    if deterministic:
        gen = None
    wqkv = torch.empty((x.shape[-1], 3 * cfg.num_heads * cfg.head_dim),
                       device="meta")
    if (cfg.fused_qkv and _low_precision(cfg) and tp_size(mesh) == 1
            and _attention_kernel(x, wqkv, cfg.num_heads) == "k6"):
        raise NotImplementedError(_WIDE_TIERS)
    seq_len = None
    spq = _padded_stream_len(x, params, cfg, deterministic, mesh)
    if spq is not None:
        seq_len = x.shape[1]
        x = F.pad(x, (0, 0, 0, spq - seq_len))
    layers = params["layers"]
    if spq is not None and _int8_handoff(x, cfg, deterministic):
        # each block's epilogue packs the next one's LN1; the first block
        # packs its own input (xq None)
        xq = sx = None
        for i, lp in enumerate(layers):
            ln_next = (layers[i + 1]["ln1"] if i + 1 < len(layers)
                       else params["encoder_norm"])
            x, xq, sx = _handoff_block(x, xq, sx, lp, ln_next, cfg, seq_len)
    else:
        for lp in layers:
            x = _block(x, lp, cfg, gen, deterministic, seq_len, mesh)
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
