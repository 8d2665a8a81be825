"""Residual ViT (Res-ViT), serving and training (counterpart of
vitax/models/resvit.py).

Parameters are a plain dict in vitax's pytree layout: per-layer dicts in a
list (block heads carry `router` and `approximators`), `[in, out]` linear
kernels, the patch conv in HWIO. `params_from_jax` takes vitax's tree as
numpy arrays, in either of its layouts. The forward is vitax's `_apply_loop`:
a router at each block head picks, per token, the layers of its block that
run the full transformer block (argmax routing in eval, Gumbel
straight-through in training); the others take the low-rank approximator of
their path id. In training a teacher runs every routed layer densely beside
the student, and the per-layer distill loss holds the student's cls token to
the teacher's. With `compact_capacity` the routed layers run only ceil(C·N)
tokens ranked active first (`compact_routed_block`): on the card the
attention's query rows run through the rect kernel (K8) and the MLP half on
the gathered rows.

On CUDA with `fused_qkv` and `fused_qkvo` the attention half is one kernel
where vitax's gate and the port's pass (ops/gates.py): K1 (K7 with
n_kv_heads < n_heads, K3 with `int8_attn`, K11-C with `int4_attn`, G-F with
both), K8 for the compacted rows (R-F with `int4_attn`). With `fused_qkv`
alone (a config built in code: the CLIs tie the two) the LN kernel and K10
(the QKV projection and the core) run every attention half without GQA,
compacted blocks and the teacher's included, and the out-projection is a
plain product, as vitax's `attention`; `fused_mlp` takes
the MLP half to K2 (K4 with `int8_mlp`, K11-A with `int4_mlp`); LayerNorms
elsewhere (router, final norm, the plain MLP half) take the LN kernel. Under
a mesh (`apply(..., mesh=)`) the fused attention halves decline, as vitax's
do for any mesh, a data-parallel one too: every attention half, the
teacher's and the compacted blocks' included, is the LN kernel and then K9
(the QKV projection, the core and the out-projection) with fused_qkvo, K10
without, and the compacted blocks compact only their MLP half. Under
autograd each has its backward kernel. With them off it is plain PyTorch
ops.

The train-time randomness (the Gumbel noise of each block head, the kept
tokens of `token_keep`) is drawn from a `torch.Generator`, or injected
(`apply(..., noise=)`), so that a test can hand both packages the same
values. vitax's stacked scan layout (`stack_params`) runs the loop: its
`_apply_scan` has the loop's math, and its motive is XLA compile time.
Remat raises (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vitax_torch.core.config import ResViTConfig
from vitax_torch.models.resvit_utils import lra_path_ids, path_id_weights
from vitax_torch.ops import cuda_kernels as ck, gates
from vitax_torch.ops.attention import multi_head_attention
from vitax_torch.ops.common import matmul_f32
from vitax_torch.ops.layernorm import layer_norm
from vitax_torch.ops.mlp import gelu_exact
from vitax_torch.models.vit import drop_tokens
from vitax_torch.ops.patchify import patchify_matmul
from vitax_torch.parallel.mesh import Mesh, draw_rows, local_rows, tp_size

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Layer roles (res-vit/model.py:394-412)
# ---------------------------------------------------------------------------

def layer_roles(cfg: ResViTConfig) -> List[Dict[str, int]]:
    """Static per-layer routing metadata: plain vs routed, block head/pos."""
    roles = []
    for lid in range(cfg.n_layers):
        if not cfg.use_reslr or lid < cfg.dynamic_start_layer:
            roles.append({"routed": False})
            continue
        off = lid - cfg.dynamic_start_layer
        roles.append({
            "routed": True,
            "is_block_head": off % cfg.block_size == 0,
            "block_id": off // cfg.block_size,
            "block_pos": off % cfg.block_size,
        })
    return roles


# ---------------------------------------------------------------------------
# Init: vitax's shapes and distributions, drawn on the host from a
# torch.Generator (other numbers than jax.random's for one seed)
# ---------------------------------------------------------------------------

def _uniform(gen, shape, bound):
    return torch.empty(shape).uniform_(-bound, bound, generator=gen)


def _linear_init(gen, d_in, d_out):
    """torch nn.Linear default: U(±1/√d_in) for weight and bias."""
    bound = 1.0 / math.sqrt(d_in)
    return {"kernel": _uniform(gen, (d_in, d_out), bound),
            "bias": _uniform(gen, (d_out,), bound)}


def _normal_linear(gen, d_in, d_out, std=0.01, bias=False):
    p = {"kernel": torch.randn((d_in, d_out), generator=gen) * std}
    if bias:
        p["bias"] = torch.zeros(d_out)
    return p


def _ln_init(d):
    return {"scale": torch.ones(d), "bias": torch.zeros(d)}


def init_router(gen: torch.Generator, cfg: ResViTConfig) -> Params:
    """RouterModule params (res-vit/model.py:146-167), with the keep-biased
    final-layer init: pass-path bias 0.0, keep-path bias 5.0."""
    d, hd, bs = cfg.dim, cfg.dynamic_router_hdim, cfg.block_size
    out_final = _normal_linear(gen, hd // 2, bs * 2, std=0.01, bias=True)
    out_final["bias"] = torch.tensor([0.0, 5.0]).repeat(bs)
    return {
        "in_norm": _ln_init(d),
        "in_proj": _linear_init(gen, d, hd),
        "out1": _linear_init(gen, 2 * hd, hd),
        "out2": _linear_init(gen, hd, hd // 2),
        "out3": out_final,
    }


def init_approximators(gen: torch.Generator, cfg: ResViTConfig) -> Params:
    """Stacked LowRankApproximators: E = 2^block_size slots, each N(0, 0.01)
    down/up with no bias (res-vit/model.py:320-347)."""
    e, d, r = 2 ** cfg.block_size, cfg.dim, cfg.low_rank_dim
    return {"down": torch.randn((e, d, r), generator=gen) * 0.01,
            "up": torch.randn((e, r, d), generator=gen) * 0.01}


def init_layer(gen: torch.Generator, cfg: ResViTConfig, role: Dict) -> Params:
    d, m = cfg.dim, cfg.mlp_dim
    kv_dim = cfg.head_dim * (cfg.n_kv_heads or cfg.n_heads)
    p: Params = {
        "attention_norm": _ln_init(d),
        "ffn_norm": _ln_init(d),
        "attention": {
            "wq": _linear_init(gen, d, d),
            "wk": _linear_init(gen, d, kv_dim),
            "wv": _linear_init(gen, d, kv_dim),
            "wo": _linear_init(gen, d, d),
        },
        "feed_forward": {
            "fc1": _linear_init(gen, d, m),
            "fc2": _linear_init(gen, m, d),
        },
    }
    if cfg.use_lora:
        r = cfg.lora_rank
        for name, width in (("q", d), ("k", kv_dim), ("v", kv_dim)):
            p["attention"][f"lora_{name}"] = {
                "a": _normal_linear(gen, d, r),
                "b": _normal_linear(gen, r, width)}
    if role.get("routed") and role.get("is_block_head"):
        p["router"] = init_router(gen, cfg)
        p["approximators"] = init_approximators(gen, cfg)
    return p


def _tree_map(fn, *trees):
    """fn over the leaves of trees of one structure (dicts and lists)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, list):
        return [_tree_map(fn, *(t[i] for t in trees)) for i in range(len(t0))]
    return fn(*trees)


def init_params(gen: torch.Generator, cfg: ResViTConfig,
                device: torch.device | str = "cpu") -> Params:
    """Random parameters in vitax's layout and distributions (init_params),
    drawn on the host from `gen`, then moved in cfg.param_dtype."""
    d = cfg.dim
    ph, pw = cfg.patch_size
    roles = layer_roles(cfg)
    bound = 1.0 / math.sqrt(ph * pw * 3)
    params = {
        "embedding": {"kernel": _uniform(gen, (ph, pw, 3, d), bound),
                      "bias": _uniform(gen, (d,), bound)},
        "cls_token": torch.zeros((1, 1, d)),
        "pos_embedding": torch.randn((1, cfg.num_patches + 1, d),
                                     generator=gen),
        "layers": [init_layer(gen, cfg, roles[i])
                   for i in range(cfg.n_layers)],
        "norm": _ln_init(d),
        "classifier": _linear_init(gen, d, cfg.num_classes),
    }
    return _tree_map(lambda t: t.to(device=device, dtype=cfg.param_dtype),
                     params)


def params_from_jax(tree: Params, device: torch.device | str = "cpu"
                    ) -> Params:
    """vitax's Res-ViT parameter pytree (numpy arrays, e.g.
    `jax.tree.map(np.asarray, params)`) → this package's parameters (the
    same keys and shapes), in the per-layer list layout: a tree in vitax's
    pre-stacked scan layout is unstacked (its plain-prefix depth, block
    count and block size read from the stacked leaves)."""
    return unstack_params(_tree_map(
        lambda a: torch.from_numpy(np.array(a)).to(device), tree))


# ---------------------------------------------------------------------------
# vitax's pre-stacked scan layout (stack_params / unstack_params :674-738):
# {"prefix": plain layers [dsl, ...], "base": routed layers without their
# head extras [nblocks, bs, ...], "router", "approximators": [nblocks, ...]}
# ---------------------------------------------------------------------------

def is_stacked(params: Params) -> bool:
    """True when `params["layers"]` is in the pre-stacked scan layout."""
    return isinstance(params.get("layers"), dict)


def _stack(trees: List[Any]) -> Any:
    return _tree_map(lambda *xs: torch.stack(xs), *trees)


def _strip_head_extras(lp: Params) -> Params:
    return {k: v for k, v in lp.items() if k not in ("router",
                                                     "approximators")}


def _scan_eligible(cfg: ResViTConfig) -> bool:
    """vitax's condition for the scan layout: the routed region is whole
    blocks."""
    if not cfg.use_reslr:
        return True
    routed = cfg.n_layers - cfg.dynamic_start_layer
    return routed > 0 and routed % cfg.block_size == 0


def stack_params(params: Params, cfg: ResViTConfig) -> Params:
    """Per-layer list layout → vitax's pre-stacked scan layout (new leaves,
    stacked copies)."""
    if is_stacked(params):
        return params
    if not _scan_eligible(cfg):
        raise ValueError("cannot stack: routed region is not whole blocks")
    dsl = cfg.dynamic_start_layer if cfg.use_reslr else cfg.n_layers
    bs, n_layers = cfg.block_size, cfg.n_layers
    layers = params["layers"]
    stacked: Params = {}
    if dsl > 0:
        stacked["prefix"] = _stack(layers[:dsl])
    if dsl < n_layers:
        heads = range(dsl, n_layers, bs)
        stacked["base"] = _stack([
            _stack([_strip_head_extras(layers[h + p]) for p in range(bs)])
            for h in heads])
        stacked["router"] = _stack([layers[h]["router"] for h in heads])
        stacked["approximators"] = _stack([layers[h]["approximators"]
                                           for h in heads])
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = stacked
    return out


def _leading(tree: Any, ndim: int) -> Tuple[int, ...]:
    while isinstance(tree, (dict, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tuple(tree.shape[:ndim])


def unstack_params(params: Params) -> Params:
    """vitax's pre-stacked scan layout → the per-layer list layout (the
    inverse of `stack_params`; the depths are read from the stacked leaves).
    The leaves are views of the stacked ones, so autograd through them
    reaches the stacked tensors."""
    if not is_stacked(params):
        return params
    s = params["layers"]
    layers: List[Params] = []
    if "prefix" in s:
        (dsl,) = _leading(s["prefix"], 1)
        layers += [_tree_map(lambda a, i=i: a[i], s["prefix"])
                   for i in range(dsl)]
    if "base" in s:
        nblocks, bs = _leading(s["base"], 2)
        for i in range(nblocks):
            for p in range(bs):
                lp = _tree_map(lambda a, i=i, p=p: a[i, p], s["base"])
                if p == 0:
                    lp["router"] = _tree_map(lambda a, i=i: a[i], s["router"])
                    lp["approximators"] = _tree_map(lambda a, i=i: a[i],
                                                    s["approximators"])
                layers.append(lp)
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = layers
    return out



# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------

def _linear(x: torch.Tensor, p: Params, dtype=None) -> torch.Tensor:
    """x @ kernel (+ bias): fp32 products of dtype values, the bias added in
    fp32, then dtype (vitax's einsum with preferred_element_type=f32)."""
    dt = dtype or x.dtype
    y = matmul_f32(x.to(dt), p["kernel"].to(dt))
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(dt)


def _lora(x, p):
    return _linear(_linear(x, p["a"]), p["b"])


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B,S,Hkv,Hd] → [B,S,Hkv*n_rep,Hd] (res-vit/model_utils.py:3-12)."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=2)


def _kv_heads(cfg: ResViTConfig) -> int:
    return cfg.n_kv_heads or cfg.n_heads


def attention(x: torch.Tensor, p: Params, cfg: ResViTConfig,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Self-attention of the LN'd input, fp32 softmax (res-vit/model.py:
    237-299), dispatched as vitax's `attention` (vitax/models/resvit.py:
    220-291): where vitax's fused branch runs (`attention_is_fused`), K9
    with fused_qkvo (`_k9_attention`) and K10 without (`_k10_attention`),
    else the unfused path, whose core is K13 with the kernels on. int8_attn
    and int4_attn do not reach this half, as in vitax: K9 and K10 run in the
    model's dtype whatever the MLP half's tier. `mesh`: a mesh whose model
    axis is 1 (`apply` refuses the others)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, _kv_heads(cfg), cfg.head_dim
    if attention_is_fused(x, cfg):
        if not cfg.fused_qkvo:
            return _k10_attention(x, p, cfg)
        if mesh is None:
            # without a mesh vitax's _fused_attention_half ran K1 under this
            # same gate before `attention` was reached, so vitax starts K9
            # here only under a mesh (where that half declines, :330-331);
            # the port gets here without one only where its own K1 gate
            # refused what vitax's took (no preset today)
            raise NotImplementedError(
                "vitax's gate takes this fused attention half (K1) and the "
                "port's K1 gate does not (Hopper shared memory, head dims)")
        return _k9_attention(x, p, cfg)
    q = _linear(x, p["wq"])
    k = _linear(x, p["wk"])
    v = _linear(x, p["wv"])
    if cfg.use_lora and "lora_q" in p:
        q = q + _lora(x, p["lora_q"])
        k = k + _lora(x, p["lora_k"])
        v = v + _lora(x, p["lora_v"])
    q = q.reshape(b, s, h, hd)
    k = _repeat_kv(k.reshape(b, s, hkv, hd), h // hkv)
    v = _repeat_kv(v.reshape(b, s, hkv, hd), h // hkv)
    out = multi_head_attention(q, k, v, use_kernels=cfg.use_pallas)
    return _linear(out.reshape(b, s, h * hd), p["wo"])


def attention_is_fused(x: torch.Tensor, cfg: ResViTConfig) -> bool:
    """Whether vitax's `attention` takes its fused branch for the LN'd x:
    fused_qkv without GQA where its gate passes (vitax/models/resvit.py:
    227, 266); there it runs K10 without fused_qkvo (:278) and K9 with it
    (:270-277, reached under a mesh, and on one device only where the
    square half declined under the same gate, i.e. never)."""
    wqkv = torch.empty((x.shape[-1], 3 * cfg.n_heads * cfg.head_dim),
                       device="meta")
    return (cfg.fused_qkv and _kv_heads(cfg) == cfg.n_heads
            and gates.qkv_attention_supported(x, wqkv))


def k10_supported(x: torch.Tensor, wqkv: torch.Tensor,
                  cfg: ResViTConfig) -> bool:
    """The port's K10 gate for the LN'd x: its backward's under autograd
    (the ViT's halves are picked the same way)."""
    gate = (ck.fused_qkv_attention_bwd_supported if torch.is_grad_enabled()
            else ck.fused_qkv_attention_supported)
    return gate(x, wqkv, cfg.n_heads)


def _k10_attention(x: torch.Tensor, p: Params, cfg: ResViTConfig
                   ) -> torch.Tensor:
    """vitax's fused branch without fused_qkvo (vitax/models/resvit.py:
    227-268, 278-279): the merged qkv weight with LoRA folded (autograd
    carries dA and dB through the fold), K10 on the rows padded to spq, the
    real rows, then the plain out-projection. Raises where the port's K10
    gate refuses what vitax's takes (K13's limits), rather than run the
    unfused path."""
    s = x.shape[1]
    wqkv, bqkv = _merged_qkv(p, cfg, x.dtype)
    if not k10_supported(x, wqkv, cfg):
        raise NotImplementedError(
            "vitax's gate takes this attention half to its fused_qkv_attention "
            "(K10) and the port's K10 gate does not: K10 runs the first "
            "launches of K1's Hopper sequence on K13's core, which takes head "
            f"dims {ck.K13_HEAD_DIMS[0]}..{ck.K13_HEAD_DIMS[-1]} in steps of "
            f"16 and at most {ck.K13_MAX_SEQ} rows (head_dim {cfg.head_dim}, "
            f"x {tuple(x.shape)}); no fallback")
    out = ck.fused_qkv_attention(_pad_rows(x), wqkv, bqkv, s, cfg.n_heads,
                                 cfg.head_dim)[:, :s]
    return _linear(out, p["wo"])


def k9_supported(x: torch.Tensor, wqkv: torch.Tensor,
                 cfg: ResViTConfig) -> bool:
    """The port's K9 gate for the LN'd x: its backward's under autograd."""
    gate = (ck.fused_qkvo_attention_bwd_supported if torch.is_grad_enabled()
            else ck.fused_qkvo_attention_supported)
    return gate(x, wqkv, cfg.n_heads)


def _k9_attention(x: torch.Tensor, p: Params, cfg: ResViTConfig
                  ) -> torch.Tensor:
    """vitax's fused branch with fused_qkvo (vitax/models/resvit.py:227-277,
    the branch a mesh reaches): the merged qkv weight with LoRA folded
    (autograd carries dA and dB through the fold), K9 on the rows padded to
    spq (the out-projection inside the kernel), the real rows. Raises where
    the port's K9 gate refuses what vitax's takes, rather than run the
    unfused path."""
    s = x.shape[1]
    dt = x.dtype
    wqkv, bqkv = _merged_qkv(p, cfg, dt)
    if not k9_supported(x, wqkv, cfg):
        raise NotImplementedError(
            "vitax's gate takes this attention half to its "
            "fused_qkvo_attention (K9) and the port's K9 gate does not: K9 "
            "runs K1's Hopper sequence on K13's core, which takes head dims "
            f"{ck.K13_HEAD_DIMS[0]}..{ck.K13_HEAD_DIMS[-1]} in steps of 16 "
            f"and at most {ck.K13_MAX_SEQ} rows (head_dim {cfg.head_dim}, "
            f"x {tuple(x.shape)}); no fallback")
    out = ck.fused_qkvo_attention(_pad_rows(x), wqkv, bqkv,
                                  p["wo"]["kernel"].to(dt).contiguous(),
                                  p["wo"]["bias"].float(), s, cfg.n_heads,
                                  cfg.head_dim)
    return out[:, :s].to(dt)


def square_half_supported(x: torch.Tensor, wqkv: torch.Tensor,
                          cfg: ResViTConfig) -> bool:
    """The fused square half's gate: vitax's with (n_heads, n_kv_heads)
    (vitax/models/resvit.py:336) and the port's K1 family's; with GQA (K7,
    the first design) or an int4 tier the kernel raises by name where its
    whole-row core cannot take the shapes."""
    h, hkv = cfg.n_heads, _kv_heads(cfg)
    return (gates.qkv_attention_supported(x, wqkv, h, hkv)
            and ck.qkv_attention_supported(x, wqkv, h, hkv))


def rect_half_supported(xcp: torch.Tensor, xp: torch.Tensor,
                        wqkv: torch.Tensor, cfg: ResViTConfig) -> bool:
    """The rect half's gate on the padded rows: no GQA, vitax's gate without
    heads (vitax/models/resvit.py:375) and the port's."""
    return (_kv_heads(cfg) == cfg.n_heads
            and gates.qkv_attention_supported(xp, wqkv)
            and ck.qkv_attention_rect_supported(xcp, xp, wqkv, cfg.n_heads))


def feed_forward(x: torch.Tensor, p: Params) -> torch.Tensor:
    return _linear(gelu_exact(_linear(x, p["fc1"])), p["fc2"])


def _merged_qkv(ap: Params, cfg: ResViTConfig, dt):
    """The merged [D, (H + 2·Hkv)·Hd] qkv weight of the attention params ap
    with LoRA folded exactly (W_eff = W + A·B, A·B in fp32, added in the base
    weight's dtype), and its fp32 bias (vitax's `merged`,
    vitax/models/resvit.py:239-247, 307-317)."""
    ws = [ap[n]["kernel"] for n in ("wq", "wk", "wv")]
    if cfg.use_lora and "lora_q" in ap:
        ws = [w + matmul_f32(ap[n]["a"]["kernel"], ap[n]["b"]["kernel"])
              .to(w.dtype)
              for w, n in zip(ws, ("lora_q", "lora_k", "lora_v"))]
    wqkv = torch.cat(ws, dim=1).to(dt)
    bqkv = torch.cat([ap[n]["bias"] for n in ("wq", "wk", "wv")]).float()
    return wqkv, bqkv


def _qkvo_weights(p: Params, cfg: ResViTConfig, dt):
    """The merged qkv weight and bias of layer p (`_merged_qkv`) and the
    out-projection (vitax's _qkvo_weights)."""
    ap = p["attention"]
    wqkv, bqkv = _merged_qkv(ap, cfg, dt)
    return (wqkv, bqkv, ap["wo"]["kernel"].to(dt).contiguous(),
            ap["wo"]["bias"].float())


def _pad_rows(t: torch.Tensor) -> torch.Tensor:
    """[B, S, D] zero-padded to a multiple of 8 rows (the kernels' spq)."""
    s = t.shape[1]
    return F.pad(t, (0, 0, 0, (s + 7) // 8 * 8 - s)).contiguous()


def _fused_attention_half(x: torch.Tensor, p: Params, cfg: ResViTConfig,
                          mesh: Optional[Mesh] = None
                          ) -> Optional[torch.Tensor]:
    """LN + qkv (LoRA folded) + attention + out-projection in one kernel for
    the pre-LN input x: K1, K7 with GQA, K3 with int8_attn (K7's int8 tier
    with both), K11-C with int4_attn (its kv_heads branch with GQA), the
    backward's tier as vitax's (vitax/models/resvit.py:340-352: int4_grad
    only with int4_attn, and K11-D only under int8_grad too). Returns the
    half-block output without the residual, or None when vitax's gate or
    the port's declines, and under any mesh, as vitax's (:330-331)."""
    if not (cfg.fused_qkv and cfg.fused_qkvo) or mesh is not None:
        return None
    hkv = _kv_heads(cfg)
    b, s, d = x.shape
    dt = x.dtype
    wqkv, bqkv, wo, bo = _qkvo_weights(p, cfg, dt)
    if not square_half_supported(x, wqkv, cfg):
        return None
    args = (_pad_rows(x), p["attention_norm"]["scale"].float(),
            p["attention_norm"]["bias"].float(), wqkv, bqkv, wo, bo,
            cfg.norm_eps, s, cfg.n_heads, cfg.head_dim)
    if cfg.int4_attn:
        out = ck.fused_ln_qkvo_attention_int4(
            *args, int8_grad=cfg.int8_attn and cfg.int8_attn_grad,
            int8_dw=cfg.int8_dw, int4_grad=cfg.int4_grad, kv_heads=hkv)
    elif cfg.int8_attn:
        out = ck.fused_ln_qkvo_attention_int8(
            *args, int8_grad=cfg.int8_attn_grad, int8_dw=cfg.int8_dw,
            kv_heads=hkv)
    else:
        out = ck.fused_ln_qkvo_attention(*args, kv_heads=hkv)
    return out[:, :s].to(dt)


def _fused_attention_half_rect(x: torch.Tensor, xc: torch.Tensor, p: Params,
                               cfg: ResViTConfig) -> Optional[torch.Tensor]:
    """The rect attention half (K8) for the compaction path: Q, the core's
    query rows and the out-projection on the gathered rows xc [B, cap, D],
    K and V from all rows x [B, N, D]. Returns the output for the xc rows
    without the residual, or None when gated off (GQA declines, as vitax's:
    the square K7 then runs and its rows are gathered). Its tiers as
    `_fused_attention_half`'s (vitax/models/resvit.py:375-390): the A4W4
    forward with int4_attn, its A4W4 backward only under int8_grad and
    int4_grad."""
    if not (cfg.fused_qkv and cfg.fused_qkvo) or _kv_heads(cfg) != cfg.n_heads:
        return None
    s, cap = x.shape[1], xc.shape[1]
    dt = x.dtype
    wqkv, bqkv, wo, bo = _qkvo_weights(p, cfg, dt)
    xp, xcp = _pad_rows(x), _pad_rows(xc)
    if not rect_half_supported(xcp, xp, wqkv, cfg):
        return None
    args = (xcp, xp, p["attention_norm"]["scale"].float(),
            p["attention_norm"]["bias"].float(), wqkv, bqkv, wo, bo,
            cfg.norm_eps, s, cfg.n_heads, cfg.head_dim)
    if cfg.int4_attn:
        out = ck.fused_ln_qkvo_attention_rect_int4(
            *args, int8_grad=cfg.int8_attn and cfg.int8_attn_grad,
            int8_dw=cfg.int8_dw, int4_grad=cfg.int4_grad)
    elif cfg.int8_attn:
        out = ck.fused_ln_qkvo_attention_rect_int8(
            *args, int8_grad=cfg.int8_attn_grad, int8_dw=cfg.int8_dw)
    else:
        out = ck.fused_ln_qkvo_attention_rect(*args)
    return out[:, :cap].to(dt)


def _mlp_half(h: torch.Tensor, p: Params, cfg: ResViTConfig) -> torch.Tensor:
    """LN2 + FFN + residual from the post-attention tensor h: row-wise, so
    it runs the same on the full [B,N,D] tensor and on a compacted [B,C,D]
    gather of its rows. fused_mlp: K2 (K4 with int8_mlp, K11-A with
    int4_mlp; K12 under autograd with fused_mlp_save, as vitax's
    fused_ln_mlp dispatches: int4 ahead of save-acts and int8)."""
    ffp = p["feed_forward"]
    if cfg.fused_mlp:
        w1 = ffp["fc1"]["kernel"].to(h.dtype)
        w2 = ffp["fc2"]["kernel"].to(h.dtype)
        if ck.ln_mlp_supported(h, w1, w2):
            args = (h.contiguous(), p["ffn_norm"]["scale"].float(),
                    p["ffn_norm"]["bias"].float(), w1,
                    ffp["fc1"]["bias"].float(), w2,
                    ffp["fc2"]["bias"].float(), cfg.norm_eps)
            if cfg.int4_mlp:
                return ck.fused_ln_mlp_int4(*args,
                                            int8_grad=cfg.int8_mlp_grad,
                                            int8_dw=cfg.int8_dw,
                                            int4_grad=cfg.int4_grad)
            if cfg.int8_mlp:
                return ck.fused_ln_mlp_int8(*args,
                                            int8_grad=cfg.int8_mlp_grad,
                                            int8_dw=cfg.int8_dw,
                                            save_acts=cfg.fused_mlp_save)
            return ck.fused_ln_mlp(*args, save_acts=cfg.fused_mlp_save)
    return h + feed_forward(layer_norm(h, p["ffn_norm"]["scale"],
                                       p["ffn_norm"]["bias"], cfg.norm_eps,
                                       use_kernels=cfg.use_pallas), ffp)


def _attention_half(x: torch.Tensor, p: Params, cfg: ResViTConfig,
                    mesh: Optional[Mesh] = None) -> torch.Tensor:
    h_att = _fused_attention_half(x, p, cfg, mesh)
    if h_att is None:
        h_att = attention(layer_norm(x, p["attention_norm"]["scale"],
                                     p["attention_norm"]["bias"],
                                     cfg.norm_eps, use_kernels=cfg.use_pallas),
                          p["attention"], cfg, mesh)
    return h_att


def plain_block(x: torch.Tensor, p: Params, cfg: ResViTConfig,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Pre-LN block (res-vit/model.py:436-444)."""
    return _mlp_half(x + _attention_half(x, p, cfg, mesh), p, cfg)


def _compact_rank_key(active: torch.Tensor,
                      score: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ranking key for capacity compaction (ascending, stable sort): actives
    first; within actives by router keep-confidence descending when `score`
    is given, else by original index."""
    if score is None:
        n = active.shape[-1]
        return ((~active).to(torch.int32) * n
                + torch.arange(n, dtype=torch.int32,
                               device=active.device)[None, :])
    return (~active).float() * 4.0 + (1.0 - score.float())


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, D] rows at idx [B, C] → [B, C, D] (the same bits)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def compact_routed_block(x: torch.Tensor, p: Params, cfg: ResViTConfig,
                         active: torch.Tensor, cap: int,
                         score: Optional[torch.Tensor] = None,
                         mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Routed block with token compaction: `where(active, block(x), x)` with
    the block's query rows and MLP half run only on the top-`cap` tokens
    ranked active first (vitax's compact_routed_block). K and V come from
    all tokens. vitax moves the rows with one-hot matmuls (a TPU choice);
    here they are gathered and scattered, which copies the same bits.
    Actives beyond capacity keep x; the caller decides their fate. Under a
    mesh the rect half declines (vitax/models/resvit.py:499): the square
    half runs on all rows and only the MLP half is compacted."""
    order = torch.argsort(_compact_rank_key(active, score), dim=-1,
                          stable=True)
    keep_idx = order[:, :cap]
    kept_active = torch.gather(active, 1, keep_idx)
    x_c = _rows(x, keep_idx)
    h_c = None
    if cfg.compact_attention and mesh is None:
        attn_c = _fused_attention_half_rect(x, x_c, p, cfg)
        if attn_c is not None:
            h_c = x_c + attn_c
    if h_c is None:
        h_c = _rows(x + _attention_half(x, p, cfg, mesh), keep_idx)
    out_c = _mlp_half(h_c, p, cfg).to(x.dtype)
    vals = torch.where(kept_active[..., None], out_c, x_c)
    return x.scatter(1, keep_idx[..., None].expand(-1, -1, x.shape[-1]),
                     vals)


def router_forward(x: torch.Tensor, p: Params, cfg: ResViTConfig, *,
                   train: bool = False, gumbel: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor, torch.Tensor]:
    """RouterModule (res-vit/model.py:175-211): argmax routing in eval; in
    training Gumbel-softmax straight-through at τ = 1 over `gumbel` [B,N,bs,2]
    (standard Gumbel noise, vitax's jax.random.gumbel), hard + (y_soft −
    y_soft.detach()): the one-hot in value, y_soft's gradient. The reserved
    initials are forced to keep; path ids come from the keep bits.

    Returns (hard_routing [B,N,bs,2], path_ids [B,N] int32, entropy scalar,
    soft_routing [B,N,bs,2], entropy_rows [B]: each row's share of the
    entropy sum, so that a padded batch can weight it)."""
    if train and gumbel is None:
        raise ValueError("router needs its Gumbel noise in training mode")
    b, n, _ = x.shape
    bs = cfg.block_size
    res = cfg.dynamic_reserve_initials
    e = layer_norm(x, p["in_norm"]["scale"], p["in_norm"]["bias"],
                   cfg.norm_eps, use_kernels=cfg.use_pallas)
    e = gelu_exact(_linear(e, p["in_proj"]))
    patch = e[:, res:, :] if res > 0 else e
    g = patch.float().mean(dim=1, keepdim=True).to(e.dtype)
    fused = torch.cat([e, g.expand_as(e)], dim=-1)
    h = gelu_exact(_linear(fused, p["out1"]))
    h = gelu_exact(_linear(h, p["out2"]))
    logits = _linear(h, p["out3"]).float().reshape(b, n, bs, 2)

    soft = torch.softmax(logits, dim=-1)
    probs = soft[:, res:]
    ent = -(probs * torch.log(probs + 1e-8)).sum(dim=(1, 2, 3))
    entropy = ent.sum() / (b * (n - res) * bs)
    entropy_rows = ent / ((n - res) * bs)
    # one-hot of the argmax (ties to the first, as jnp.argmax), the reserved
    # initials forced to keep; scalars only, so nothing waits on the card
    # (F.one_hot and a host tensor copied in would synchronize)
    y_soft = (torch.softmax(logits + gumbel.to(logits.device), dim=-1)
              if train else soft)
    keep = (torch.argmax(y_soft, dim=-1) == 1).float()
    if res > 0:
        keep[:, :res] = 1.0
    hard = torch.stack([1.0 - keep, keep], dim=-1)
    if train:
        # straight-through; the forced initials carry no soft term
        st = y_soft - y_soft.detach()
        if res > 0:
            st = torch.cat([torch.zeros_like(st[:, :res]), st[:, res:]], 1)
        hard = hard + st
    # path ids from the exact keep bits: vitax reads them off the
    # straight-through sum, whose kept bit can round to 1 - 2^-24 and then
    # truncate away (ROADMAP Queue 3)
    return hard, _path_ids(keep, bs), entropy, soft, entropy_rows


def _path_ids(keep: torch.Tensor, bs: int) -> torch.Tensor:
    """Keep bits [B,N,bs] packed big-endian into path ids [B,N] int32."""
    ids = torch.zeros(keep.shape[:-1], dtype=torch.int32, device=keep.device)
    for k, w in enumerate(path_id_weights(bs)):
        ids += keep[..., k].to(torch.int32) * w
    return ids


def _isin(path_ids: torch.Tensor, ids: List[int]) -> torch.Tensor:
    """path_ids ∈ ids, compared against python ints (no host tensor)."""
    out = torch.zeros_like(path_ids, dtype=torch.bool)
    for k in ids:
        out |= path_ids == k
    return out


def apply_approximators(x: torch.Tensor, p: Params, path_ids: torch.Tensor,
                        lora_ids: List[int]) -> torch.Tensor:
    """BlockPathApproximators (res-vit/model.py:349-368): for each path id k
    in `lora_ids`, tokens with that id get x += up_k(down_k(x)), fp32 sums
    rounded to x.dtype after each product."""
    dt = x.dtype
    for k in lora_ids:
        delta = matmul_f32(x, p["down"][k].to(dt)).to(dt)
        delta = matmul_f32(delta, p["up"][k].to(dt)).to(dt)
        x = torch.where((path_ids == k)[..., None], x + delta, x)
    return x


def active_loss(soft_probs: torch.Tensor, target: float,
                reserve_initials: int) -> torch.Tensor:
    """MSE(mean keep-prob over non-reserved tokens, target)
    (res-vit/model.py:40-85)."""
    a = soft_probs[:, reserve_initials:, :].float()
    return (a.mean() - target) ** 2


def active_metric(acts: torch.Tensor, target: float,
                  reserve_initials: int,
                  weight: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """The active ratio over the non-reserved tokens; with `weight` [B] (a
    padded batch's row weights) the mean over the real rows only."""
    a = acts[:, reserve_initials:, :].float()
    if weight is None:
        ratio = a.mean()
    else:
        ratio = (a.mean(dim=(1, 2)) * weight).sum() / weight.sum().clamp_min(
            1.0)
    return {"non_low_rank_ratio": ratio,
            "current_target": torch.tensor(target)}


def trainable_mask(params: Params, cfg: ResViTConfig) -> Params:
    """LoRA freezing rules (res-vit/model.py:572-584 + its LayerNorm wrapper
    :119-130): with use_lora the base projections, patch embedding, pos
    embedding, feed-forward and every LayerNorm are frozen; LoRA adapters,
    router linears, approximators, cls token and classifier train. A tree of
    bools like `params` (either layout)."""
    def walk(path: str, tree):
        if isinstance(tree, dict):
            return {k: walk(f"{path}/{k}", v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(f"{path}/{i}", v) for i, v in enumerate(tree)]
        if not cfg.use_lora:
            return True
        frozen = (
            path.startswith("/embedding") or
            path.startswith("/pos_embedding") or
            "/feed_forward/" in path or
            "/attention/wq/" in path or "/attention/wk/" in path or
            "/attention/wv/" in path or "/attention/wo/" in path or
            "norm" in path  # attention_norm, ffn_norm, router in_norm, final
        )
        return not frozen

    return walk("", params)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def embed(params: Params, images: torch.Tensor, cfg: ResViTConfig
          ) -> torch.Tensor:
    """Patchify + cls + pos (res-vit/model.py:602-607); NHWC input. The
    position embedding is added over the first min(N+1, its length) tokens
    (the reference's length-mismatch slice)."""
    tokens = patchify_matmul(images, params["embedding"]["kernel"],
                             params["embedding"]["bias"], dtype=cfg.dtype)
    b, _, d = tokens.shape
    cls = params["cls_token"].to(cfg.dtype).expand(b, 1, d)
    x = torch.cat([cls, tokens], dim=1).float()
    pos = params["pos_embedding"]
    n = min(x.shape[1], pos.shape[1])
    x[:, :n] += pos[:, :n].float()
    return x.to(cfg.dtype)


def apply(params: Params, images: torch.Tensor, cfg: ResViTConfig, *,
          train: bool = False, gen: Optional[torch.Generator] = None,
          noise: Optional[Dict[str, Any]] = None,
          mesh: Optional[Mesh] = None
          ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Forward: NHWC images → (fp32 logits, aux). aux: d_loss (the summed
    per-layer cls distill MSE in training, 0 in eval), r_entropy,
    r_entropy_rows [B], acts [B,N,L] (per-layer keep bits, 1 on plain
    layers), soft_probs [B,N,n_blocks·bs] (keep probabilities) or None,
    routing_maps {block_id: [B,N,bs]}.

    train: Gumbel routing, the teacher path and the distill loss, and
    token dropping at cfg.token_keep < 1. Their randomness comes from `noise`
    where it holds it — "gumbel": {layer id of a block head: [B,N,bs,2]},
    "token_idx": [B, kept] (vit.drop_tokens' `idx`) — else from `gen`.
    Params in vitax's stacked layout run unstacked (as vitax, not with
    compact_capacity).

    mesh: vitax's dispatch under a mesh (its `_fused_attention_half`
    declines, so `attention` runs K9, and the rect half declines); images
    are this rank's rows of the global batch, whose randomness (and the
    injected `noise`, which is the global batch's) is drawn whole and cut
    by data index. A model axis > 1 raises: vitax shards wq/wk/wv/wo and
    fc1/fc2 there, which the port does not run yet."""
    if tp_size(mesh) > 1:
        raise NotImplementedError(
            f"Res-ViT under a model axis of {tp_size(mesh)}: its sharded "
            "attention and MLP weights, and the MLP half and approximators "
            "that vitax leaves to XLA on them, are not ported; ROADMAP "
            'Queue 1 item 10, "Res-ViT under tensor parallelism". Run it '
            "with --n-model 1")
    if is_stacked(params):
        if cfg.compact_capacity is not None:
            raise ValueError("compact_capacity requires the unrolled loop "
                             "(unstacked params); see unstack_params")
        params = unstack_params(params)
    if cfg.remat:
        raise NotImplementedError(
            f"remat={cfg.remat!r}: block rematerialization is not ported "
            "(ROADMAP Queue 1 item 6)")
    return _apply_loop(params, images, cfg, train, gen, noise or {}, mesh)


def _gumbel(noise: Dict[str, Any], lid: int, shape, gen, dev,
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The Gumbel noise of block head `lid`: injected, or −log(E) with E
    standard exponential from `gen`; under a mesh this rank's rows of the
    global batch's."""
    g = noise.get("gumbel", {}).get(lid)
    if g is not None:
        return local_rows(mesh, g).to(device=dev, dtype=torch.float32)
    if gen is None:
        raise ValueError("Res-ViT training needs a generator or the noise")
    e = draw_rows(mesh, shape, lambda sh: torch.empty(
        sh, device=gen.device).exponential_(generator=gen))
    return (-torch.log(e)).to(dev)


def _apply_loop(params: Params, images: torch.Tensor, cfg: ResViTConfig,
                train: bool = False, gen: Optional[torch.Generator] = None,
                noise: Optional[Dict[str, Any]] = None,
                mesh: Optional[Mesh] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Unrolled per-layer loop (vitax's _apply_loop). The teacher runs
    without autograd: vitax stops its gradient at the cls token it reads, so
    the values are the same and nothing is kept for the backward."""
    noise = noise or {}
    roles = layer_roles(cfg)
    lra = lra_path_ids(cfg.block_size) if cfg.use_reslr else None
    student = embed(params, images, cfg)
    if train and cfg.token_keep < 1.0:
        # cls and the reserved initials stay pinned, so the cls distill
        # loss and the router's reserved slots see the same tokens
        idx = noise.get("token_idx")
        if idx is None and gen is None:
            raise ValueError("token_keep < 1.0 needs a generator or the "
                             "kept indices in training")
        if idx is not None:
            idx = local_rows(mesh, idx)
        student = drop_tokens(student, gen, cfg.token_keep,
                              n_pinned=max(1, cfg.dynamic_reserve_initials),
                              idx=idx, mesh=mesh)
    teacher = student
    b, n, _ = student.shape
    dev = student.device

    cap = None
    if cfg.compact_capacity is not None and cfg.use_reslr:
        cap = min(n, max(1, math.ceil(cfg.compact_capacity * n)))

    acts: List[torch.Tensor] = []
    soft_probs: List[torch.Tensor] = []
    routing_maps: Dict[int, torch.Tensor] = {}
    r_entropy = torch.zeros((), device=dev)
    r_entropy_rows = torch.zeros((b,), device=dev)
    d_loss = torch.zeros((), device=dev)
    block_ctx: Dict[str, Any] = {}

    for lid, role in enumerate(roles):
        lp = params["layers"][lid]
        if not role["routed"]:
            student = plain_block(student, lp, cfg, mesh)
            # plain layers collapse the teacher onto the student path
            # (res-vit/model.py:440-444)
            teacher = student
            acts.append(torch.ones((b, n, 1), device=dev))
            continue

        if role["is_block_head"]:
            g = (_gumbel(noise, lid, (b, n, cfg.block_size, 2), gen, dev,
                         mesh) if train else None)
            hard, path_ids, entropy, soft, ent_rows = router_forward(
                student, lp["router"], cfg, train=train, gumbel=g)
            block_ctx = {"hard": hard[..., 1], "path_ids": path_ids,
                         "approx_params": lp["approximators"],
                         "keep_score": soft[..., 1].detach()}
            r_entropy = r_entropy + entropy
            r_entropy_rows = r_entropy_rows + ent_rows
            routing_maps[role["block_id"]] = block_ctx["hard"].detach()
            soft_probs.append(soft[..., 1])

        pos = role["block_pos"]
        w = block_ctx["hard"][:, :, pos:pos + 1]
        lora_ids, trans_ids, _ = lra[pos]
        path_ids = block_ctx["path_ids"]
        attn_mask = _isin(path_ids, trans_ids)[..., None]
        if train:
            with torch.no_grad():
                teacher = plain_block(teacher, lp, cfg, mesh)
        if cap is not None:
            active = attn_mask[..., 0]
            score = None
            if cfg.compact_demote_overflow:
                # rank actives by keep-confidence (reserved initials pinned
                # first); an overflow token has its path bit cleared, so it
                # takes the approximator of its executed path (vitax's
                # demotion)
                score = block_ctx["keep_score"][:, :, pos]
                if cfg.dynamic_reserve_initials > 0:
                    pinned = (torch.arange(n, device=dev)[None, :]
                              < cfg.dynamic_reserve_initials)
                    score = torch.where(pinned, torch.full_like(score, 2.0),
                                        score)
                key = _compact_rank_key(active, score)
                rank = torch.argsort(torch.argsort(key, dim=-1, stable=True),
                                     dim=-1, stable=True)
                overflow = active & (rank >= cap)
                wpos = int(path_id_weights(cfg.block_size)[pos])
                path_ids = path_ids - wpos * overflow.to(torch.int32)
                block_ctx["path_ids"] = path_ids
            merged = compact_routed_block(student, lp, cfg, active, cap,
                                          score, mesh)
        else:
            merged = torch.where(attn_mask,
                                 plain_block(student, lp, cfg, mesh), student)
        student = apply_approximators(merged, block_ctx["approx_params"],
                                      path_ids, lora_ids)
        if train:
            s_cls = student[:, 0].float()
            d_loss = d_loss + ((s_cls - teacher[:, 0].float()) ** 2).mean()
        acts.append(w)

    student = layer_norm(student, params["norm"]["scale"],
                         params["norm"]["bias"], cfg.norm_eps,
                         use_kernels=cfg.use_pallas)
    logits = _linear(student[:, 0].float(), params["classifier"],
                     dtype=torch.float32)
    aux: Dict[str, Any] = {
        "d_loss": d_loss,
        "r_entropy": r_entropy,
        "r_entropy_rows": r_entropy_rows,
        "acts": torch.cat(acts, dim=-1),
        "soft_probs": torch.cat(soft_probs, dim=-1) if soft_probs else None,
        "routing_maps": routing_maps,
    }
    return logits, aux


def apply_nchw(params: Params, images_nchw: torch.Tensor, cfg: ResViTConfig,
               **kw):
    return apply(params, images_nchw.permute(0, 2, 3, 1), cfg, **kw)
