"""The worker side of tests/test_torch_parallel.py: each function runs in
every process of a gloo world of CPU processes (torch and vitax_torch only:
no jax here, so the spawned processes start quickly) and returns what the
test compares against one process. Not a test module: pytest collects
test_*.py only.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

from vitax_torch.core import config as tconf
from vitax_torch.models import resvit, vit
from vitax_torch.parallel import (batch_rows, gather_params, make_mesh,
                                  shard_params, vit_param_spec)
from vitax_torch.parallel import tp_kernels
from vitax_torch.train import create_train_state, make_train_step, \
    sgd_momentum
from vitax_torch.train import resvit_steps

# a 2-layer ViT at D 128 (vitax's gates take D % 128 == 0 only): 2 heads of
# 64, MLP 256, 32 px at patch 8 (17 tokens, spq 24), fp32, both fused halves
VIT = dict(image_size=(32, 32), patch_size=(8, 8), emb_dim=128, mlp_dim=256,
           num_heads=2, num_layers=2, num_classes=10, dropout_rate=0.0,
           dtype=torch.float32, fused_qkv=True, fused_mlp=True,
           use_pallas=True)
# the arch preset the CLIs build at that size
PRESET = dict(patch=8, emb_dim=128, mlp_dim=256, num_heads=2, num_layers=2)
BATCH = 4
STEPS = 3


def vit_batch(seed=1):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.uniform(-1, 1, (BATCH, 32, 32, 3))
                             .astype(np.float32)),
            torch.from_numpy(rng.integers(0, 10, BATCH)))


def vit_sgd_steps(mesh=None, lr=0.1, **over):
    """Three SGD steps (momentum 0.9, OneCycle) of the 2-layer ViT (its
    config with `over`) on the global batch (this rank's rows of it under a
    mesh, its shards under a model axis): the losses, then the logits of
    this rank's rows and the whole parameters after the steps."""
    cfg = tconf.ViTConfig(**{**VIT, **over})
    params = shard_params(vit.init_params(torch.Generator().manual_seed(0),
                                          cfg), mesh, vit_param_spec)
    opt, sched = sgd_momentum(params, lr, 10, 0.2)
    state = create_train_state(params, opt, sched,
                               torch.Generator().manual_seed(1))
    step = make_train_step(cfg, opt, sched, mesh=mesh)
    images, labels = vit_batch()
    losses = []
    for _ in range(STEPS):
        state, m = step(state, images, labels)
        losses.append(float(m["loss"]))
    with torch.no_grad():
        rows = batch_rows(mesh, BATCH)
        logits = vit.apply(state.params, images[rows], cfg, mesh=mesh)
        whole = gather_params(state.params, mesh, vit_param_spec)
    return {"losses": losses, "logits": logits, "rows": rows,
            "params": _detach(whole)}


# the flag sets of vitax's tensor-parallel wrappers, (int8, int8_grad,
# int8_dw, int4, int4_grad): train_cli's --int8, --int8-grad, --int8-dw,
# --int4, --int4-attn --int4-grad --int8-grad and --int4-attn --int4-grad
# --int8-dw
TIERS = {"int8": (True, False, False, False, False),
         "int8_grad": (True, True, False, False, False),
         "int8_dw": (True, True, True, False, False),
         "int4": (True, False, False, True, False),
         "int4_grad": (True, True, False, True, True),
         "int4_grad_dw": (True, True, True, True, True)}
# the config fields the CLIs' tier flags set
TIER_FIELDS = ("int8_mlp", "int8_attn", "int8_mlp_grad", "int8_attn_grad",
               "int8_dw", "int4_mlp", "int4_attn", "int4_grad")
# SGD steps under (1, 2) held against vitax's: the four tier flags whose
# tensor-parallel runs raised before the tiers were ported, the third tier,
# --no-fused-qkv and dropout (injected masks, `injected_dropout`). The
# tiers take test_torch_int8.py's learning rate: a quantization code that
# moves one step on a rounding tie moves a step of lr 0.1 too far.
STEP_CASES = {"--int8": ["--int8"], "--int8-grad": ["--int8-grad"],
              "--int4": ["--int4"], "--int4-attn": ["--int4-attn"],
              "--int8-dw": ["--int8-dw"], "--no-fused-qkv": {"fused_qkv": False},
              "dropout": {"dropout_rate": 0.1}}
TIER_LR = 0.003


def step_overrides(case):
    """(config fields, learning rate) of a STEP_CASES entry: a tier's fields
    as train_cli maps its flags (model_config_from_cli)."""
    from vitax_torch import cli, train_cli
    over = STEP_CASES[case]
    if isinstance(over, dict):
        return over, 0.1
    saved = tconf.ARCH_PRESETS.get("tiny")
    tconf.ARCH_PRESETS["tiny"] = PRESET
    try:
        cfg = train_cli.model_config_from_cli(
            cli.get_train_config(cli_args(4, over)), False)
    finally:
        tconf.ARCH_PRESETS["tiny"] = saved
    return {k: getattr(cfg, k) for k in TIER_FIELDS}, TIER_LR


def dropout_mask(i, shape, rate):
    """The keep mask of the i-th dropout call of a forward, drawn with
    numpy, so that both packages drop the same units."""
    return np.random.default_rng(1000 + i).uniform(size=shape) >= rate


@contextlib.contextmanager
def injected_dropout():
    """vit._dropout with `dropout_mask` in place of the generator's draw, by
    call order: 0 after `embed`, then 1, 2, 3 in every block, as vitax
    traces its layers' `lax.scan` body once, so that all its layers take
    the masks of one traced block."""
    calls = [0]
    embed, block, dropout = vit.embed, vit._block, vit._dropout

    def counted_embed(*a, **k):
        calls[0] = 0
        return embed(*a, **k)

    def counted_block(*a, **k):
        calls[0] = 1
        return block(*a, **k)

    def masked(x, rate, gen, deterministic, mesh=None):
        if deterministic or rate <= 0.0 or gen is None:
            return x
        keep = torch.from_numpy(dropout_mask(calls[0], tuple(x.shape), rate))
        calls[0] += 1
        return torch.where(keep, x / (1.0 - rate),
                           torch.zeros_like(x)).to(x.dtype)
    vit.embed, vit._block, vit._dropout = counted_embed, counted_block, masked
    try:
        yield
    finally:
        vit.embed, vit._block, vit._dropout = embed, block, dropout


def tp_step_cases(mesh):
    """`vit_sgd_steps` under the mesh for every STEP_CASES entry."""
    out = {}
    for case in STEP_CASES:
        over, lr = step_overrides(case)
        with (injected_dropout() if case == "dropout"
              else contextlib.nullcontext()):
            out[case] = vit_sgd_steps(mesh, lr, **over)
    return out


def tp_wrapper_inputs(seed=7):
    """numpy inputs of the three tensor-parallel wrappers: x [2, 24, 128]
    (seq 21, zero pad rows), LN γ and β, ViT-layout wq/wk/wv [128, 4, 32],
    biases [4, 32], wo [4, 32, 128], bo; Res-ViT-layout [128, 128] weights
    and [128] biases; fc1/fc2 [128, 256]/[256, 128] with biases; and the
    cotangents of the three outputs."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)
    d, h, hd, m = 128, 4, 32, 256
    x = n(2, 24, d)
    x[:, 21:] = 0
    out = {"x": x, "gamma": 1 + n(d, s=0.1), "beta": n(d, s=0.1),
           "bo": n(d, s=0.1), "b2": n(d, s=0.1), "b1": n(m, s=0.1),
           "w1": n(d, m, s=d ** -0.5), "w2": n(m, d, s=m ** -0.5)}
    for k in ("wq", "wk", "wv"):
        out[k] = n(d, h, hd, s=d ** -0.5)
        out["b" + k[1]] = n(h, hd, s=0.1)
        out["r" + k] = n(d, d, s=d ** -0.5)
        out["rb" + k[1]] = n(d, s=0.1)
    out["wo"] = n(h, hd, d, s=d ** -0.5)
    out["rwo"] = n(d, d, s=d ** -0.5)
    for k in ("dy_attn", "dy_qkvo", "dy_mlp"):
        out[k] = n(2, 24, d)
        out[k][:, 21:] = 0
    return out


def _shard(t, axis, mesh):
    return t.chunk(mesh.n_model, axis)[mesh.model_index].clone() \
        .contiguous().requires_grad_()


def _attn_wrapper(a, mesh, tier=()):
    """fused_ln_qkvo_attention_tp (ViT layout) with the flags `tier`: its
    output and the grads of x, γ, β, bo and every shard."""
    x, g, be, bo = (a[k].clone().requires_grad_()
                    for k in ("x", "gamma", "beta", "bo"))
    ws = [_shard(a[k], 1, mesh) for k in ("wq", "wk", "wv")]
    bs = [_shard(a[k], 0, mesh) for k in ("bq", "bk", "bv")]
    wo = _shard(a["wo"], 0, mesh)
    y = tp_kernels.fused_ln_qkvo_attention_tp(x, g, be, *ws, *bs, wo, bo,
                                              mesh, 1e-6, 21, 4, 32, *tier)
    y.backward(a["dy_attn"])
    return {"y": y, "x": x.grad, "gamma": g.grad, "beta": be.grad,
            "bo": bo.grad, "wq": ws[0].grad, "wk": ws[1].grad,
            "wv": ws[2].grad, "bq": bs[0].grad, "bk": bs[1].grad,
            "bv": bs[2].grad, "wo": wo.grad}


def _mlp_wrapper(a, mesh, tier=()):
    """fused_ln_mlp_tp with the flags `tier`: its output and the grads of x,
    γ, β, b2 and every shard."""
    x, g, be, b2 = (a[k].clone().requires_grad_()
                    for k in ("x", "gamma", "beta", "b2"))
    w1, b1 = _shard(a["w1"], 1, mesh), _shard(a["b1"], 0, mesh)
    w2 = _shard(a["w2"], 0, mesh)
    y = tp_kernels.fused_ln_mlp_tp(x, g, be, w1, b1, w2, b2, mesh, 1e-6,
                                   *tier)
    y.backward(a["dy_mlp"])
    return {"y": y, "x": x.grad, "gamma": g.grad, "beta": be.grad,
            "b2": b2.grad, "w1": w1.grad, "b1": b1.grad, "w2": w2.grad}


def tp_wrappers(mesh):
    """The three wrappers of parallel/tp_kernels.py on this rank's shards
    (the attention and MLP halves also in every tier of TIERS, keyed
    "attn <tier>", "mlp <tier>"): their outputs and the grads of x, γ, β,
    bo/b2 and every shard of theirs under the given cotangents."""
    a = {k: torch.from_numpy(v) for k, v in tp_wrapper_inputs().items()}
    out = {"attn": _attn_wrapper(a, mesh)}
    for name, tier in TIERS.items():
        out[f"attn {name}"] = _attn_wrapper(a, mesh, tier)
        out[f"mlp {name}"] = _mlp_wrapper(a, mesh, tier)
    # K9 per shard (Res-ViT layout)
    x, bo = (a[k].clone().requires_grad_() for k in ("x", "bo"))
    ws = [_shard(a["r" + k], 1, mesh) for k in ("wq", "wk", "wv")]
    bs = [_shard(a["rb" + k], 0, mesh) for k in ("q", "k", "v")]
    wo = _shard(a["rwo"], 0, mesh)
    y = tp_kernels.fused_qkvo_attention_tp(x, *ws, *bs, wo, bo, mesh, 21, 4,
                                           32)
    y.backward(a["dy_qkvo"])
    out["qkvo"] = {"y": y, "x": x.grad, "bo": bo.grad, "wq": ws[0].grad,
                   "wk": ws[1].grad, "wv": ws[2].grad, "bq": bs[0].grad,
                   "bk": bs[1].grad, "bv": bs[2].grad, "wo": wo.grad}
    out["mlp"] = _mlp_wrapper(a, mesh)  # K2 without its residual per shard
    return _detach(out)


# Res-ViT: tests/test_torch_resvit_train.py's small config (D 128, 2 heads
# of 64, 5 layers, block size 2, 32 px at patch 8), fp32, the fused path
RESVIT = dict(dim=128, mlp_dim=256, n_layers=5, n_heads=2, n_kv_heads=2,
              lora_rank=4, dynamic_start_layer=1, dynamic_router_hdim=32,
              dynamic_reserve_initials=2, low_rank_dim=8, block_size=2,
              use_lora=True, use_reslr=True, image_size=(32, 32),
              patch_size=(8, 8), num_classes=7, dropout=0.0,
              dynamic_active_target=0.4, fused_qkv=True, fused_qkvo=True,
              fused_mlp=True, use_pallas=True, dtype=torch.float32,
              param_dtype=torch.float32)


def resvit_weights(cfg):
    """resvit.init_params from a seed with the routers' last layers redrawn
    (every token would keep at the init's keep bias)."""
    params = resvit.init_params(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(5)
    for lp in params["layers"]:
        if "router" in lp:
            out3 = lp["router"]["out3"]
            out3["bias"] = torch.rand(out3["bias"].shape, generator=g) * 0.6 \
                - 0.3
            out3["kernel"] = 0.5 * torch.randn(out3["kernel"].shape,
                                               generator=g)
    return params


def resvit_noise(cfg, batch, seed=3):
    """Gumbel noise of every block head for the global batch."""
    g = torch.Generator().manual_seed(seed)
    n = cfg.num_patches + 1
    return {"gumbel": {
        lid: -torch.log(torch.empty((batch, n, cfg.block_size, 2))
                        .exponential_(generator=g))
        for lid, r in enumerate(resvit.layer_roles(cfg))
        if r.get("is_block_head")}}


def resvit_adamw_steps(mesh=None, compact=None):
    """Three AdamW steps (lr 1e-3, ft_resvit.sh's λ) of the small Res-ViT on
    the global batch of 4 with the global noise injected: each step's
    metrics, then the parameters."""
    cfg = tconf.ResViTConfig(**RESVIT, compact_capacity=compact)
    params = resvit_weights(cfg)
    tx = resvit_steps.make_adamw_for(cfg, params, lambda s: 1e-3)
    state = resvit_steps.create_state(params, tx,
                                      torch.Generator().manual_seed(2))
    step = resvit_steps.make_train_step(
        cfg, tx, resvit_steps.Lambdas(1.0, 10.0, 1.0), mesh=mesh)
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.uniform(-1, 1, (BATCH, 32, 32, 3))
                              .astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 7, BATCH))
    metrics = []
    for i in range(STEPS):
        state, m = step(state, images, labels,
                        noise=resvit_noise(cfg, BATCH, seed=10 + i))
        metrics.append({k: v.detach().clone() for k, v in m.items()})
    return {"metrics": metrics, "params": _detach(state.params)}


def cli_args(batch, extra=()):
    """The CLIs' flags at the D 128 preset (injected as "tiny"): 20
    Synthetic images of 32 px, fp32, both fused halves."""
    return ["--model-arch", "tiny", "--image-size", "32", "--dataset",
            "Synthetic", "--synthetic-samples", "20", "--batch-size",
            str(batch), "--num-workers", "0", "--seed", "0", "--num-classes",
            "10", "--dtype", "float32", "--fused-qkv", "--fused-mlp",
            *extra]


def eval_cli_run(extra=()):
    """eval_cli in batches of 4 (5 batches) and of 8 (the third padded with
    4 rows of weight 0): its metrics."""
    from vitax_torch import eval_cli
    tconf.ARCH_PRESETS["tiny"] = PRESET
    return {bs: eval_cli.main(cli_args(bs, extra), device="cpu")
            for bs in (4, 8)}


def train_cli_run(tmp, extra=()):
    """train_cli at batch 4 for 5 steps (one epoch) and its validation:
    the losses of every step and the validation metrics; rank 0 writes the
    checkpoint under tmp."""
    from vitax_torch import train_cli
    tconf.ARCH_PRESETS["tiny"] = PRESET
    out = train_cli.main(cli_args(4, [
        "--train-steps", "5", "--warmup-steps", "2", "--lr", "0.05", "--wd",
        "0", "--exp-root", os.path.join(tmp, "exp"), *extra]), device="cpu")
    epoch = out["epochs"][0]
    return {"losses": epoch["train"]["losses"], "valid": epoch["valid"],
            "checkpoint_dir": out["checkpoint_dir"]}


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_detach(v) for v in tree]
    return tree.detach().clone() if torch.is_tensor(tree) else tree


SCENARIOS = {
    "tp": lambda tmp: {
        "wrappers": tp_wrappers(make_mesh(1, 2)),
        "vit": vit_sgd_steps(make_mesh(1, 2)),
        "steps": tp_step_cases(make_mesh(1, 2)),
        "train_cli": train_cli_run(tmp, ["--n-gpu", "2", "--n-model", "2"]),
        "train_cli_tiers": {
            flag: train_cli_run(os.path.join(tmp, flag.strip("-")), [
                "--n-gpu", "2", "--n-model", "2", flag])
            for flag in ("--int8", "--int8-grad", "--int4", "--int4-attn")},
    },
    "dp": lambda tmp: {
        "vit": vit_sgd_steps(make_mesh(2, 1)),
        "resvit": resvit_adamw_steps(make_mesh(2, 1)),
        "resvit_compact": resvit_adamw_steps(make_mesh(2, 1), compact=0.625),
        "eval_cli": eval_cli_run(["--n-gpu", "2"]),
        "train_cli": train_cli_run(tmp, ["--n-gpu", "2"]),
    },
}


def entry(rank, world, init_file, scenario, tmp):
    """One process of a gloo world: join it, run the scenario, save what it
    returns to tmp/<scenario>_rank<rank>.pt."""
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        out = SCENARIOS[scenario](tmp)
        torch.save(out, os.path.join(tmp, f"{scenario}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
