"""Residual-ViT fine-tune CLI (counterpart of vitax/resvit_train_cli.py,
itself the reference's res-vit/train.py).

The same flag surface as vitax's (the reference's, res-vit/config.py:122-184,
with their hyphen/underscore quirks: `--use_lora` but `--batch-size`), so a
command line means the same run in both packages; `config_to_model_args`
turns it into a `ResViTConfig` (the eval CLI takes its model arguments from
here, as vitax's does). `main` trains as vitax's: AdamW with warmup-cosine
(or cosine annealing per epoch), total = λc·c + λa·a + λd·d, clip 1.0, the
LoRA freeze of the base weights, `--compact-warmup` and the capacity anneal
(another config for a step), the token-keep schedule, the partial-batch
skip, weighted validation with routing-viz PNGs, current/best checkpoints of
the port's store per epoch, and the reference's JSON diagnostics
(model_structure.json, weight_mapping_log.json,
trainable_weights_info.json). On the card the attention halves run K1 (K7
with GQA, K3 with `--int8`, K7's int8 tier with both, K11-C with
`--int4-attn`, G-F with it and GQA), K8 on compacted rows (R-F with
`--int4-attn`), each with its backward kernel as vitax's dispatch picks it;
with `--no-fused-qkv` the LN kernel, plain projections and K13 (the
standalone attention core) with its backward. The int4 flags print vitax's
warning (it measured Res-ViT training with them divergent) and run. It runs
on the card unless the caller asks for the CPU (`main(argv,
device="cpu")`).

Not ported yet, each raising with its item: `--checkpoint-path` (the
pretrained backbone, ROADMAP Queue 1 item 4), `--remat` (item 6).

Run: `python -m vitax_torch.resvit_train_cli --dataset Synthetic \\
          --model-arch b16 --image-size 224 --batch-size 32 --use_lora True \\
          --lora_rank 48 --use_reslr True --block_size 4 \\
          --dynamic_start_layer 1 --dynamic_reserve_initials 2 \\
          --dynamic_active_target 0.4 --initial-lambda-active 10 \\
          --initial-lambda-distill 1 --train-steps 100 --warmup-steps 10`
"""

from __future__ import annotations

import argparse
import time

import torch

from vitax_torch import cli
from vitax_torch.checkpointing.store import CheckpointStore
from vitax_torch.core.config import num_classes_for_dataset, resvit_arch_config
from vitax_torch.core.prng import set_seed
from vitax_torch.data import get_dataloader
from vitax_torch.models import resvit
from vitax_torch.train.optim import tree_leaves
from vitax_torch.train.resvit_steps import (Lambdas, create_state,
                                            make_adamw_for, make_eval_step,
                                            make_train_step)
from vitax_torch.train.schedules import (cosine_annealing_lr,
                                         cosine_with_warmup_lr,
                                         token_keep_switch_epoch)
from vitax_torch.utils.experiment import process_config, write_json
from vitax_torch.utils.memory import named_leaves, tree_bytes
from vitax_torch.utils.routing_viz import save_routing_visualization
from vitax_torch.utils.writers import ExperimentWriter

DATASETS = ["CIFAR10", "CIFAR100", "ImageNet", "TinyImageNet", "Synthetic"]
ARCHES = ["tiny", "b16", "b32", "l16", "l32", "h14"]


def get_train_config(argv=None):
    p = argparse.ArgumentParser("vitax res-vit train")
    p.add_argument("--exp-name", type=str, default="reslr")
    p.add_argument("--swanlab", action="store_true")
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--model-arch", type=str, default="b16", choices=ARCHES)
    p.add_argument("--checkpoint-path", type=str, default=None)
    p.add_argument("--image-size", type=int, default=224,
                   choices=[32, 64, 224, 384])
    p.add_argument("--num-workers", type=int, default=1)
    p.add_argument("--data-dir", type=str, default="data")
    p.add_argument("--dataset", type=str, default="CIFAR100",
                   choices=DATASETS)
    p.add_argument("--patch-size", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--train-steps", type=int, default=15000)
    p.add_argument("--warmup-steps", type=int, default=500)
    p.add_argument("--print-freq", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    # optimizer (res-vit/config.py:146-156)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--wd", type=float, default=0.05)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.999)
    p.add_argument("--eps", type=float, default=1e-8)
    p.add_argument("--lr-scheduler", type=str, default="cosine_with_warmup",
                   choices=["cosine", "cosine_with_warmup"])
    p.add_argument("--min-lr", type=float, default=1e-6)
    p.add_argument("--clip-grad-norm", type=lambda s: s != "False",
                   default=True)
    # lora / reslr (the reference's underscore flags kept verbatim)
    p.add_argument("--use_lora", type=lambda s: s != "False", default=True)
    p.add_argument("--use_reslr", type=lambda s: s != "False", default=True)
    p.add_argument("--initial-lambda-active", type=float, default=1e-4)
    p.add_argument("--initial-lambda-distill", type=float, default=0.01)
    p.add_argument("--initial-lambda-class", type=float, default=1.0)
    p.add_argument("--dynamic_active_target", type=float, default=0.6)
    # None = follow the arch preset (12 for b16, 16 for l16/h14, 3 for tiny)
    p.add_argument("--n_heads", type=int, default=None)
    p.add_argument("--n_kv_heads", type=int, default=None)
    p.add_argument("--norm_eps", type=float, default=1e-5)
    p.add_argument("--lora_rank", type=int, default=8)
    p.add_argument("--dynamic_start_layer", type=int, default=2)
    p.add_argument("--dynamic_router_hdim", type=int, default=512)
    p.add_argument("--dynamic_reserve_initials", type=int, default=1)
    p.add_argument("--low_rank_dim", type=int, default=256)
    p.add_argument("--block_size", type=int, default=1)
    p.add_argument("--save-routing-viz", action="store_true")
    # vitax extras
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--no-pallas", action="store_true",
                   help="disable the hand-written kernels (plain PyTorch ops)")
    p.add_argument("--fused-qkv", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="fused LN+QKV+attention+out-proj kernel (LoRA folds "
                        "in exactly; default: on when running on CUDA)")
    p.add_argument("--fused-mlp", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="fused LN+fc1+GELU+fc2 kernel for the feed-forward "
                        "half (default: on on CUDA with the int8 tiers)")
    p.add_argument("--int8", action="store_true",
                   help="W8A8 int8 projections in the fused kernels")
    p.add_argument("--int8-grad", action="store_true",
                   help="int8 dL/dx-path backward (implies --int8)")
    p.add_argument("--int8-dw", action="store_true",
                   help="per-block int8 dW matmuls in the MLP and attention "
                        "backwards (implies --int8-grad)")
    p.add_argument("--int4", action="store_true",
                   help="A4W4 int4 MLP forward matmuls (implies --int8)")
    p.add_argument("--int4-attn", action="store_true",
                   help="A4W4 int4 qkv/out-projection forward matmuls too "
                        "(implies --int4)")
    p.add_argument("--int4-grad", action="store_true",
                   help="A4W4 int4 backward dx-path matmuls in the fused "
                        "MLP too (implies --int4)")
    p.add_argument("--save-acts", action="store_true",
                   help="persist (quantized) GELU activations in the fused "
                        "MLP forward; backward skips the fc1 recompute")
    p.add_argument("--compact-warmup", type=int, default=500,
                   help="with --compact-capacity: train without compaction "
                        "for this many steps first")
    p.add_argument("--token-keep", type=float, default=1.0,
                   help="PatchDropout/FLIP train-time token dropping: keep "
                        "cls + a random round(r*num_patches) patch subset "
                        "per image per step")
    p.add_argument("--token-keep-schedule", type=float, default=None,
                   metavar="FRAC",
                   help="train with --token-keep for the first FRAC of "
                        "epochs, then full-sequence for the rest")
    p.add_argument("--compact-capacity", type=float, default=None,
                   help="token compaction: the routed layers run only the "
                        "top-ceil(C*N) tokens ranked active first")
    p.add_argument("--router-lr-scale", type=float, default=1.0,
                   help="scale the router params' effective learning rate "
                        "(post-Adam masked update scaling)")
    p.add_argument("--compact-capacity-start", type=float, default=None,
                   metavar="C_HI",
                   help="run the first --compact-capacity-anneal steps at "
                        "this higher capacity")
    p.add_argument("--compact-capacity-anneal", type=int, default=0,
                   metavar="STEPS",
                   help="steps spent at --compact-capacity-start")
    p.add_argument("--compact-overflow", type=str, default="demote",
                   choices=["demote", "identity"],
                   help="overflowing active tokens take the low-rank "
                        "approximator path (demote) or stay identity")
    p.add_argument("--remat", type=str, nargs="?", const="full",
                   default=None, choices=["none", "full", "selective"],
                   help="block rematerialization (default: none)")
    p.add_argument("--scan-layers", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="scan over blocks with pre-stacked params")
    p.add_argument("--exp-root", type=str, default="experiments")
    p.add_argument("--synthetic-samples", type=int, default=512)
    cfg = p.parse_args(argv)
    cfg.num_classes = num_classes_for_dataset(cfg.dataset)
    return process_config(cfg, root=cfg.exp_root)


def config_to_model_args(c, device) -> "resvit_arch_config":
    """res-vit/config.py:68-96 equivalent: argparse config → ResViTConfig.

    vitax's defaults, with its "on the TPU" read as "on the card" (`device`
    is CUDA): the fused QKV kernel on (and with it the LN/out-projection
    fusion, `fused_qkvo = fused_qkv`), the fused MLP kernel on exactly when
    int8 is (the bf16 fused MLP measured slower for Res-ViT in vitax), no
    remat. `--int8-grad` implies `--int8`, `--int8-dw` `--int8-grad`."""
    dtype = torch.bfloat16 if c.dtype == "bfloat16" else torch.float32
    on_card = torch.device(device).type == "cuda"
    fused_qkv = getattr(c, "fused_qkv", None)
    if fused_qkv is None:
        fused_qkv = on_card
    int8_dw = getattr(c, "int8_dw", False)
    int8_grad = getattr(c, "int8_grad", False) or int8_dw
    int4_attn = getattr(c, "int4_attn", False)
    int4_grad = getattr(c, "int4_grad", False)
    int4 = getattr(c, "int4", False) or int4_attn or int4_grad
    int8 = getattr(c, "int8", False) or int8_grad or int4
    fused_mlp = getattr(c, "fused_mlp", None)
    if fused_mlp is None:
        fused_mlp = on_card and int8
    remat = getattr(c, "remat", None)
    if remat is None:
        remat = "none"
    remat = {"none": False, "full": True}.get(remat, remat)
    head_kw = {}
    if c.n_heads is not None:
        head_kw["n_heads"] = c.n_heads
    if c.n_kv_heads is not None or c.n_heads is not None:
        head_kw["n_kv_heads"] = (c.n_kv_heads if c.n_kv_heads is not None
                                 else c.n_heads)
    return resvit_arch_config(
        c.model_arch, image_size=c.image_size, num_classes=c.num_classes,
        **head_kw, norm_eps=c.norm_eps, lora_rank=c.lora_rank,
        dynamic_active_target=c.dynamic_active_target,
        dynamic_start_layer=c.dynamic_start_layer,
        dynamic_router_hdim=c.dynamic_router_hdim,
        dynamic_reserve_initials=c.dynamic_reserve_initials,
        low_rank_dim=c.low_rank_dim, block_size=c.block_size,
        use_lora=c.use_lora, use_reslr=c.use_reslr,
        dtype=dtype, fused_qkv=fused_qkv, fused_qkvo=fused_qkv,
        fused_mlp=fused_mlp, remat=remat,
        int8_attn=int8, int8_attn_grad=int8_grad,
        int8_mlp=int8, int8_mlp_grad=int8_grad, int8_dw=int8_dw,
        int4_mlp=int4, int4_attn=int4_attn, int4_grad=int4_grad,
        fused_mlp_save=getattr(c, "save_acts", False),
        compact_capacity=getattr(c, "compact_capacity", None),
        token_keep=getattr(c, "token_keep", 1.0),
        compact_demote_overflow=(getattr(c, "compact_overflow", "demote")
                                 != "identity"),
        use_pallas=False if c.no_pallas else None)


def _structure_report(params) -> dict:
    """{path: {shape, dtype}} of every leaf, vitax's keys and numpy dtype
    names."""
    return {path: {"shape": list(t.shape),
                   "dtype": str(t.dtype).replace("torch.", "")}
            for path, t in named_leaves(params)}


def _reject_unported(config) -> None:
    if config.checkpoint_path:
        raise NotImplementedError(
            f"{config.checkpoint_path}: the pretrained-backbone load (.pth "
            "reader, resvit_params_from_vit) is not ported yet (ROADMAP Queue "
            "1 item 4); train from random init")
    if config.remat not in (None, "none"):
        raise NotImplementedError(
            f"--remat {config.remat}: block rematerialization is not ported "
            "(ROADMAP Queue 1 item 6)")


def main(argv=None, device=None):
    """`device`: None for the card (raises without one), or "cpu". Returns
    {"best_acc", "epochs": per-epoch validation metrics, "plan": the config
    each step ran ((epoch, compact_capacity, token_keep) a step),
    "checkpoint_dir", "result_dir", "state"}."""
    config = get_train_config(argv)
    cli.print_config(config)
    _reject_unported(config)
    gen = set_seed(config.seed)
    device = cli.resolve_device(device)
    cfg = config_to_model_args(config, device)
    if cfg.int4_mlp or cfg.int4_attn or cfg.int4_grad:
        print("WARNING: the int4 tiers MEASURED DIVERGENT for routed "
              "(res-vit) training — held-out accuracy flat-lines on the "
              "convergence harness with or without compaction (PERF.md "
              "'int4 x res-vit' section). They are validated for plain-ViT "
              "training only; use the int8 tiers for res-vit recipes.")
    params = resvit.init_params(gen, cfg, device)

    # JSON diagnostics (res-vit/utils.py:182-205,440-441,445-485)
    report = _structure_report(params)
    write_json(report, f"{config.result_dir}/model_structure.json")
    write_json({}, f"{config.result_dir}/weight_mapping_log.json")
    mask = tree_leaves(resvit.trainable_mask(params, cfg))
    leaves = [t for _, t in named_leaves(params)]
    write_json({
        "trainable": [k for k, m in zip(report, mask) if m],
        "frozen": [k for k, m in zip(report, mask) if not m],
        "trainable_bytes": int(sum(t.numel() * 4
                                   for t, m in zip(leaves, mask) if m)),
        "total_bytes": int(tree_bytes(params)),
    }, f"{config.result_dir}/trainable_weights_info.json")

    common = dict(data_dir=config.data_dir, image_size=config.image_size,
                  batch_size=config.batch_size,
                  num_workers=config.num_workers, seed=config.seed)
    if config.dataset == "Synthetic":
        common["num_samples"] = config.synthetic_samples
    train_loader = get_dataloader(config.dataset, split="train", **common)
    valid_loader = get_dataloader(config.dataset, split="val", **common)

    steps_per_epoch = max(1, len(train_loader))
    epochs = max(1, config.train_steps // steps_per_epoch)
    if config.lr_scheduler == "cosine_with_warmup":
        lr_sched = cosine_with_warmup_lr(config.lr, config.warmup_steps,
                                         config.train_steps)
    else:  # CosineAnnealingLR stepped per epoch (res-vit/train.py:287-291)
        inner = cosine_annealing_lr(config.lr, epochs, eta_min=config.min_lr)
        lr_sched = lambda step: inner(step // steps_per_epoch)  # noqa: E731

    if config.scan_layers and resvit._scan_eligible(cfg):
        params = resvit.stack_params(params, cfg)
    tx = make_adamw_for(cfg, params, lr_sched,
                        router_lr_scale=config.router_lr_scale,
                        betas=(config.beta1, config.beta2), eps=config.eps,
                        weight_decay=config.wd,
                        clip_grad_norm=1.0 if config.clip_grad_norm else None)
    state = create_state(params, tx, torch.Generator(device=device)
                         .manual_seed(config.seed + 7))
    lambdas = Lambdas(classification=config.initial_lambda_class,
                      active=config.initial_lambda_active,
                      distill=config.initial_lambda_distill)

    # the step's config: the token-keep schedule's dense tail, the dense
    # --compact-warmup, the --compact-capacity-start slack phase; each is
    # another config for the same parameters and optimizer
    steps = {"main": cfg}
    dense_from_epoch = token_keep_switch_epoch(config.token_keep_schedule,
                                               cfg.token_keep, epochs)
    if dense_from_epoch < epochs:
        steps["dense"] = cfg.replace(token_keep=1.0)
        print(f"token-keep schedule: keep {cfg.token_keep} for epochs "
              f"0..{dense_from_epoch - 1}, dense from epoch "
              f"{dense_from_epoch}")
    compact_warmup = config.compact_warmup or 0
    if cfg.compact_capacity is not None and compact_warmup > 0:
        steps["warm"] = cfg.replace(compact_capacity=None)
    cap_anneal_until = 0
    cap_hi = config.compact_capacity_start
    if (cfg.compact_capacity is not None and cap_hi
            and config.compact_capacity_anneal > 0):
        if cap_hi < cfg.compact_capacity:
            raise ValueError("--compact-capacity-start must be >= "
                             "--compact-capacity (it is the slack phase)")
        steps["hi"] = cfg.replace(compact_capacity=cap_hi)
        cap_anneal_until = compact_warmup + config.compact_capacity_anneal
        print(f"capacity anneal: C={cap_hi} for steps "
              f"{compact_warmup}..{cap_anneal_until - 1}, then "
              f"C={cfg.compact_capacity}")
    step_fns = {k: make_train_step(c, tx, lambdas) for k, c in steps.items()}
    eval_step = make_eval_step(cfg, lambdas)

    if device.type == "cuda" and (cfg.fused_qkv or cfg.fused_mlp
                                  or cfg.use_pallas is not False):
        from vitax_torch.kernels import build
        build.load()  # set-up: build the kernels before the timed loop

    writer = ExperimentWriter(
        config.summary_dir,
        backend=("swanlab" if config.swanlab else
                 "tensorboard" if config.tensorboard else "none"),
        project=f"vit-{config.dataset}", exp_name=config.exp_name)
    store = CheckpointStore(config.checkpoint_dir)

    best_acc = 0.0
    steps_done = 0
    plan, history = [], []
    print(f"training {epochs} epochs x {steps_per_epoch} steps")
    for epoch in range(epochs):
        train_loader.set_epoch(epoch)
        t0 = time.time()
        for i, batch in enumerate(train_loader):
            if batch.weight.sum() < len(batch.weight):
                continue  # partial batches are skipped, as vitax's loop
            images = torch.from_numpy(batch.images).to(device=device,
                                                       dtype=cfg.dtype)
            labels = torch.from_numpy(batch.labels).to(device)
            key = "main"
            if "warm" in steps and steps_done < compact_warmup:
                key = "warm"
            elif "hi" in steps and steps_done < cap_anneal_until:
                key = "hi"
            if "dense" in steps and epoch >= dense_from_epoch:
                key = "dense"
            state, metrics = step_fns[key](state, images, labels)
            plan.append((epoch, steps[key].compact_capacity,
                         steps[key].token_keep))
            steps_done += 1
            if i % config.print_freq == config.print_freq - 1:
                mh = {k: v.detach().float().cpu().numpy()
                      for k, v in metrics.items()}
                writer.set_step(state.step, "train")
                for k, v in mh.items():
                    if v.ndim == 0:
                        writer.add_scalar(k, float(v))
                writer.add_scalars("layer_activation_rates", {
                    f"layer_{j}": float(v) for j, v in
                    enumerate(mh["layer_activation_rates"])})
                rate = (i + 1) * len(batch.weight) / (time.time() - t0)
                print(f"epoch {epoch} step {state.step}: "
                      f"loss={float(mh['loss']):.4f} "
                      f"c={float(mh['c_loss']):.4f} "
                      f"a={float(mh['a_loss']):.6f} "
                      f"d={float(mh['d_loss']):.4f} "
                      f"H={float(mh['router_entropy']):.4f} "
                      f"active={float(mh['non_low_rank_ratio']):.3f} "
                      f"acc1={float(mh['acc1']):.3f} ({rate:.0f} img/s)",
                      flush=True)

        # validation (res-vit/train.py:321-341), means over the real rows
        totals: dict = {}
        n = 0.0
        viz_done = not config.save_routing_viz
        eval_params = resvit.unstack_params(state.params)
        for batch in valid_loader:
            images = torch.from_numpy(batch.images).to(device=device,
                                                       dtype=cfg.dtype)
            labels = torch.from_numpy(batch.labels).to(device)
            weight = torch.from_numpy(batch.weight).to(device)
            metrics, routing_maps = eval_step(eval_params, images, labels,
                                              weight)
            bs = float(weight.sum())
            for k, v in metrics.items():
                if v.ndim == 0:
                    totals[k] = totals.get(k, 0.0) + float(v) * bs
            n += bs
            if not viz_done and routing_maps:
                save_routing_visualization(
                    batch.images, {k: v.float().cpu().numpy()
                                   for k, v in routing_maps.items()},
                    epoch, f"{config.result_dir}/routing_viz",
                    patch_size=config.patch_size,
                    reserve_initials=config.dynamic_reserve_initials)
                viz_done = True
        vr = {k: v / max(n, 1) for k, v in totals.items()}
        writer.set_step(state.step, "valid")
        for k, v in vr.items():
            writer.add_scalar(k, v)
        print(f"epoch {epoch} valid: "
              + " ".join(f"{k}={v:.4f}" for k, v in sorted(vr.items())),
              flush=True)

        is_best = vr.get("acc1", 0.0) > best_acc
        best_acc = max(best_acc, vr.get("acc1", 0.0))
        store.save_model(state, epoch, is_best=is_best,
                         metrics={"best_acc": best_acc, **vr})
        history.append(vr)
    writer.close()
    print(f"done; best acc1 = {best_acc:.4f}")
    return {"best_acc": best_acc, "epochs": history, "plan": plan,
            "checkpoint_dir": config.checkpoint_dir,
            "result_dir": config.result_dir, "state": state}


if __name__ == "__main__":
    main()
