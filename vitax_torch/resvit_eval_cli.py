"""Residual-ViT evaluation CLI — the port's counterpart of
vitax/resvit_eval_cli.py.

Builds a Res-ViT from an arch preset and the reference's model flags (random
weights from `--seed`, or a checkpoint directory of the port's store), runs
the val split with argmax routing and reports top-1/top-5, the loss, the
active ratio and the router entropy, means over the real samples of a padded
final batch, and the img/s. With `--compact-capacity C` the routed layers
run only ceil(C·N) tokens: on the card through the fused kernels (K1/K3 on
the plain layer, K8 on the routed ones' query rows, K7 with GQA, K7's int8
tier with GQA and `--int8`), or with `--legacy-compact` (or the fused
kernels off: `--no-fused-qkv`) the reference-shaped `apply_compact`, whose
plain layers take K13, the standalone attention core, as the dense
`--no-fused-qkv` model does in every layer. It runs on the card unless the
caller of `main` asks for the CPU (`device="cpu"`); `--no-pallas
--no-fused-qkv` is the plain path.

Run: `python -m vitax_torch.resvit_eval_cli --dataset Synthetic \\
          --model-arch b16 --image-size 224 --batch-size 64 --use_lora True \\
          --lora_rank 48 --use_reslr True --block_size 4 \\
          --dynamic_start_layer 1 --dynamic_reserve_initials 2 \\
          --dynamic_active_target 0.4 --compact-capacity 0.625`
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from vitax_torch import cli
from vitax_torch.checkpointing.store import CheckpointStore
from vitax_torch.core.config import num_classes_for_dataset
from vitax_torch.core.prng import set_seed
from vitax_torch.data import get_dataloader
from vitax_torch.models import resvit
from vitax_torch.models.resvit_compact import apply_compact
from vitax_torch.resvit_train_cli import ARCHES, DATASETS, config_to_model_args
from vitax_torch.train.resvit_steps import _metrics, make_eval_step, weighted_nll


def get_eval_config(argv=None):
    p = argparse.ArgumentParser("vitax res-vit eval")
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
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--n_gpu", type=int, default=1)
    # model args (same underscore surface as training)
    p.add_argument("--use_lora", type=lambda s: s != "False", default=True)
    p.add_argument("--use_reslr", type=lambda s: s != "False", default=True)
    p.add_argument("--dynamic_active_target", type=float, default=0.6)
    # None = follow the arch preset (12 for b16, 16 for l16/h14)
    p.add_argument("--n_heads", type=int, default=None)
    p.add_argument("--n_kv_heads", type=int, default=None)
    p.add_argument("--norm_eps", type=float, default=1e-5)
    p.add_argument("--lora_rank", type=int, default=8)
    p.add_argument("--dynamic_start_layer", type=int, default=2)
    p.add_argument("--dynamic_router_hdim", type=int, default=512)
    p.add_argument("--dynamic_reserve_initials", type=int, default=1)
    p.add_argument("--low_rank_dim", type=int, default=256)
    p.add_argument("--block_size", type=int, default=1)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--no-pallas", action="store_true",
                   help="disable the hand-written kernels (plain PyTorch ops)")
    p.add_argument("--synthetic-samples", type=int, default=512)
    p.add_argument("--fused-qkv", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="fused LN+QKV+attention+out-proj kernel (default: "
                        "on when running on CUDA)")
    p.add_argument("--int8", action="store_true",
                   help="W8A8 int8 projections in the fused kernels")
    p.add_argument("--compact-capacity", type=float, default=None,
                   help="token-compaction inference with this kept fraction "
                        "(e.g. 0.5); exact when it covers the active ratio")
    p.add_argument("--legacy-compact", action="store_true",
                   help="use the reference-shaped apply_compact instead of "
                        "the fused-kernel compact path (A/B)")
    p.add_argument("--compact-overflow", type=str, default="demote",
                   choices=["demote", "identity"],
                   help="overflowing active tokens take the low-rank "
                        "approximator path (demote, default) or stay "
                        "identity (the legacy apply_compact semantics)")
    cfg = p.parse_args(argv)
    cfg.num_classes = num_classes_for_dataset(cfg.dataset)
    return cfg


def make_compact_step(cfg, config):
    """The eval step of `--compact-capacity` (vitax's _compact_step): the
    fused compact path (`resvit.apply` with compact_capacity) when the fused
    attention kernels are on and `--legacy-compact` is not given, else
    `apply_compact`; the plain class loss over the real samples."""
    use_modern = (cfg.fused_qkv and cfg.fused_qkvo
                  and not config.legacy_compact)
    ccfg = cfg.replace(
        compact_capacity=config.compact_capacity,
        compact_demote_overflow=config.compact_overflow != "identity")

    @torch.inference_mode()
    def step_fn(params, images, labels, weight):
        if use_modern:
            logits, aux = resvit.apply(params, images, ccfg, train=False)
        else:
            logits, aux = apply_compact(params, images, cfg,
                                        capacity=config.compact_capacity)
        zero = torch.zeros((), device=logits.device)
        c = weighted_nll(logits, labels, weight)
        m = _metrics(cfg, logits, labels, c, zero, zero, aux, weight=weight)
        m["loss"] = c
        return m, aux["routing_maps"]

    return step_fn


def main(argv=None, device=None):
    """`device`: None for the card (raises without one), or "cpu"."""
    config = get_eval_config(argv)
    cli.print_config(config)
    # --n_gpu is parsed and not read, as vitax's (vitax/resvit_eval_cli.py:
    # 48): this CLI builds no mesh
    gen = set_seed(config.seed)
    device = cli.resolve_device(device)
    cfg = config_to_model_args(config, device)
    params = resvit.init_params(gen, cfg, device)

    if config.checkpoint_path:
        path = config.checkpoint_path
        if not os.path.isdir(path):
            raise NotImplementedError(
                f"{path}: the reference's .pth files do not load in the port "
                "yet (ROADMAP Queue 1 item 4); a checkpoint directory of the "
                "port's store does")
        store = CheckpointStore(os.path.dirname(path) or ".")
        params = store.restore_params(os.path.basename(path), params)

    extra = ({"num_samples": config.synthetic_samples}
             if config.dataset == "Synthetic" else {})
    loader = get_dataloader(config.dataset, split="val",
                            data_dir=config.data_dir,
                            image_size=config.image_size,
                            batch_size=config.batch_size,
                            num_workers=config.num_workers, seed=config.seed,
                            **extra)
    if device.type == "cuda" and (cfg.fused_qkv or cfg.fused_mlp
                                  or cfg.use_pallas is not False):
        from vitax_torch.kernels import build
        build.load()  # set-up: build the kernels before the timed loop

    if config.compact_capacity is not None:
        eval_step = make_compact_step(cfg, config)
    else:
        eval_step = make_eval_step(cfg)

    totals: dict = {}
    n = 0.0
    t0 = time.time()
    for i, batch in enumerate(loader):
        images = torch.from_numpy(batch.images).to(device=device,
                                                   dtype=cfg.dtype)
        labels = torch.from_numpy(batch.labels).to(device)
        weight = torch.from_numpy(batch.weight).to(device)
        metrics, _ = eval_step(params, images, labels, weight)
        bs = float(weight.sum())
        for k, v in metrics.items():
            if v.ndim == 0:
                totals[k] = totals.get(k, 0.0) + float(v) * bs
        n += bs
        if i % 50 == 0:
            print(f"batch {i}/{len(loader)}: "
                  f"acc1={totals.get('acc1', 0) / max(n, 1):.4f}", flush=True)
    dt = time.time() - t0
    result = {k: v / max(n, 1) for k, v in totals.items()}
    print(f"Top-1 accuracy: {result.get('acc1', 0):.4f}")
    print(f"Top-5 accuracy: {result.get('acc5', 0):.4f}")
    print(f"Active ratio:  {result.get('non_low_rank_ratio', 0):.4f}")
    print(f"Router entropy: {result.get('router_entropy', 0):.4f}")
    print(f"({n:.0f} images in {dt:.1f}s, {n / dt:.0f} img/s)")
    return result


if __name__ == "__main__":
    main()
