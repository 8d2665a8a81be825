"""Residual-ViT fine-tune CLI: its flag surface and the model arguments
(counterpart of vitax/resvit_train_cli.py).

`get_train_config` parses the same flags as vitax's (the reference's,
res-vit/config.py:122-184, with their hyphen/underscore quirks: `--use_lora`
but `--batch-size`), so a command line means the same run in both packages;
`config_to_model_args` turns it into a `ResViTConfig`. The eval CLI
(`resvit_eval_cli`) takes its model arguments from here, as vitax's does.

The training loop itself (`main`) comes with Res-ViT training and raises
until then (ROADMAP Queue 1 item 10).

Run: `python -m vitax_torch.resvit_train_cli --dataset CIFAR100 ...`
"""

from __future__ import annotations

import argparse

import torch

from vitax_torch.core.config import num_classes_for_dataset, resvit_arch_config
from vitax_torch.utils.experiment import process_config

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


def main(argv=None):
    raise NotImplementedError(
        "Res-ViT training (the train step, the Gumbel router, the teacher "
        "path, the K7/K8 backward kernels) is not ported yet: ROADMAP Queue 1 "
        "item 10; vitax_torch.resvit_eval_cli serves Res-ViT")


if __name__ == "__main__":
    main()
