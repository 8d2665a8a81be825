"""Argparse front-ends, flag for flag those of vitax/cli.py.

The parsed namespaces equal vitax's (names, defaults, choices), so a command
line means the same run in both packages. In the port, `--no-pallas` turns
the hand-written CUDA kernels off (plain PyTorch ops), `--fused-qkv` /
`--fused-mlp` default on when the device is CUDA, and `--n-gpu` is the number
of cards (0 or 1 until data-parallel eval is ported). Flags of tiers the port
has not ported yet are parsed and rejected where they would take effect.
"""

from __future__ import annotations

import argparse

from vitax_torch.core.config import num_classes_for_dataset
from vitax_torch.utils.experiment import process_config

ARCHES = ["tiny", "b16", "b32", "l16", "l32", "h14"]
DATASETS = ["CIFAR10", "CIFAR100", "ImageNet", "TinyImageNet", "Synthetic"]


def _add_common(p: argparse.ArgumentParser, train: bool) -> None:
    p.add_argument("--n-gpu", type=int, default=0,
                   help="number of devices to use (0 = all); name kept for "
                        "reference-CLI compatibility")
    p.add_argument("--model-arch", type=str, default="b16", choices=ARCHES)
    p.add_argument("--checkpoint-path", type=str, default=None)
    p.add_argument("--image-size", type=int,
                   default=224 if train else 384, choices=[32, 64, 224, 384])
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--data-dir", type=str, default="data")
    p.add_argument("--dataset", type=str,
                   default="CIFAR10" if train else "ImageNet",
                   choices=DATASETS)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    # vitax extras
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--remat", type=str, nargs="?", const="full",
                   default=None, choices=["none", "full", "selective"],
                   help="encoder-block rematerialization (default: auto — "
                        "'none' when both fused kernels are active, whose "
                        "custom VJPs keep residuals tiny so replay is pure "
                        "waste; 'selective' otherwise). Bare --remat means "
                        "'full' (back-compat)")
    p.add_argument("--no-pallas", action="store_true",
                   help="disable the hand-written kernels (plain PyTorch ops)")
    p.add_argument("--n-model", type=int, default=1,
                   help="tensor-parallel mesh axis size")
    p.add_argument("--synthetic-samples", type=int, default=512,
                   help="sample count for --dataset Synthetic")
    p.add_argument("--fused-qkv", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="fused LN1+QKV+attention+out-proj kernel "
                        "(default: on when running on CUDA; shape-gated)")
    p.add_argument("--fused-mlp", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="fused LN2+fc1+GELU+fc2 kernel (default: on "
                        "when running on CUDA; shape-gated)")
    p.add_argument("--int8", action="store_true",
                   help="W8A8 int8 forward matmuls in the fused kernels "
                        "(bwd stays bf16; accuracy-affecting — see PERF.md "
                        "for the convergence evidence)")
    p.add_argument("--int8-grad", action="store_true",
                   help="SwitchBack int8 dL/dx-path backward matmuls "
                        "(implies --int8; the bench config)")
    p.add_argument("--int4", action="store_true",
                   help="A4W4 int4 MLP forward matmuls (implies --int8 for "
                        "the attention projections; deepest-PRECISION tier, "
                        "~+3%% over int8, wide quantization band — see "
                        "PERF.md before using for real training)")
    p.add_argument("--int4-attn", action="store_true",
                   help="A4W4 int4 qkv/out-projection forward matmuls too "
                        "(implies --int4; the attention core stays bf16)")
    p.add_argument("--int4-grad", action="store_true",
                   help="A4W4 int4 backward dx-path matmuls in the fused "
                        "MLP too (implies --int4; dW stays >=8-bit). "
                        "Deepest gradient tier — see PERF.md before using")
    p.add_argument("--int8-dw", action="store_true",
                   help="Jetfire per-block int8 dW matmuls in the MLP and "
                        "attention backwards (implies --int8-grad; deepest "
                        "tier)")
    p.add_argument("--token-keep", type=float, default=1.0,
                   help="PatchDropout/FLIP train-time token dropping: keep "
                        "this fraction of patch tokens (cls always kept) "
                        "per image per step; eval runs the full sequence. "
                        "1.0 = off. Accuracy-affecting fine-tune lever "
                        "(arXiv:2212.00794) — see PERF.md before using")
    p.add_argument("--token-keep-schedule", type=float, default=None,
                   metavar="FRAC",
                   help="train with --token-keep for the first FRAC of "
                        "epochs, then full-sequence for the rest (the "
                        "PatchDropout fine-tune recipe: dropped training "
                        "+ short dense tail, arXiv:2208.07220 §4.4). "
                        "E.g. --token-keep 0.5 --token-keep-schedule 0.9")
    p.add_argument("--dense-batch-size", type=int, default=None,
                   help="batch size for the dense tail of "
                        "--token-keep-schedule (token dropping halves "
                        "activation memory, so the dropped phase can run "
                        "a larger --batch-size — the FLIP recipe, "
                        "arXiv:2212.00794); default = --batch-size")
    p.add_argument("--save-acts", action="store_true",
                   help="persist GELU activations/derivative in the fused "
                        "MLP forward (int8-quantized under --int8-grad) so "
                        "the backward skips the fc1 recompute and all "
                        "transcendentals")
    p.add_argument("--device-prep", action="store_true",
                   help="ship uint8 batches, normalize/flip on device "
                        "(4x less host->device bandwidth)")


def get_train_config(argv=None):
    p = argparse.ArgumentParser("vitax train")
    p.add_argument("--exp-name", type=str, default="ft")
    p.add_argument("--swanlab", action="store_true")
    p.add_argument("--tensorboard", action="store_true")
    _add_common(p, train=True)
    p.add_argument("--train-steps", type=int, default=10000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--wd", type=float, default=1e-4)
    p.add_argument("--warmup-steps", type=int, default=500)
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint dir to resume full training state from")
    p.add_argument("--export-pth", action="store_true",
                   help="also export best weights as reference-loadable .pth")
    p.add_argument("--exp-root", type=str, default="experiments")
    cfg = p.parse_args(argv)
    if cfg.num_classes is None:
        cfg.num_classes = num_classes_for_dataset(cfg.dataset)
    return process_config(cfg, root=cfg.exp_root)


def get_eval_config(argv=None):
    p = argparse.ArgumentParser("vitax eval")
    _add_common(p, train=False)
    cfg = p.parse_args(argv)
    if cfg.num_classes is None:
        cfg.num_classes = num_classes_for_dataset(cfg.dataset)
    return cfg


def print_config(config) -> None:
    """src/config.py:107-114 behavior."""
    print("----- Configuration -----")
    for k, v in sorted(vars(config).items()):
        print(f"{k}: {v}")
    print("-------------------------")
