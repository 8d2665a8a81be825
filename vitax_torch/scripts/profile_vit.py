"""Where a ViT serving forward, or a train step, spends its time on one CUDA
card.

    python -m vitax_torch.scripts.profile_vit [config ...]

Configs, each at full width with random weights from seed 0 and one
resident batch of Synthetic images: `h14-eval` (ViT-H/14 forward at 384
px, spq 736, b32: K6 and K2), `h14-train` (ViT-H/14 train step at 224, spq
264, b32: forward, backward with K2's on the d > 1024 route, SGD with
momentum), `b16-train` (ViT-B/16 train step at 224, b32: K1 and K2),
`b16-train-int8grad` (the same step with `--int8-grad`: K3's and K4's
int8 forwards and their int8 backwards, bf16 weight grads),
`b16-train-int8dw` (with `--int8-dw`: the same with the int8 weight
grads), `b16-train-int4` (`--int4-attn --int4-grad --int8-dw`: K11's four
kernels, all but K11-A on K3's and K4's Hopper sequences at L = 7),
`b16-train-fast` (the fast recipe's drop-phase step,
scripts/FT_CIFAR100_fast.sh: `--int8-dw` at b768 keep 0.5, spq 104, K5's
halves forward), `b16-eval` (ViT-B/16 serving forward at 224, b64) and
`b16-eval-int8` (the same with `--int8`: K3's and K4's int8 forwards);
default: all nine.
For each it runs two warm-up iterations, records three with torch.profiler
and prints, as `profile_resvit` does, the wall time an iteration, the
device busy time and idle share, the device time by group of kernels and
the largest kernels.
"""

from __future__ import annotations

import sys

import torch

from vitax_torch.core.config import arch_config
from vitax_torch.core.prng import set_seed
from vitax_torch.data import get_dataloader
from vitax_torch.models import vit
from vitax_torch.scripts.profile_resvit import _profiled, report
from vitax_torch.train import (create_train_state, make_train_step,
                               sgd_momentum)

INT8_DW = dict(int8_mlp=True, int8_attn=True, int8_mlp_grad=True,
               int8_attn_grad=True, int8_dw=True)
# config -> (arch, image size, train, batch, tier flags)
CONFIGS = {"h14-eval": ("h14", 384, False, 32, {}),
           "h14-train": ("h14", 224, True, 32, {}),
           "b16-train": ("b16", 224, True, 32, {}),
           "b16-train-int8grad": ("b16", 224, True, 32,
                                  dict(INT8_DW, int8_dw=False)),
           "b16-train-int8dw": ("b16", 224, True, 32, INT8_DW),
           "b16-train-int4": ("b16", 224, True, 32,
                              dict(INT8_DW, int4_mlp=True, int4_attn=True,
                                   int4_grad=True)),
           "b16-train-fast": ("b16", 224, True, 768,
                              dict(INT8_DW, token_keep=0.5)),
           "b16-eval": ("b16", 224, False, 64, {}),
           "b16-eval-int8": ("b16", 224, False, 64,
                             dict(int8_mlp=True, int8_attn=True))}


def profile(name: str, iters: int = 3) -> None:
    arch, image, train, batch_size, flags = CONFIGS[name]
    cfg = arch_config(arch, image_size=image, num_classes=10,
                      dtype=torch.bfloat16, fused_qkv=True, fused_mlp=True,
                      **flags)
    params = vit.init_params(set_seed(0), cfg, "cuda")
    batch = next(iter(get_dataloader(
        "Synthetic", split="train" if train else "val", image_size=image,
        batch_size=batch_size, num_samples=batch_size, seed=0)))
    images = torch.from_numpy(batch.images).cuda().bfloat16()
    if train:
        labels = torch.from_numpy(batch.labels).cuda()
        opt, sched = sgd_momentum(params, 0.03, 1000, 0.1)
        state = create_train_state(params, opt, sched, torch.Generator())
        step = make_train_step(cfg, opt, sched)
        prof, wall = _profiled(lambda: step(state, images, labels), iters)
        report(f"{name} b{batch_size}", prof, wall, iters, "a step")
        return
    with torch.inference_mode():
        prof, wall = _profiled(lambda: vit.apply(params, images, cfg), iters)
    report(f"{name} b{batch_size}", prof, wall, iters, "a forward")


def main(argv=None) -> None:
    names = (argv if argv is not None else sys.argv[1:]) or list(CONFIGS)
    unknown = set(names) - set(CONFIGS)
    if unknown:
        raise SystemExit(f"profile_vit: unknown configs {sorted(unknown)}; "
                         f"choose from {list(CONFIGS)}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_vit: needs a CUDA card")
    print(f"profile_vit: {torch.cuda.get_device_name(0)}", flush=True)
    for name in names:
        profile(name)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
