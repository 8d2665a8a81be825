"""Train-time token-compaction convergence on the card: dense against
`compact_capacity` (counterpart of scripts/compact_convergence.py).

    python -m vitax_torch.scripts.compact_convergence

The accuracy evidence for compacted Res-ViT training. The b16 Res-ViT of
scripts/ft_resvit.sh (LoRA rank 48, block size 4 from layer 1, 2 reserved
tokens, active target 0.4) on the full W8A8 tier with int8 weight grads
(`--int8-dw`), random weights from seed 0, trained with the 3-term loss
(λ 1, 10, 1) and AdamW (lr 1e-4, warmup-cosine over 30 steps, clip 1.0) on
a synthetic 10-class task: each image is 0.25·its class's prototype plus
N(0, 1) noise, 8 fixed batches cycled. Every 50 steps it prints the loss,
the held-out top-1 on another batch of the same task, the active ratio and
the largest per-layer activation rate. The same data and seed for dense and
each capacity. Environment knobs, as the JAX script's: CC_STEPS (300),
CC_BATCH (64), CC_CAPS ("0.625,0.5"), CC_WARMUP (dense steps first, 0),
CC_ROUTER_LR (1.0), CC_TOKKEEP (train-time token dropping on the compact
runs), CC_CAP_SCHEDULE ("C_HI@FRAC": the first FRAC of the steps at C_HI).
CC_INT4 ("1": the full int4 tier, int4_mlp, int4_attn and int4_grad;
"fwd": the int4 forwards alone) adds int4 to the compact runs.
"""

from __future__ import annotations

import os
import sys

import torch

from vitax_torch.core.config import resvit_arch_config
from vitax_torch.models import resvit
from vitax_torch.train.resvit_steps import (Lambdas, create_state,
                                            make_adamw_for, make_train_step)
from vitax_torch.train.schedules import cosine_with_warmup_lr

STEPS = int(os.environ.get("CC_STEPS", "300"))
BATCH = int(os.environ.get("CC_BATCH", "64"))


def _cfg(**over):
    return resvit_arch_config(
        "b16", image_size=224, num_classes=10, dtype=torch.bfloat16,
        use_lora=True, use_reslr=True, lora_rank=48,
        dynamic_active_target=0.4, dynamic_start_layer=1,
        dynamic_reserve_initials=2, block_size=4, fused_qkv=True,
        fused_qkvo=True, fused_mlp=True, int8_attn=True, int8_attn_grad=True,
        int8_mlp=True, int8_mlp_grad=True, int8_dw=True, **over)


def _data(dev):
    """8 train batches and one held-out batch of the prototype task, made on
    the card from a seed."""
    g = torch.Generator(device=dev).manual_seed(42)
    protos = torch.randn((10, 224, 224, 3), generator=g, device=dev)

    def batch():
        lab = torch.randint(0, 10, (BATCH,), generator=g, device=dev)
        img = 0.25 * protos[lab] + torch.randn((BATCH, 224, 224, 3),
                                               generator=g, device=dev)
        return img.bfloat16(), lab

    return [batch() for _ in range(8)], batch()


def run(tag, data, compact_warmup=0, cap_schedule=None, **over):
    """One training run; returns (losses, held-out accuracies) every 50
    steps."""
    dev = torch.device("cuda")
    cfg = _cfg(**over)
    params = resvit.init_params(torch.Generator().manual_seed(0), cfg, dev)
    tx = make_adamw_for(cfg, params, cosine_with_warmup_lr(1e-4, 30, STEPS),
                        clip_grad_norm=1.0, router_lr_scale=float(
                            os.environ.get("CC_ROUTER_LR", "1.0")))
    state = create_state(params, tx, torch.Generator(device=dev)
                         .manual_seed(1))
    lam = Lambdas(1.0, 10.0, 1.0)
    step = make_train_step(cfg, tx, lam)
    # the dense warmup and the capacity schedule: other configs of the same
    # parameters and optimizer
    warm_step = hi_step = None
    if compact_warmup and over.get("compact_capacity") is not None:
        warm_step = make_train_step(_cfg(**{**over, "compact_capacity": None}),
                                    tx, lam)
    cap_switch = 0
    if cap_schedule is not None:
        cap_hi, frac = cap_schedule
        cap_switch = int(frac * STEPS)
        hi_step = make_train_step(_cfg(**{**over, "compact_capacity": cap_hi}),
                                  tx, lam)
    batches, (eimg, elab) = data

    @torch.inference_mode()
    def evaluate():
        logits, aux = resvit.apply(state.params, eimg, cfg, train=False)
        acts = aux["acts"].float()
        return ((logits.argmax(-1) == elab).float().mean().item(),
                acts.mean().item(), acts.mean(dim=(0, 1)).max().item())

    losses, eaccs, ratios, maxrates = [], [], [], []
    for s in range(STEPS):
        img, lab = batches[s % 8]
        fn = step
        if warm_step is not None and s < compact_warmup:
            fn = warm_step
        elif hi_step is not None and s < cap_switch:
            fn = hi_step
        state, metrics = fn(state, img, lab)
        if s % 50 == 49:
            losses.append(float(metrics["loss"]))
            a, act, mx = evaluate()
            eaccs.append(a)
            ratios.append(act)
            maxrates.append(mx)
    print(f"{tag}: losses={['%.3f' % v for v in losses]}", flush=True)
    print(f"{tag}: HELD-OUT acc1={['%.3f' % a for a in eaccs]} "
          f"active ratio={['%.3f' % r for r in ratios]} "
          f"max layer rate={['%.3f' % r for r in maxrates]}", flush=True)
    return losses, eaccs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("compact_convergence: needs a CUDA card")
    warmup = int(os.environ.get("CC_WARMUP", "0"))
    caps = tuple(float(c) for c in
                 os.environ.get("CC_CAPS", "0.625,0.5").split(","))
    extra, tag = {}, ""
    cc_int4 = os.environ.get("CC_INT4")
    if cc_int4 == "1":
        extra.update(int4_mlp=True, int4_attn=True, int4_grad=True)
        tag += "-int4"
    elif cc_int4 == "fwd":
        extra.update(int4_mlp=True, int4_attn=True)
        tag += "-int4fwd"
    if os.environ.get("CC_TOKKEEP"):
        extra["token_keep"] = float(os.environ["CC_TOKKEEP"])
        tag += f"-tk{extra['token_keep']}"
    print(f"compact_convergence: {torch.cuda.get_device_name(0)}, {STEPS} "
          f"steps at b{BATCH}", flush=True)
    data = _data(torch.device("cuda"))
    l_d, a_d = run("dense", data)
    sched = os.environ.get("CC_CAP_SCHEDULE")
    if sched:
        hi, frac = sched.split("@")
        for cap in caps:
            run(f"capsched-{hi}to{cap}@{frac}-w{warmup}{tag}", data,
                compact_capacity=cap, compact_warmup=warmup,
                cap_schedule=(float(hi), float(frac)), **extra)
    for cap in caps:
        l_c, a_c = run(f"compact-{cap}-w{warmup}{tag}", data,
                       compact_capacity=cap, compact_warmup=warmup, **extra)
        dl = max(abs(a - b) for a, b in zip(l_d[-3:], l_c[-3:]))
        da = max(abs(a - b) for a, b in zip(a_d[-3:], a_c[-3:]))
        print(f"compact-{cap}-w{warmup} vs dense: final-phase max |loss "
              f"diff| = {dl:.4f}, max |acc diff| = {da:.4f}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
