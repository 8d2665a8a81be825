"""int8 and int4 against bf16 training convergence on one CUDA card: same
data, same seed, 300 steps (counterpart of scripts/int8_convergence.py).

    python -m vitax_torch.scripts.int8_convergence [tag ...]

Accuracy evidence for the W8A8 and A4W4 tiers of the port: ViT-B/16 @224,
batch 128, SGD (momentum 0.9) + OneCycle (max LR 0.01, 10 % warmup), on a fixed
synthetic "dataset" with learnable class structure (8 batches of
0.25·prototype[label] + N(0, 1) noise, drawn with numpy from seed 42) and a
held-out batch of fresh noise. Every 50 steps it records the train loss,
train top-1, held-out top-1 and held-out loss; for each tag after the first
it prints the largest |loss|, |held-out acc| and |held-out loss|
differences from the first tag over the last four records. The task
saturates: held-out top-1 reaches 1.000 within 100 steps in bf16, so it
resolves only gaps of 1/128; the held-out loss keeps a continuous reading
of the gap between tiers after that. Both fused kernels run, forward and backward, with no
rematerialization (vitax's harness ran `remat="selective"` on the XLA path's
terms; the port has no remat, and with both fused kernels vitax's CLIs pick
none either).

Tags: `bf16`, `int8-fwd` (`--int8`: W8A8 forward, bf16 backward),
`int8-full` (`--int8-grad`), `int8-dw` (`--int8-dw`: per-group int8 weight
grads too), and vitax's token-dropping tags on top of `int8-dw`,
`tokdrop-0.5` (1 + 98 tokens, spq 104: the int8 block handoff, K5) and
`tokdrop-0.75` (1 + 147 tokens, spq 152: no handoff); the held-out batch is
full-sequence (the FLIP protocol); and vitax's int4 tags on top of
`int8-dw`, `int4` (A4W4 forwards of both halves, K11-A and K11-C) and
`int4-grad` (their A4W4 dx-path backwards too, K11-B and K11-D). The
default pair is `bf16 int8-full`.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vitax_torch.core.config import arch_config
from vitax_torch.core.prng import set_seed
from vitax_torch.models import vit
from vitax_torch.train import (create_train_state, cross_entropy,
                               make_train_step, sgd_momentum)

STEPS = 300
BATCH = 128
SEED = 42

CONFIGS = {
    "bf16": {},
    "int8-fwd": dict(int8_mlp=True, int8_attn=True),
    "int8-full": dict(int8_mlp=True, int8_attn=True, int8_mlp_grad=True,
                      int8_attn_grad=True),
    "int8-dw": dict(int8_mlp=True, int8_attn=True, int8_mlp_grad=True,
                    int8_attn_grad=True, int8_dw=True),
    "tokdrop-0.5": dict(int8_mlp=True, int8_attn=True, int8_mlp_grad=True,
                        int8_attn_grad=True, int8_dw=True, token_keep=0.5),
    "tokdrop-0.75": dict(int8_mlp=True, int8_attn=True, int8_mlp_grad=True,
                         int8_attn_grad=True, int8_dw=True, token_keep=0.75),
    "int4": dict(int8_mlp=True, int8_attn=True, int8_mlp_grad=True,
                 int8_attn_grad=True, int8_dw=True, int4_mlp=True,
                 int4_attn=True),
    "int4-grad": dict(int8_mlp=True, int8_attn=True, int8_mlp_grad=True,
                      int8_attn_grad=True, int8_dw=True, int4_mlp=True,
                      int4_attn=True, int4_grad=True),
}


def make_data(device, image=224, classes=10):
    """8 train batches and a held-out batch, bf16 images on the device."""
    rng = np.random.default_rng(SEED)
    protos = rng.standard_normal((classes, image, image, 3), np.float32)

    def batch():
        lab = rng.integers(0, classes, BATCH)
        img = 0.25 * protos[lab] + rng.standard_normal(
            (BATCH, image, image, 3), np.float32)
        return (torch.from_numpy(img).to(device, torch.bfloat16),
                torch.from_numpy(lab).to(device))

    train = [batch() for _ in range(8)]
    return train, batch()


def run(tag, data, device):
    cfg = arch_config("b16", image_size=224, num_classes=10,
                      dtype=torch.bfloat16, fused_qkv=True, fused_mlp=True,
                      **CONFIGS[tag])
    params = vit.init_params(set_seed(0), cfg, device)
    opt, sched = sgd_momentum(params, 0.01, STEPS, 0.1)
    state = create_train_state(params, opt, sched,
                               torch.Generator().manual_seed(1))
    step = make_train_step(cfg, opt, sched)
    train, (eimg, elab) = data
    losses, accs, eaccs, elosses = [], [], [], []
    for s in range(STEPS):
        img, lab = train[s % len(train)]
        state, metrics = step(state, img, lab)
        if s % 50 == 49:
            losses.append(float(metrics["loss"]))
            accs.append(float(metrics["acc1"]))
            with torch.inference_mode():
                logits = vit.apply(state.params, eimg, cfg)
            eaccs.append(float((logits.argmax(-1) == elab).float().mean()))
            elosses.append(float(cross_entropy(logits, elab)))
    print(f"{tag}: losses={['%.4f' % v for v in losses]}", flush=True)
    print(f"{tag}: train acc1={['%.3f' % a for a in accs]}", flush=True)
    print(f"{tag}: HELD-OUT acc1={['%.3f' % a for a in eaccs]}", flush=True)
    print(f"{tag}: HELD-OUT loss={['%.4f' % v for v in elosses]}",
          flush=True)
    return losses, eaccs, elosses


def main(argv=None) -> int:
    tags = (sys.argv[1:] if argv is None else argv) or ["bf16", "int8-full"]
    for tag in tags:
        if tag not in CONFIGS:
            raise SystemExit(f"unknown tag {tag!r}; choose from "
                             f"{sorted(CONFIGS)}")
    if not torch.cuda.is_available():
        raise SystemExit("int8_convergence: needs a CUDA card")
    device = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    data = make_data(device)
    first = run(tags[0], data, device)
    for tag in tags[1:]:
        dl, da, de = (max(abs(a - b) for a, b in zip(f[-4:], r[-4:]))
                      for f, r in zip(first, run(tag, data, device)))
        print(f"{tag} vs {tags[0]}: final-phase max |loss diff| = {dl:.4f}, "
              f"max |held-out acc diff| = {da:.4f}, max |held-out loss "
              f"diff| = {de:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
