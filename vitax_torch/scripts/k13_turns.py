"""K13's paths end to end, to compare two checkouts in turns on one card.

    PYTHONPATH=<checkout> python vitax_torch/scripts/k13_turns.py <tag>

With the `vitax_torch` found first on the path (that checkout's, which this
file need not belong to), it prints under `tag`:

- K6's checksum (`k6_checksum`): sha256 prefixes of K6's forward output
  and its backward's seven grads on seeded inputs at ViT-H/14's widths, so
  that two checkouts show whether K6's bits moved;
- ViT-B/16 with `--no-fused-qkv` (LN kernel, plain projections, K13, K2):
  the serving forward at b64 and 384 px, and a train step (forward,
  backward, SGD with momentum) at b32 and 224 px, CUDA-event medians of 10
  on a resident Synthetic batch, random weights from seed 0.

Run it for two checkouts in the order A, B, B, A in one call on the card
(each run builds its checkout's kernels into that checkout's `build/`).
"""

from __future__ import annotations

import hashlib
import statistics
import subprocess
import sys

import torch

H14_WIDTHS = (1280, 16, 80)  # D, heads, head_dim


def k6_checksum() -> str:
    """sha256 prefixes of K6's forward output and of its backward's seven
    grads (dx, dγ, dβ, dWqkv, dbqkv, dWo, dbo) at b2 spq 264, seq 257, on
    inputs made from a fixed seed on the card."""
    from vitax_torch.ops import cuda_kernels as ck
    d, heads, hd = H14_WIDTHS
    g = torch.Generator(device="cuda").manual_seed(190)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(dtype)

    w = 3 * heads * hd
    x = rnd(2, 264, d)
    gamma = 1 + rnd(d, scale=0.1, dtype=torch.float32)
    beta = rnd(d, scale=0.1, dtype=torch.float32)
    wqkv, bqkv = rnd(d, w, scale=d ** -0.5), rnd(w, scale=0.02,
                                                   dtype=torch.float32)
    wo = rnd(heads * hd, d, scale=(heads * hd) ** -0.5)
    bo, do = rnd(d, scale=0.02, dtype=torch.float32), rnd(2, 264, d)
    head, tail = (x, gamma, beta, wqkv, bqkv, wo), (1e-5, 257, heads, hd)
    with torch.no_grad():
        outs = ((ck.fused_ln_qkvo_attention_flash(*head, bo, *tail),)
                + tuple(ck.fused_ln_qkvo_attention_flash_bwd(*head, do,
                                                              *tail)))
        torch.cuda.synchronize()
    return " ".join(hashlib.sha256(o.float().cpu().numpy().tobytes())
                    .hexdigest()[:12] for o in outs)


def _median_ms(fn, warmup=2, iters=10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def no_fused_qkv_ms() -> dict:
    """{"forward b64 @384": ms, "step b32 @224": ms} of ViT-B/16 with
    --no-fused-qkv on the card."""
    from vitax_torch.core.config import arch_config
    from vitax_torch.core.prng import set_seed
    from vitax_torch.data import get_dataloader
    from vitax_torch.models import vit
    from vitax_torch.train import (create_train_state, make_train_step,
                                   param_leaves, sgd_momentum)
    out = {}
    for image, batch in ((384, 64), (224, 32)):
        cfg = arch_config("b16", image_size=image, num_classes=10,
                          dtype=torch.bfloat16, fused_qkv=False,
                          fused_mlp=True)
        params = vit.init_params(set_seed(0), cfg, "cuda")
        data = next(iter(get_dataloader(
            "Synthetic", split="val" if image == 384 else "train",
            image_size=image, batch_size=batch, num_samples=128, seed=0)))
        images = torch.from_numpy(data.images).cuda().bfloat16()
        if image == 384:
            with torch.inference_mode():
                out["forward b64 @384"] = _median_ms(
                    lambda: vit.apply(params, images, cfg))
            continue
        labels = torch.from_numpy(data.labels).cuda()
        for p in param_leaves(params):
            p.requires_grad_(True)
        opt, sched = sgd_momentum(params, 0.03, 1000, 0.1)
        state = create_train_state(params, opt, sched, torch.Generator())
        step = make_train_step(cfg, opt, sched)
        out["step b32 @224"] = _median_ms(lambda: step(state, images,
                                                       labels))
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k13_turns: needs a CUDA card")
    tag = argv[0] if argv else "run"
    import vitax_torch
    from vitax_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    build.load()
    print(f"{tag}: {vitax_torch.__file__} on "
          f"{smi.stdout.strip().splitlines()[0]}", flush=True)
    print(f"{tag}: K6 checksum {k6_checksum()}", flush=True)
    print(f"{tag}: --no-fused-qkv " + ", ".join(
        f"{k} {ms:.3f} ms" for k, ms in no_fused_qkv_ms().items())
        + " (CUDA-event medians of 10)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
