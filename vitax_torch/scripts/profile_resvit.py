"""Where a Res-ViT serving forward, or a train step, spends its time on one
CUDA card.

    python -m vitax_torch.scripts.profile_resvit [config ...]

The b16 Res-ViT of scripts/ft_resvit.sh (`--use_lora True --lora_rank 48
--use_reslr True --block_size 4 --dynamic_start_layer 1
--dynamic_reserve_initials 2 --dynamic_active_target 0.4`) at 224, random
weights from seed 0 with the routers' final biases drawn from ±0.3 (the
init's keep bias 5.0 routes every token active), and one resident batch of
64 Synthetic images. Configs: `dense`, `compact` (capacity 0.625),
`dense-int8`, `compact-int8` (default: all four); and train steps
(teacher + student forward, backward, AdamW; λ 1, 10, 1) on a resident
batch of random images: `train-dense` (b32, bf16, `ft_resvit.sh`),
`train-compact` (b32, bf16, `--compact-capacity 0.625`), `train-fast`
(b192, `--int8-dw --compact-capacity 0.625 --token-keep 0.5`,
`ft_resvit_fast.sh`'s flags past its dense warmup), and with 4 kv heads
(K7's int8 tier; weights of their own, made from seed 0)
`train-gqa-int8-grad` (b32, `--int8-grad --n_kv_heads 4`),
`train-gqa-fast` (b32, the fast flags with `--n_kv_heads 4`) and
`train-gqa-int4` (b32, `--int4-attn --int4-grad --int8-dw --n_kv_heads 4
--compact-capacity 0.625`: G-F and G-B on every layer), and
`train-c-int4` (b32, `--int4-attn --int4-grad --int8-dw
--compact-capacity 0.625`, the CLI's `--compact-warmup 0`: R-F and R-B dw
on the routed layers); and under a (1, 1)
mesh of this process's NCCL group of one rank (tcp on 127.0.0.1), where
every attention half is the LN kernel and K9 (vitax's dispatch under any
mesh), `dense-mesh` (the b64 serving forward) and `train-mesh` (the b32
step of `train-dense`); and with fused_qkvo off (a config built in code,
the CLIs tie it to fused_qkv), where every attention half is the LN
kernel, K10 and the plain out-projection, `dense-k10` and `train-k10`
(the same forward and step). For each it
runs two warm-up iterations, then records three with torch.profiler and
prints the wall time an iteration (host clock around synchronized
iterations), the device busy time (the sum of the kernels' device times;
one stream, so they do not overlap) and idle share, the device time by
group of kernels, and the largest kernels.
"""

from __future__ import annotations

import re
import sys
import time
from collections import defaultdict

import torch

from vitax_torch.core.prng import set_seed
from vitax_torch.data import get_dataloader
from vitax_torch.models import resvit
from vitax_torch.resvit_eval_cli import get_eval_config
from vitax_torch.resvit_train_cli import config_to_model_args
from vitax_torch.train.resvit_steps import (Lambdas, create_state,
                                            make_adamw_for, make_train_step)

RECIPE = ["--model-arch", "b16", "--image-size", "224", "--dataset",
          "Synthetic", "--use_lora", "True", "--lora_rank", "48",
          "--use_reslr", "True", "--block_size", "4", "--dynamic_start_layer",
          "1", "--dynamic_reserve_initials", "2", "--dynamic_active_target",
          "0.4"]
CONFIGS = {"dense": [], "compact": ["--compact-capacity", "0.625"],
           "dense-int8": ["--int8"],
           "compact-int8": ["--compact-capacity", "0.625", "--int8"],
           "dense-mesh": [], "dense-k10": []}
# train configs: (batch, overrides of the serving config)
TRAIN_CONFIGS = {
    "train-dense": (32, {}),
    "train-compact": (32, dict(compact_capacity=0.625)),
    "train-fast": (192, dict(int8_attn=True, int8_attn_grad=True,
                             int8_mlp=True, int8_mlp_grad=True, int8_dw=True,
                             fused_mlp=True, compact_capacity=0.625,
                             token_keep=0.5)),
    # chip_smoke.py's phase 11 (h) and (i): K7's int8 tier
    "train-gqa-int8-grad": (32, dict(n_kv_heads=4, int8_attn=True,
                                     int8_attn_grad=True, int8_mlp=True,
                                     int8_mlp_grad=True, fused_mlp=True)),
    "train-gqa-fast": (32, dict(n_kv_heads=4, int8_attn=True,
                                int8_attn_grad=True, int8_mlp=True,
                                int8_mlp_grad=True, int8_dw=True,
                                fused_mlp=True, compact_capacity=0.625,
                                token_keep=0.5)),
    # chip_smoke.py's phase 14: (e)'s int4 tier
    "train-gqa-int4": (32, dict(n_kv_heads=4, int8_attn=True,
                                int8_attn_grad=True, int8_mlp=True,
                                int8_mlp_grad=True, int8_dw=True,
                                int4_mlp=True, int4_attn=True,
                                int4_grad=True, fused_mlp=True,
                                compact_capacity=0.625)),
    # chip_smoke.py's phase 14: resvit_train_cli --int4-attn --int4-grad
    # --int8-dw --compact-capacity 0.625 --compact-warmup 0 (R-F and R-B dw
    # on the routed layers, K11-C and K11-D dw on the others, K11-A and
    # K11-B dw on every MLP half)
    "train-c-int4": (32, dict(int8_attn=True, int8_attn_grad=True,
                              int8_mlp=True, int8_mlp_grad=True, int8_dw=True,
                              int4_mlp=True, int4_attn=True, int4_grad=True,
                              fused_mlp=True, compact_capacity=0.625)),
    # chip_smoke.py's phase 16 (b): (a) under the (1, 1) mesh
    "train-mesh": (32, {}),
    # chip_smoke.py's phase 15: (a) with fused_qkvo off (K10)
    "train-k10": (32, dict(fused_qkvo=False)),
}
# kernel-name fragment -> group, first match wins
GROUPS = [("k13::", "attention core, wgmma (K13; K1's, K6's, K8's, K9's "
                   "and K10's forwards, backwards)"),
          ("gemm_sm90", "bf16 wgmma GEMM (K1's, K2's, K6's, K8's, K9's, "
                        "K10's, K12's products)"),
          ("attention_core", "whole-row attention core (K7/R-F)"),
          ("attention_bwd", "attention core backward"),
          ("gemm_s8_sm90", "s8 wgmma GEMM (K3's, K4's, K5's, K8's, "
                           "K11-B's, K11-C/D's and R-B's products)"),
          ("gemm_s8", "s8 mma.sync GEMM (K7/R-F/K11-A/K12 int8)"),
          ("gemm_bf16", "bf16 GEMM (the fused halves' products)"),
          ("layer_norm_rows", "LN forward"),
          ("layer_norm_bwd", "LN backward"),
          ("layer_norm_quant", "LN + quant"),
          ("colsum", "column sums (bias grads)"), ("quant", "quantizers"),
          ("gemm", "cuBLAS GEMM (plain products)"),
          ("sort", "sort"), ("scatter", "gather/scatter"),
          ("gather", "gather/scatter"), ("index", "gather/scatter"),
          ("reduce", "reductions"), ("elementwise", "elementwise"),
          ("", "other")]


def randomize_router_biases(params, seed: int = 9) -> None:
    """Each router's final bias drawn from ±0.3, in place (as
    tests/test_resvit_compact.py does): the init's keep bias 5.0 routes
    every token active, and compaction would then only demote."""
    g = torch.Generator().manual_seed(seed)
    for lp in params["layers"]:
        if "router" in lp:
            bias = lp["router"]["out3"]["bias"]
            bias.copy_(torch.empty(bias.shape).uniform_(-0.3, 0.3,
                                                        generator=g))


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def _annotation(evt) -> bool:
    """A user annotation's device range (record_function's "scope#name",
    e.g. the optimizer's "Optimizer.step#SGD.step"): it spans kernels that
    are counted on their own. Kernel names hold "#" only inside "{lambda()#n}"
    and never match."""
    return re.fullmatch(r"[\w.]+#[\w.]+", evt.key) is not None


def _profiled(fn, iters):
    """(profiler, wall ms an iteration) of `iters` calls of fn after two
    warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    return prof, wall


def _mesh(name: str):
    """None, or for a `-mesh` config the (1, 1) mesh of this process's NCCL
    group of one rank, which the first such config starts."""
    if not name.endswith("-mesh"):
        return None
    import os
    import socket
    import torch.distributed as dist
    from vitax_torch.parallel import make_mesh
    if not dist.is_initialized():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        dist.init_process_group("nccl",
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=0, world_size=1)
    return make_mesh(1, 1)


def profile(name: str, params, images, cfg, iters: int = 3) -> None:
    c = cfg
    mesh = _mesh(name)
    if "--compact-capacity" in CONFIGS[name]:
        c = c.replace(compact_capacity=0.625)
    if "--int8" in CONFIGS[name]:
        c = c.replace(int8_attn=True, int8_mlp=True, fused_mlp=True)
    if name.endswith("-k10"):
        c = c.replace(fused_qkvo=False)
    with torch.inference_mode():
        prof, wall = _profiled(
            lambda: resvit.apply(params, images, c, mesh=mesh), iters)
    report(name, prof, wall, iters, "a forward")


def profile_train(name: str, params, cfg, iters: int = 3) -> None:
    batch, over = TRAIN_CONFIGS[name]
    c = cfg.replace(**over)
    if c.n_kv_heads != cfg.n_kv_heads:  # GQA: its own packed weights
        params = resvit.init_params(set_seed(0), c, "cuda")
        randomize_router_biases(params)
    g = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randn((batch, 224, 224, 3), generator=g, device="cuda",
                         dtype=torch.bfloat16)
    labels = torch.randint(0, 10, (batch,), generator=g, device="cuda")
    tx = make_adamw_for(c, params, lambda s: 1e-4)
    state = create_state(params, tx, torch.Generator(device="cuda")
                         .manual_seed(2))
    step = make_train_step(c, tx, Lambdas(1.0, 10.0, 1.0), mesh=_mesh(name))
    prof, wall = _profiled(lambda: step(state, images, labels), iters)
    report(f"{name} b{batch}", prof, wall, iters, "a step")


def report(name, prof, wall, iters, unit) -> None:
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA
               and not _annotation(e)]
    busy = sum(_device_us(e) for e in kernels) / 1e3 / iters
    if busy == 0:
        print(f"{name}: the profiler recorded no device time; wall "
              f"{wall:.2f} ms {unit}", flush=True)
        return
    groups = defaultdict(float)
    for e in kernels:
        key = next(g for frag, g in GROUPS if frag in e.key.lower())
        groups[key] += _device_us(e) / 1e3 / iters
    print(f"{name}: wall {wall:.2f} ms {unit}, device busy {busy:.2f} ms, "
          f"idle {100 * (1 - busy / wall):.1f} %; by group: " + ", ".join(
              f"{g} {ms:.2f} ms ({100 * ms / busy:.1f} %)"
              for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])),
          flush=True)
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    print(f"{name}: largest kernels: " + "; ".join(
        f"{e.key[:60]} {_device_us(e) / 1e3 / iters:.3f} ms x"
        f"{e.count // iters}" for e in top), flush=True)


def main(argv=None) -> None:
    names = ((argv if argv is not None else sys.argv[1:])
             or [n for n in CONFIGS if not n.endswith(("-mesh", "-k10"))])
    unknown = set(names) - set(CONFIGS) - set(TRAIN_CONFIGS)
    if unknown:
        raise SystemExit(f"profile_resvit: unknown configs {sorted(unknown)}; "
                         f"choose from {list(CONFIGS) + list(TRAIN_CONFIGS)}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_resvit: needs a CUDA card")
    cfg = config_to_model_args(get_eval_config(RECIPE), "cuda")
    params = resvit.init_params(set_seed(0), cfg, "cuda")
    randomize_router_biases(params)
    batch = next(iter(get_dataloader("Synthetic", split="val",
                                     image_size=224, batch_size=64,
                                     num_samples=64, seed=0)))
    images = torch.from_numpy(batch.images).cuda().bfloat16()
    print(f"profile_resvit: {torch.cuda.get_device_name(0)}, b64 @224",
          flush=True)
    for name in names:
        if name in TRAIN_CONFIGS:
            profile_train(name, params, cfg)
        else:
            profile(name, params, images, cfg)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
