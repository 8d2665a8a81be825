"""Evaluation CLI — the port's counterpart of vitax/eval_cli.py.

Builds the model from an arch preset (random weights from `--seed`, or an
`.npz` checkpoint), evaluates top-1/top-5 and the loss on the val split with
a weighted padded final batch, and prints the means and the img/s. It runs
on the card unless the caller of `main` asks for the CPU (`device="cpu"`);
on the card the fused kernels are on by default (`--no-fused-qkv`,
`--no-fused-mlp` and `--no-pallas` turn them off; with `--no-fused-qkv`
the attention half is the LN kernel, plain projections and K13, the
standalone attention core). `--n-gpu N` under `torchrun --nproc_per_node N`
evaluates data-parallel: each rank runs its rows of every batch (the batch
size a multiple of N, as vitax requires) and the weighted metric sums are
added up over the ranks.

Run: `python -m vitax_torch.eval_cli --dataset Synthetic --model-arch b16 \
          --image-size 224 --batch-size 64`
(`torchrun --nproc_per_node N -m vitax_torch.eval_cli --n-gpu N ...` on N
cards)
"""

from __future__ import annotations

import os
import time

import torch

from vitax_torch import cli
from vitax_torch.checkpointing.npz import load_npz_params
from vitax_torch.core.config import arch_config
from vitax_torch.core.prng import set_seed
from vitax_torch.data import get_dataloader
from vitax_torch.models import vit
from vitax_torch.parallel import cli_mesh, init_distributed, local_rows
from vitax_torch.train.steps import weighted_means


def make_weighted_eval_step(cfg, mesh=None):
    """Eval step with a padding mask so the padded final batch counts only
    real samples (vitax/train_cli.py:97-117). Under a mesh each rank runs
    its rows of the global batch and the weighted sums are added up over
    the data group; params are this rank's (shards under a model axis)."""

    @torch.inference_mode()
    def step_fn(params, images, labels, weight):
        images, labels, weight = (local_rows(mesh, t)
                                  for t in (images, labels, weight))
        logits = vit.apply(params, images, cfg, mesh=mesh).float()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(1, labels[:, None].long())[:, 0]
        top = logits.topk(5, dim=-1).indices
        correct = top == labels[:, None]
        return weighted_means(
            {"loss": (nll * weight).sum(),
             "acc1": (correct[:, 0].float() * weight).sum(),
             "acc5": (correct.any(dim=-1).float() * weight).sum()},
            weight.sum(), mesh)

    return step_fn


def main(argv=None, device=None):
    """`device`: None for the card (raises without one), or "cpu"."""
    config = cli.get_eval_config(argv)
    cli.print_config(config)
    gen = set_seed(config.seed)

    device = cli.resolve_device(device)
    init_distributed(device)
    # data-parallel eval over the processes (vitax/eval_cli.py:72-81)
    mesh = cli_mesh(config.n_gpu)
    if mesh is not None:
        print(f"mesh: {mesh.shape} over {mesh.n_data} {device.type} "
              "process(es)")
        if config.batch_size % mesh.n_data:
            raise SystemExit("--batch-size must divide the device count for "
                             "data-parallel eval")
    on_gpu = device.type == "cuda"
    dtype = torch.bfloat16 if config.dtype == "bfloat16" else torch.float32
    cfg = arch_config(config.model_arch, image_size=config.image_size,
                      num_classes=config.num_classes, dtype=dtype,
                      fused_qkv=(on_gpu if config.fused_qkv is None
                                 else config.fused_qkv),
                      fused_mlp=(on_gpu if config.fused_mlp is None
                                 else config.fused_mlp),
                      int8_mlp=config.int8, int8_attn=config.int8,
                      use_pallas=False if config.no_pallas else None)
    vit.check_tiers(cfg)

    if config.checkpoint_path:
        path = config.checkpoint_path
        if os.path.isdir(path) or not path.endswith(".npz"):
            raise NotImplementedError(
                f"{path}: only .npz checkpoints load in the port so far; .pth "
                "files and vitax checkpoint stores are not yet ported "
                "(ROADMAP Queue 1 item 4)")
        loaded = load_npz_params(path, cfg)
        if "classifier" not in loaded:
            raise ValueError(
                "checkpoint head does not match --num-classes "
                f"{config.num_classes} (strict eval, src/eval.py:34-38)")
        params = vit.params_from_jax(loaded, device)
    else:
        params = vit.init_params(gen, cfg, device)

    extra = ({"num_samples": config.synthetic_samples}
             if config.dataset == "Synthetic" else {})
    loader = get_dataloader(config.dataset, split="val",
                            data_dir=config.data_dir,
                            image_size=config.image_size,
                            batch_size=config.batch_size,
                            num_workers=config.num_workers, seed=config.seed,
                            **extra)

    if on_gpu and (cfg.fused_qkv or cfg.fused_mlp
                   or cfg.use_pallas is not False):
        from vitax_torch.kernels import build
        build.load()  # set-up: build the kernels before the timed loop

    eval_step = make_weighted_eval_step(cfg, mesh)
    totals = {"loss": 0.0, "acc1": 0.0, "acc5": 0.0}
    n = 0.0
    t0 = time.time()
    for i, batch in enumerate(loader):
        images = torch.from_numpy(batch.images).to(device=device, dtype=dtype)
        labels = torch.from_numpy(batch.labels).to(device)
        weight = torch.from_numpy(batch.weight).to(device)
        metrics = eval_step(params, images, labels, weight)
        bs = float(weight.sum())
        for k in totals:
            totals[k] += float(metrics[k]) * bs
        n += bs
        if i % 50 == 0:
            print(f"batch {i}/{len(loader)}: "
                  f"acc1={totals['acc1'] / max(n, 1):.4f}", flush=True)
    dt = time.time() - t0
    result = {k: v / max(n, 1) for k, v in totals.items()}
    print(f"Top-1 accuracy: {result['acc1']:.4f}")
    print(f"Top-5 accuracy: {result['acc5']:.4f}")
    print(f"({n:.0f} images in {dt:.1f}s, {n / dt:.0f} img/s)")
    return result


if __name__ == "__main__":
    main()
