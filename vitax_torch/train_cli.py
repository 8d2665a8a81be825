"""Fine-tune CLI — the port's counterpart of vitax/train_cli.py.

Builds the model from an arch preset (random weights from `--seed`, or an
`.npz` checkpoint whose head is re-initialized on a class mismatch), plans
the epochs (train_steps // len(train_loader), or the token-keep schedule's
plan), trains with SGD(momentum 0.9) + OneCycle sized to the planned total,
validates every epoch with top-1/top-5 on the val split, saves `current` and
`best` (by val acc1) and resumes exactly from `--resume`. On a CUDA card the
fused kernels are on by default, forward and backward (`--no-fused-qkv`,
`--no-fused-mlp` and `--no-pallas` turn them off); `--int8` runs their W8A8
forward with the bf16 backward, `--int8-grad` the W8A8 backward too, and
`--int8-dw` its int8 weight grads; with `--int8-grad` the token-drop phase
(spq <= 128) hands each block's packed input over (K5). `--int4` runs the
MLP half's forward A4W4 (K11), `--int4-attn` the attention half's too, and
`--int4-grad` the MLP half's dx-path backward (and the attention half's
with `--int4-attn --int8-grad`), as vitax's dispatch; int4 never hands
off, and takes the MLP half ahead of `--save-acts`. `--save-acts` keeps h1
and GELU'(a1) from the MLP half's forward for its backward (K12, bf16 or
with `--int8-grad`; off above d 1024 and with `--int8` alone, as in
vitax). `--no-fused-qkv` runs the attention half as the LN kernel, plain projections and K13 (the
standalone attention core), forward and backward. With a fused half off
vitax's automatic remat picks "selective" (vitax/train_cli.py:144); the
port has no remat (ROADMAP Queue 1 item 6) and runs without it, the same
function with more memory. It runs on the card unless the caller of `main`
asks for the CPU (`device="cpu"`).

Data and tensor parallelism, one process per card under torchrun:
`torchrun --nproc_per_node N -m vitax_torch.train_cli --n-gpu N
[--n-model M]` lays the N ranks out on an (N/M, M) mesh, as vitax's mesh
(vitax/train_cli.py:244-251): each data rank trains on its rows of every
global batch, grads summed over the data axis; with M > 1 each block's
attention and MLP halves run per model shard in the run's tier (K1, K3 or
K11-C; K2, K4 or K11-A without the residual; one all-reduce each), and
where vitax hands the sharded weights to XLA (ViT-H/14's attention half,
`--no-fused-qkv`, `--no-fused-mlp`) the plain half on the gathered
weights; `--save-acts` changes nothing there, as vitax's tensor-parallel
MLP half takes no save-acts. Rank 0 alone writes the checkpoints (whole parameters,
gathered over the model axis), the JSON files and the writers' output. A
caller that started its own process group (gloo, say) passes the card as
`device=`; `init_distributed` leaves the group as it is.

vitax's fastest recipe (scripts/FT_CIFAR100_fast.sh) runs as it is:
`... --int8-dw --token-keep 0.5 --token-keep-schedule 0.9 --batch-size 768
--dense-batch-size 192`.

Run: `python -m vitax_torch.train_cli --dataset Synthetic --model-arch b16 \
          --image-size 224 --batch-size 32 --lr 0.03 --wd 0`
"""

from __future__ import annotations

import os
import time

import torch

from vitax_torch import cli
from vitax_torch.checkpointing.npz import load_npz_params
from vitax_torch.checkpointing.store import CheckpointStore
from vitax_torch.core.config import arch_config
from vitax_torch.core.prng import set_seed
from vitax_torch.data import get_dataloader
from vitax_torch.eval_cli import make_weighted_eval_step
from vitax_torch.models import vit
from vitax_torch.parallel import (cli_mesh, gather_params, init_distributed,
                                  shard_params, tp_size, vit_param_spec)
from vitax_torch.parallel.distributed import rank
from vitax_torch.parallel.mesh import gather_shards
from vitax_torch.train import (create_train_state, make_train_step,
                               sgd_momentum, token_keep_switch_epoch)
from vitax_torch.utils.experiment import write_json
from vitax_torch.utils.memory import (log_model_layers, named_leaves,
                                      print_memory_usage)
from vitax_torch.utils.metrics import MetricTracker
from vitax_torch.utils.writers import ExperimentWriter


def _reject_unported(config) -> None:
    """Flags whose code paths the port does not have yet raise here."""
    unported = [
        (config.export_pth, "--export-pth", "the .pth writer",
         "Queue 1 item 4"),
        (config.resume and config.n_model > 1, "--resume with --n-model > 1",
         "resuming a tensor-parallel run", "Queue 1 item 5"),
        (config.device_prep, "--device-prep", "on-device preprocessing",
         "Queue 1 item 3"),
        (config.remat in ("full", "selective"), f"--remat {config.remat}",
         "block rematerialization", "Queue 1 item 6"),
    ]
    for hit, flag, what, item in unported:
        if hit:
            raise NotImplementedError(
                f"{flag}: {what} is not ported yet (ROADMAP {item})")


def model_config_from_cli(config, on_gpu: bool):
    """CLI flags → ViTConfig. The fused kernels default on where the device
    is CUDA; their gates keep the plain path for shapes they do not take.
    `--int8-dw` implies `--int8-grad` implies `--int8`; `--int4-attn` and
    `--int4-grad` imply `--int4`, which implies `--int8` but not
    `--int8-grad`, as in vitax (vitax/train_cli.py:132-153)."""
    dtype = torch.bfloat16 if config.dtype == "bfloat16" else torch.float32
    int8_dw = getattr(config, "int8_dw", False)
    int8_grad = getattr(config, "int8_grad", False) or int8_dw
    int4_attn = getattr(config, "int4_attn", False)
    int4_grad = getattr(config, "int4_grad", False)
    int4 = getattr(config, "int4", False) or int4_attn or int4_grad
    int8 = getattr(config, "int8", False) or int8_grad or int4
    return arch_config(
        config.model_arch, image_size=config.image_size,
        num_classes=config.num_classes, dtype=dtype,
        fused_qkv=on_gpu if config.fused_qkv is None else config.fused_qkv,
        fused_mlp=on_gpu if config.fused_mlp is None else config.fused_mlp,
        int8_mlp=int8, int8_attn=int8, int8_mlp_grad=int8_grad,
        int8_attn_grad=int8_grad, int8_dw=int8_dw, int4_mlp=int4,
        int4_attn=int4_attn, int4_grad=int4_grad,
        fused_mlp_save=getattr(config, "save_acts", False),
        token_keep=config.token_keep,
        use_pallas=False if config.no_pallas else None)


def plan_epochs(train_steps: int, steps_per_epoch: int,
                dense_steps_per_epoch, sched, token_keep: float):
    """(epochs, dense_from_epoch, total optimizer steps) of vitax's epoch
    plan (vitax/train_cli.py:196-235). epochs = train_steps //
    steps_per_epoch (the reference's formula), unless the token-keep
    schedule's dense tail runs another batch size (`dense_steps_per_epoch`
    not None): then the epoch count is solved from
    sched·E·steps_per_epoch + (1-sched)·E·dense_steps_per_epoch = steps, and
    OneCycle is sized to the planned total."""
    if dense_steps_per_epoch is not None:
        per_epoch = (sched * steps_per_epoch
                     + (1.0 - sched) * dense_steps_per_epoch)
        epochs = max(2, int(round(train_steps / per_epoch)))
    else:
        epochs = max(1, train_steps // max(1, steps_per_epoch))
    dense_from_epoch = token_keep_switch_epoch(sched, token_keep, epochs)
    if dense_steps_per_epoch is not None:
        total = (dense_from_epoch * steps_per_epoch
                 + (epochs - dense_from_epoch) * dense_steps_per_epoch)
    else:
        total = train_steps
    return epochs, dense_from_epoch, total


def train_epoch(epoch, state, train_step, loader, device, dtype, writer,
                tracker, print_freq=100):
    """One epoch; partial final batches are skipped (drop_last). Returns the
    state and {"losses": per-step losses, "img_per_s", tracker means}."""
    tracker.reset()
    loader.set_epoch(epoch)
    t0 = time.time()
    losses, n_img = [], 0
    for i, batch in enumerate(loader):
        if batch.weight.sum() < len(batch.weight):
            continue  # partial final train batch: skip like drop_last
        images = torch.from_numpy(batch.images).to(device=device, dtype=dtype)
        labels = torch.from_numpy(batch.labels).to(device)
        state, metrics = train_step(state, images, labels)
        losses.append(metrics["loss"])
        n_img += len(labels)
        if i % print_freq == print_freq - 1:
            # host syncs only at the print frequency
            writer.set_step(state.step, "train")
            mh = {k: float(v) for k, v in metrics.items()}
            for k, v in mh.items():
                tracker.update(k, v)
                writer.add_scalar(k, v)
            print(f"epoch {epoch} step {state.step}: "
                  + " ".join(f"{k}={v:.4f}" for k, v in mh.items())
                  + f" ({n_img / (time.time() - t0):.0f} img/s)", flush=True)
    losses = [float(v) for v in losses]
    rate = n_img / max(time.time() - t0, 1e-9)
    print(f"epoch {epoch} train: {len(losses)} steps, loss "
          f"{losses[-1] if losses else float('nan'):.4f} ({n_img} images, "
          f"{rate:.0f} img/s)", flush=True)
    return state, {"losses": losses, "img_per_s": rate, **tracker.result()}


def valid_epoch(epoch, state, eval_step, loader, device, dtype, writer,
                tracker):
    tracker.reset()
    totals = {"loss": 0.0, "acc1": 0.0, "acc5": 0.0}
    n = 0.0
    for batch in loader:
        images = torch.from_numpy(batch.images).to(device=device, dtype=dtype)
        labels = torch.from_numpy(batch.labels).to(device)
        weight = torch.from_numpy(batch.weight).to(device)
        metrics = eval_step(state.params, images, labels, weight)
        bs = float(weight.sum())
        for k in totals:
            totals[k] += float(metrics[k]) * bs
        n += bs
    result = {k: v / max(n, 1) for k, v in totals.items()}
    writer.set_step(state.step, "valid")
    for k, v in result.items():
        tracker.update(k, v)
        writer.add_scalar(k, v)
    print(f"epoch {epoch} valid: "
          + " ".join(f"{k}={v:.4f}" for k, v in result.items()), flush=True)
    return result


class _Gathered:
    """The training state as one process would hold it, for rank 0's
    checkpoint under tensor parallelism: whole parameters and momentum
    buffers, gathered over the model axis (every rank builds it)."""

    def __init__(self, state, mesh):
        names = [n for n, _ in named_leaves(state.params)]
        self.params = gather_params(state.params, mesh, vit_param_spec)
        self.sd = state.optimizer.state_dict()
        for i, buf in self.sd["state"].items():
            buf["momentum_buffer"] = gather_shards(
                "/" + names[i], buf["momentum_buffer"], mesh, vit_param_spec)
        self.step, self.scheduler, self.gen = (state.step, state.scheduler,
                                               state.gen)
        self.optimizer = self

    def state_dict(self):
        return self.sd


def _initial_params(config, cfg, gen, device):
    params = vit.init_params(gen, cfg, device)
    path = config.checkpoint_path
    if not path:
        return params
    if os.path.isdir(path) or not path.endswith(".npz"):
        raise NotImplementedError(
            f"{path}: only .npz checkpoints load in the port so far; .pth "
            "files and checkpoint stores are not yet ported (ROADMAP Queue 1 "
            "item 4)")
    loaded = load_npz_params(path, cfg)
    head = loaded.pop("classifier", None)
    out = vit.params_from_jax(loaded, device)
    if head is None:
        print(f"re-initializing classifier head for {config.num_classes} "
              "classes")
        out["classifier"] = params["classifier"]
    else:
        out["classifier"] = {k: torch.from_numpy(v).to(device)
                             for k, v in head.items()}
    return out


def main(argv=None, device=None):
    """`device`: None for the card (raises without one), or "cpu"."""
    config = cli.get_train_config(argv)
    cli.print_config(config)
    # the int8/int4 tiers at d > 1024 first
    vit.check_tiers(model_config_from_cli(config, False))
    _reject_unported(config)
    gen = set_seed(config.seed)
    device = cli.resolve_device(device)
    cfg = model_config_from_cli(config, device.type == "cuda")
    vit.check_tp(cfg, config.n_model)
    init_distributed(device)
    # mesh: data (+ tensor) parallel over the processes
    mesh = cli_mesh(config.n_gpu, config.n_model)
    lead = rank() == 0
    if mesh is not None:
        print(f"mesh: {mesh.shape} over {mesh.n_data * mesh.n_model} "
              f"{device.type} process(es); rank {mesh.rank}")
    params = _initial_params(config, cfg, gen, device)
    n_params = log_model_layers(params, log=lambda *_: None)
    print(f"model: {config.model_arch} with {n_params:,} parameters")
    if lead:
        write_json({"arch": config.model_arch, "parameters": n_params},
                   f"{config.result_dir}/model_info.json")
    params = shard_params(params, mesh, vit_param_spec)

    common = dict(data_dir=config.data_dir, image_size=config.image_size,
                  batch_size=config.batch_size,
                  num_workers=config.num_workers, seed=config.seed)
    if config.dataset == "Synthetic":
        common["num_samples"] = config.synthetic_samples
    train_loader = get_dataloader(config.dataset, split="train", **common)
    valid_loader = get_dataloader(config.dataset, split="val", **common)

    sched = config.token_keep_schedule
    dense_bs = config.dense_batch_size
    dense_loader = None
    if sched is not None and dense_bs and dense_bs != config.batch_size:
        dense_loader = get_dataloader(config.dataset, split="train",
                                      **{**common, "batch_size": dense_bs})
    epochs, dense_from_epoch, total = plan_epochs(
        config.train_steps, len(train_loader),
        None if dense_loader is None else len(dense_loader), sched,
        cfg.token_keep)
    print(f"training {epochs} epochs "
          f"({dense_from_epoch} x {len(train_loader)} steps"
          + (f" + {epochs - dense_from_epoch} x {len(dense_loader)} "
             f"dense-tail steps" if dense_loader is not None else "")
          + f"; schedule total {total})")
    if dense_from_epoch < epochs:
        print(f"token-keep schedule: keep {cfg.token_keep} for epochs "
              f"0..{dense_from_epoch - 1}, dense from epoch "
              f"{dense_from_epoch}")

    # SGD(momentum=0.9) + OneCycle over the planned total
    opt, lr_sched = sgd_momentum(params, config.lr, total,
                                 config.warmup_steps / total,
                                 weight_decay=config.wd)
    state = create_train_state(params, opt, lr_sched,
                               torch.Generator().manual_seed(config.seed + 1))

    store = CheckpointStore(config.checkpoint_dir) if lead else None
    start_epoch = 0
    best_acc = 0.0
    if config.resume:
        rstore = CheckpointStore(config.resume)
        rstore.restore("current", state)
        meta = rstore.metadata("current")
        start_epoch = int(meta.get("epoch", 0)) + 1
        best_acc = float(meta.get("best_acc", 0.0))
        print(f"resumed from {config.resume} at epoch {start_epoch}")

    if device.type == "cuda" and (cfg.fused_qkv or cfg.fused_mlp
                                  or cfg.use_pallas is not False):
        from vitax_torch.kernels import build
        build.load()  # set-up: build the kernels before the timed loop

    writer = ExperimentWriter(
        config.summary_dir,
        backend=("swanlab" if config.swanlab and lead else
                 "tensorboard" if config.tensorboard and lead else "none"),
        exp_name=config.exp_name)
    train_tracker = MetricTracker("loss", "acc1", "acc5")
    valid_tracker = MetricTracker("loss", "acc1", "acc5")

    train_step = make_train_step(cfg, opt, lr_sched, mesh=mesh)
    dense_step = None
    eval_step = make_weighted_eval_step(cfg, mesh)
    history = []
    for epoch in range(start_epoch, epochs):
        step_fn, loader = train_step, train_loader
        if epoch >= dense_from_epoch:
            if dense_step is None:
                dense_step = make_train_step(cfg.replace(token_keep=1.0), opt,
                                             lr_sched, mesh=mesh)
                if dense_loader is not None:
                    print(f"dense tail batch size: {dense_bs}")
            step_fn = dense_step
            loader = dense_loader or train_loader
        state, tr = train_epoch(epoch, state, step_fn, loader, device,
                                cfg.dtype, writer, train_tracker)
        vr = valid_epoch(epoch, state, eval_step, valid_loader, device,
                         cfg.dtype, writer, valid_tracker)
        is_best = vr["acc1"] > best_acc
        best_acc = max(best_acc, vr["acc1"])
        saved = state if tp_size(mesh) == 1 else _Gathered(state, mesh)
        if lead:
            store.save_model(saved, epoch, is_best=is_best,
                             metrics={"best_acc": best_acc, **vr})
        history.append({"epoch": epoch, "train": tr, "valid": vr})
    print_memory_usage(state.params, state.optimizer)
    writer.close()
    print(f"done; best acc1 = {best_acc:.4f}")
    return {"best_acc": best_acc, "epochs": history,
            "checkpoint_dir": config.checkpoint_dir, "state": state}


if __name__ == "__main__":
    main()
