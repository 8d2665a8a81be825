"""Train and eval steps of the standard ViT (counterpart of
vitax/train/steps.py).

The reference's per-batch loop body (forward, CE loss, backward, SGD step,
scheduler step, accuracy) as one function. vitax jits it into one XLA
program; here it runs eagerly, and on CUDA the encoder's forward and
backward go through the hand-written kernels (models/vit.py).

Under a mesh (vitax's `make_train_step(..., mesh=)`, steps.py:78-102) each
rank runs its rows of the global batch it is given, the grads are summed
over the data group and divided by its size (vitax's mean over the global
batch, the batch split evenly), and the metrics are the global batch's;
the eval steps sum their weighted metrics over the data group, as vitax's
eval_cli does (vitax/eval_cli.py:72-97).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from vitax_torch.core.config import ViTConfig
from vitax_torch.models import vit
from vitax_torch.parallel.distributed import all_reduce
from vitax_torch.parallel.mesh import Mesh, local_rows, tp_size
from vitax_torch.train.optim import param_leaves, step_scheduler


@dataclasses.dataclass
class TrainState:
    """What a resume restores: the step count, the fp32 master parameters,
    the optimizer and scheduler (their state dicts) and the generator of the
    train-time randomness (token dropping, dropout)."""
    step: int
    params: Any
    optimizer: torch.optim.Optimizer
    scheduler: Any
    gen: torch.Generator


def create_train_state(params: Any, optimizer: torch.optim.Optimizer,
                       scheduler: Any, gen: torch.Generator) -> TrainState:
    for p in param_leaves(params):
        p.requires_grad_(True)
    return TrainState(step=0, params=params, optimizer=optimizer,
                      scheduler=scheduler, gen=gen)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch, fp32 (`nn.CrossEntropyLoss` semantics)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels[:, None].long())[:, 0].mean()


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  ks=(1, 5)) -> Dict[str, torch.Tensor]:
    """Top-k accuracy fractions, fp32."""
    top = logits.float().topk(max(ks), dim=-1).indices
    correct = top == labels[:, None]
    return {f"acc{k}": correct[:, :k].any(dim=-1).float().mean() for k in ks}


def _flat_sum(tensors, group) -> None:
    """Sum the fp32 tensors (each any shape) in place over `group`, in one
    all-reduce of their concatenation (on the card where one of them is, as
    NCCL needs; a constant metric may sit on the host)."""
    dev = next((t.device for t in tensors if t.device.type != "cpu"),
               tensors[0].device)
    flat = torch.cat([t.reshape(-1).float().to(dev) for t in tensors])
    all_reduce(flat, group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def average_grads(leaves, mesh: Mesh) -> None:
    """Each leaf's grad summed over the data group and divided by its size:
    the mean over the global batch of the ranks' row means, vitax's grad of
    its global mean when every rank holds as many rows. Runs at every mesh
    size, one rank too."""
    grads = [t.grad for t in leaves if t.grad is not None]
    _flat_sum(grads, mesh.data_group)
    for g in grads:
        g.div_(mesh.n_data)


def mean_over_data(metrics: Dict[str, torch.Tensor], mesh: Optional[Mesh]
                   ) -> Dict[str, torch.Tensor]:
    """Per-rank means of equal row counts → the global batch's means."""
    if mesh is None:
        return metrics
    vals = [v.detach().float().clone() for v in metrics.values()]
    _flat_sum(vals, mesh.data_group)
    return {k: v / mesh.n_data for k, v in zip(metrics, vals)}


def make_train_step(cfg: ViTConfig, optimizer: torch.optim.Optimizer,
                    scheduler: Any, clip_grad_norm: Optional[float] = None,
                    mesh: Optional[Mesh] = None):
    """(state, images, labels) → (state, metrics): forward, CE, backward,
    optional global-norm clip, optimizer step, scheduler step. images are
    NHWC in the compute dtype, labels int. The parameters are updated in
    place; their grads stay readable until the next step. `mesh`: images
    and labels are the global batch, of which this rank runs its rows;
    params and the optimizer are this rank's (shards under a model axis >
    1, `parallel.shard_params`)."""
    if clip_grad_norm is not None and tp_size(mesh) > 1:
        raise NotImplementedError(
            "the global grad norm over model shards is not ported (ROADMAP "
            "Queue 1 item 5); no CLI clips the ViT's grads")

    def step_fn(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        optimizer.zero_grad(set_to_none=True)
        images, labels = local_rows(mesh, images), local_rows(mesh, labels)
        logits = vit.apply(state.params, images, cfg, train=True,
                           gen=state.gen, mesh=mesh)
        loss = cross_entropy(logits, labels)
        loss.backward()
        if mesh is not None:
            average_grads(param_leaves(state.params), mesh)
        if clip_grad_norm is not None:
            torch.nn.utils.clip_grad_norm_(param_leaves(state.params),
                                           clip_grad_norm)
        optimizer.step()
        step_scheduler(scheduler)
        state.step += 1
        with torch.no_grad():
            metrics = mean_over_data(
                {"loss": loss.detach(),
                 **topk_accuracy(logits.detach(), labels)}, mesh)
        return state, metrics

    return step_fn


def weighted_means(sums: Dict[str, torch.Tensor], wsum: torch.Tensor,
                   mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """Weighted sums of this rank's rows and their weight → the means over
    the real rows of the global batch: summed over the data group under a
    mesh (vitax's eval_cli, :72-97), each divided by max(Σ weight, 1)."""
    vals = [v.float() for v in sums.values()] + [wsum.float()]
    if mesh is not None:
        vals = [v.clone() for v in vals]
        _flat_sum(vals, mesh.data_group)
    total = vals[-1].clamp_min(1.0)
    return {k: v / total for k, v in zip(sums, vals)}


def make_eval_step(cfg: ViTConfig, mesh: Optional[Mesh] = None):
    """(params, images, labels) → metrics dict, no grad. Under a mesh this
    rank's rows of the global batch, the means the global batch's."""

    @torch.inference_mode()
    def step_fn(params, images, labels):
        images, labels = local_rows(mesh, images), local_rows(mesh, labels)
        logits = vit.apply(params, images, cfg, train=False, mesh=mesh)
        metrics = {"loss": cross_entropy(logits, labels),
                   **topk_accuracy(logits, labels)}
        return mean_over_data(metrics, mesh)

    return step_fn
