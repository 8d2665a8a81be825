"""Residual-ViT train and eval steps (counterpart of
vitax/train/resvit_steps.py).

`make_train_step` is the reference's loop body (res-vit/train.py:23-86):
forward (teacher + student), the 3-term loss `λc·c + λa·a + λd·d` (:51-52),
backward, global-norm clip 1.0 over the trainable leaves (:64-65), the AdamW
update, the metrics (loss terms, router entropy, top-1/5, active ratio,
per-layer activation rates :41-49). λ values are constants across training,
as the reference reads them once (res-vit/train.py:296). `make_eval_step`
mirrors its valid_epoch (:107-216): argmax routing, the class loss over the
real samples of a padded batch, a_loss and d_loss reported as 0 as the
reference reports them. `make_adamw_for` is AdamW with the LoRA trainable
mask and the router's lr scale.

Under a mesh (vitax's `make_train_step(..., mesh=)`, resvit_steps.py:68-79;
a data axis only, `resvit.apply` refuses a model axis) each rank runs its
rows of the global batch, with the Gumbel noise and kept tokens of the
global batch cut by data index; the grads are summed over the data group
and divided by its size, and the active loss, a square of the batch's mean
keep probability, takes the global mean's value with this rank's gradient,
so that the summed grads are the global loss's. The metrics are the global
batch's, in training and eval.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from vitax_torch.core.config import ResViTConfig
from vitax_torch.models import resvit
from vitax_torch.parallel.distributed import all_reduce
from vitax_torch.parallel.mesh import Mesh, local_rows
from vitax_torch.train.optim import (adamw, param_leaves, step_scheduler,
                                     tree_leaves)
from vitax_torch.train.steps import (TrainState, average_grads,
                                     cross_entropy, mean_over_data,
                                     topk_accuracy, weighted_means)


class Lambdas(NamedTuple):
    """Loss weights (res-vit/config.py:161-163 defaults)."""
    classification: float = 1.0
    active: float = 1e-4
    distill: float = 0.01


class AdamW(NamedTuple):
    """`make_adamw_for`'s optimizer: AdamW over the trainable leaves, its LR
    scheduler, those leaves (the clip's) and the clip norm (None: off)."""
    optimizer: torch.optim.Optimizer
    scheduler: Any
    trainable: list
    clip_grad_norm: Optional[float]


def make_adamw_for(cfg: ResViTConfig, params: Any, lr_schedule,
                   betas=(0.9, 0.999), eps: float = 1e-8,
                   weight_decay: float = 0.05,
                   clip_grad_norm: Optional[float] = 1.0,
                   router_lr_scale: float = 1.0) -> AdamW:
    """AdamW with the LoRA trainable mask (res-vit/train.py:272-277 builds
    the optimizer over `filter(requires_grad)`): frozen leaves stay out of it
    and out of the clip. `router_lr_scale` scales the router params'
    learning rate (vitax's post-Adam scaling of their update)."""
    mask = resvit.trainable_mask(params, cfg)

    def scale(tree, router=False):
        if isinstance(tree, dict):
            return {k: scale(v, router or k == "router")
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [scale(v, router) for v in tree]
        return router_lr_scale if router else 1.0

    # base lr 1: each group's lr is its scale times the schedule's value
    opt, sched = adamw(params, lr_schedule, 1.0, betas=betas, eps=eps,
                       weight_decay=weight_decay, mask=mask,
                       lr_scale=scale(params))
    trainable = [t for t, m in zip(param_leaves(params), tree_leaves(mask))
                 if m]
    return AdamW(opt, sched, trainable, clip_grad_norm)


def create_state(params: Any, tx: AdamW, gen: torch.Generator) -> TrainState:
    """The train state; the trainable leaves require grad, the frozen ones
    not (no grad reaches them, as vitax's set_to_zero gives them none)."""
    trainable = {id(t) for t in tx.trainable}
    for t in param_leaves(params):
        t.requires_grad_(id(t) in trainable)
    return TrainState(step=0, params=params, optimizer=tx.optimizer,
                      scheduler=tx.scheduler, gen=gen)


def _metrics(cfg: ResViTConfig, logits, labels, c, a, d, aux,
             weight=None) -> Dict[str, torch.Tensor]:
    """The step's metrics. With `weight` [B] (a padded batch's row weights)
    every mean is over the real rows only: accuracies, the active ratio, the
    router entropy and the per-layer activation rates."""
    res = cfg.dynamic_reserve_initials
    acts = aux["acts"][:, res:, :].float()  # [B, N - res, L]
    if weight is None:
        entropy = aux["r_entropy"]
        rates = acts.mean(dim=(0, 1))
    else:
        wsum = weight.sum().clamp_min(1.0)
        entropy = (aux["r_entropy_rows"] * weight).sum() / wsum
        rates = (acts.mean(dim=1) * weight[:, None]).sum(dim=0) / wsum
    out = {
        "c_loss": c, "a_loss": a, "d_loss": d,
        "router_entropy": entropy,
        **resvit.active_metric(aux["acts"], cfg.dynamic_active_target, res,
                               weight),
        # per-layer activation rates (res-vit/train.py:41-49)
        "layer_activation_rates": rates,
    }
    if weight is None:
        out.update(topk_accuracy(logits, labels))
    else:
        top = logits.float().topk(5, dim=-1).indices
        correct = top == labels[:, None]
        out["acc1"] = (correct[:, 0].float() * weight).sum() / wsum
        out["acc5"] = (correct.any(dim=-1).float() * weight).sum() / wsum
    return out


def weighted_nll(logits: torch.Tensor, labels: torch.Tensor,
                 weight: torch.Tensor) -> torch.Tensor:
    """Mean class loss over the real samples of a padded batch, fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels[:, None].long())[:, 0]
    return (nll * weight).sum() / weight.sum().clamp_min(1.0)


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach() if torch.is_tensor(tree) else tree


def _global_active_loss(soft_probs: torch.Tensor, cfg: ResViTConfig,
                        mesh: Mesh) -> torch.Tensor:
    """`resvit.active_loss` of the global batch under a mesh: the mean keep
    probability takes the data group's mean as its value (one all-reduce)
    and this rank's mean's gradient, so that the ranks' grads, summed and
    divided by n_data, are those of (global mean − target)²."""
    m = soft_probs[:, cfg.dynamic_reserve_initials:, :].float().mean()
    g = all_reduce(m.detach().clone(), mesh.data_group) / mesh.n_data
    return (m + (g - m.detach()) - cfg.dynamic_active_target) ** 2


def make_train_step(cfg: ResViTConfig, tx: AdamW,
                    lambdas: Lambdas = Lambdas(),
                    mesh: Optional[Mesh] = None):
    """(state, images NHWC, labels, noise=None) → (state, metrics). The
    parameters are updated in place. `noise`: `resvit.apply`'s, the Gumbel
    noise and kept tokens to use instead of drawing them from state.gen.
    `mesh`: images, labels and noise are the global batch's, of which this
    rank runs its rows."""

    def step_fn(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
                noise: Optional[Dict[str, Any]] = None):
        tx.optimizer.zero_grad(set_to_none=True)
        images, labels = local_rows(mesh, images), local_rows(mesh, labels)
        logits, aux = resvit.apply(state.params, images, cfg, train=True,
                                   gen=state.gen, noise=noise, mesh=mesh)
        c = cross_entropy(logits, labels)
        if cfg.use_reslr and aux["soft_probs"] is not None:
            a = (resvit.active_loss(aux["soft_probs"],
                                    cfg.dynamic_active_target,
                                    cfg.dynamic_reserve_initials)
                 if mesh is None else
                 _global_active_loss(aux["soft_probs"], cfg, mesh))
        else:
            a = torch.zeros((), device=logits.device)
        d = aux["d_loss"]
        total = (lambdas.classification * c + lambdas.active * a
                 + lambdas.distill * d)
        total.backward()
        if mesh is not None:
            average_grads(tx.trainable, mesh)
        if tx.clip_grad_norm is not None:
            torch.nn.utils.clip_grad_norm_(tx.trainable, tx.clip_grad_norm)
        tx.optimizer.step()
        step_scheduler(tx.scheduler)
        state.step += 1
        with torch.no_grad():
            metrics = mean_over_data(
                {"loss": total.detach(),
                 **_metrics(cfg, logits.detach(), labels, c.detach(),
                            a.detach(), d.detach(), _detach(aux))}, mesh)
        return state, metrics

    return step_fn


def make_eval_step(cfg: ResViTConfig, lambdas: Lambdas = Lambdas(),
                   mesh: Optional[Mesh] = None):
    """(params, images, labels, weight) → (metrics, routing maps), no
    grad. Under a mesh this rank's rows of the global batch (the routing
    maps its rows'), the metrics the global batch's: each rank's weighted
    means times its weight, summed over the data group."""

    @torch.inference_mode()
    def step_fn(params, images, labels, weight):
        images, labels, weight = (local_rows(mesh, t)
                                  for t in (images, labels, weight))
        logits, aux = resvit.apply(params, images, cfg, train=False,
                                   mesh=mesh)
        zero = torch.zeros((), device=logits.device)
        c = weighted_nll(logits, labels, weight)
        m = _metrics(cfg, logits, labels, c, zero, zero, aux, weight=weight)
        m["loss"] = lambdas.classification * c
        if mesh is not None:
            wsum = weight.sum()
            m = weighted_means({k: v * wsum for k, v in m.items()}, wsum,
                               mesh)
        return m, aux["routing_maps"]

    return step_fn
