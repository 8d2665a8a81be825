"""Optimizers (counterpart of vitax/train/optim.py), as torch's own.

* `sgd_momentum`: `torch.optim.SGD(momentum=0.9, weight_decay=wd)` plus
  `OneCycleLR(max_lr, total_steps, pct_start, cycle_momentum=True)` — the
  reference's fine-tune setup, which vitax replicates by hand. torch's
  OneCycleLR raises when stepped past `total_steps`, while vitax's schedule
  holds min_lr from step total_steps-1 on; `step_scheduler` stops stepping
  there, which gives vitax's values. torch's scheduler also takes a narrower
  range of warmups than vitax's closed form: 0 <= warmup <= total_steps and
  warmup != 1 step (its first phase would be 0 steps long); others raise.
* `adamw`: `torch.optim.AdamW` with a `LambdaLR` over an LR schedule of
  train/schedules.py; the train step clips the global grad norm
  (`clip_grad_norm_`) before the update, as the reference does. With a
  `mask` the frozen leaves stay out of the optimizer, so nothing (no weight
  decay either) reaches them: vitax's `optax.multi_transform` with
  `set_to_zero`. With an `lr_scale` tree the leaves of another scale form
  their own parameter group at lr × scale: vitax's post-Adam
  `optax.scale` of a masked subtree (`router_lr_scale`), which for AdamW's
  decoupled update is the same as a scaled learning rate.

Both work on the flat list of fp32 parameter leaves (`param_leaves`).
"""

from __future__ import annotations

from typing import Callable, List

import torch

from vitax_torch.utils.memory import named_leaves


def param_leaves(params) -> List[torch.Tensor]:
    """The tensors of a parameter tree (dicts and lists), in `named_leaves`
    order."""
    return [t for _, t in named_leaves(params)]


def tree_leaves(tree) -> list:
    """The leaves of any tree of dicts and lists (bools, floats, tensors), in
    `named_leaves` order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [v for k in sorted(tree, key=str) for v in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for t in tree for v in tree_leaves(t)]
    return [tree]


def sgd_momentum(params, max_lr: float, total_steps: int, pct_start: float,
                 momentum: float = 0.9, weight_decay: float = 0.0):
    """(SGD, OneCycleLR) over `param_leaves(params)`."""
    if not 0.0 <= pct_start <= 1.0 or float(pct_start * total_steps) == 1.0:
        raise ValueError(
            f"OneCycleLR takes a warmup of 0 or 2..{total_steps} steps "
            f"(pct_start {pct_start} of {total_steps} steps)")
    opt = torch.optim.SGD(param_leaves(params), lr=max_lr, momentum=momentum,
                          weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.OneCycleLR(
        opt, max_lr=max_lr, total_steps=total_steps, pct_start=pct_start,
        cycle_momentum=True)
    return opt, sched


def adamw(params, lr_schedule: Callable[[int], float], base_lr: float,
          betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.05,
          mask=None, lr_scale=None):
    """(AdamW, LambdaLR following `lr_schedule`); pair with
    `make_train_step(..., clip_grad_norm=...)` for the reference's clip.
    `mask`: a tree of bools like `params` (False: frozen, left out);
    `lr_scale`: a tree of floats like `params` (one parameter group per
    scale, at lr × scale)."""
    leaves = param_leaves(params)
    keep = tree_leaves(mask) if mask is not None else [True] * len(leaves)
    scales = (tree_leaves(lr_scale) if lr_scale is not None
              else [1.0] * len(leaves))
    groups: dict = {}
    for t, k, sc in zip(leaves, keep, scales):
        if k:
            groups.setdefault(float(sc), []).append(t)
    opt = torch.optim.AdamW(
        [{"params": ts, "lr": base_lr * sc} for sc, ts in groups.items()],
        lr=base_lr, betas=betas, eps=eps, weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: lr_schedule(step) / base_lr)
    return opt, sched


def step_scheduler(sched) -> None:
    """Advance a scheduler by one step; a OneCycleLR stops at its last step
    (its value there is min_lr, which vitax's schedule holds)."""
    total = getattr(sched, "total_steps", None)
    if total is None or sched.last_epoch < total - 1:
        sched.step()
