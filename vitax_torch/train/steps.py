"""Train and eval steps of the standard ViT (counterpart of
vitax/train/steps.py).

The reference's per-batch loop body (forward, CE loss, backward, SGD step,
scheduler step, accuracy) as one function. vitax jits it into one XLA
program; here it runs eagerly, and on CUDA the encoder's forward and
backward go through the hand-written kernels (models/vit.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from vitax_torch.core.config import ViTConfig
from vitax_torch.models import vit
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


def make_train_step(cfg: ViTConfig, optimizer: torch.optim.Optimizer,
                    scheduler: Any, clip_grad_norm: Optional[float] = None):
    """(state, images, labels) → (state, metrics): forward, CE, backward,
    optional global-norm clip, optimizer step, scheduler step. images are
    NHWC in the compute dtype, labels int. The parameters are updated in
    place; their grads stay readable until the next step."""

    def step_fn(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        optimizer.zero_grad(set_to_none=True)
        logits = vit.apply(state.params, images, cfg, train=True,
                           gen=state.gen)
        loss = cross_entropy(logits, labels)
        loss.backward()
        if clip_grad_norm is not None:
            torch.nn.utils.clip_grad_norm_(param_leaves(state.params),
                                           clip_grad_norm)
        optimizer.step()
        step_scheduler(scheduler)
        state.step += 1
        with torch.no_grad():
            metrics = {"loss": loss.detach(),
                       **topk_accuracy(logits.detach(), labels)}
        return state, metrics

    return step_fn


def make_eval_step(cfg: ViTConfig):
    """(params, images, labels) → metrics dict, no grad."""

    @torch.inference_mode()
    def step_fn(params, images, labels):
        logits = vit.apply(params, images, cfg, train=False)
        return {"loss": cross_entropy(logits, labels),
                **topk_accuracy(logits, labels)}

    return step_fn
