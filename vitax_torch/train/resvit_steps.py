"""Residual-ViT eval step and metrics (counterpart of
vitax/train/resvit_steps.py, its eval half).

`make_eval_step` mirrors the reference's valid_epoch (res-vit/train.py:
107-216): argmax routing, the class loss over the real samples of a padded
batch, a_loss and d_loss reported as 0 as the reference reports them, top-1
and top-5 accuracy, the active ratio and the router entropy. The train step
(the three-term loss, clipping, AdamW with the LoRA mask) comes with Res-ViT
training (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from vitax_torch.core.config import ResViTConfig
from vitax_torch.models import resvit
from vitax_torch.train.steps import topk_accuracy


class Lambdas(NamedTuple):
    """Loss weights (res-vit/config.py:161-163 defaults)."""
    classification: float = 1.0
    active: float = 1e-4
    distill: float = 0.01


def _metrics(cfg: ResViTConfig, logits, labels, c, a, d, aux,
             weight=None) -> Dict[str, torch.Tensor]:
    acts = aux["acts"]  # [B, N, L]
    out = {
        "c_loss": c, "a_loss": a, "d_loss": d,
        "router_entropy": aux["r_entropy"],
        **resvit.active_metric(acts, cfg.dynamic_active_target,
                               cfg.dynamic_reserve_initials),
        # per-layer activation rates (res-vit/train.py:41-49)
        "layer_activation_rates": acts[:, cfg.dynamic_reserve_initials:, :]
        .mean(dim=(0, 1)),
    }
    if weight is None:
        out.update(topk_accuracy(logits, labels))
    else:
        top = logits.float().topk(5, dim=-1).indices
        correct = top == labels[:, None]
        wsum = weight.sum().clamp_min(1.0)
        out["acc1"] = (correct[:, 0].float() * weight).sum() / wsum
        out["acc5"] = (correct.any(dim=-1).float() * weight).sum() / wsum
    return out


def weighted_nll(logits: torch.Tensor, labels: torch.Tensor,
                 weight: torch.Tensor) -> torch.Tensor:
    """Mean class loss over the real samples of a padded batch, fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels[:, None].long())[:, 0]
    return (nll * weight).sum() / weight.sum().clamp_min(1.0)


def make_eval_step(cfg: ResViTConfig, lambdas: Lambdas = Lambdas()):
    """(params, images, labels, weight) → (metrics, routing maps), no
    grad."""

    @torch.inference_mode()
    def step_fn(params, images, labels, weight):
        logits, aux = resvit.apply(params, images, cfg, train=False)
        zero = torch.zeros((), device=logits.device)
        c = weighted_nll(logits, labels, weight)
        m = _metrics(cfg, logits, labels, c, zero, zero, aux, weight=weight)
        m["loss"] = lambdas.classification * c
        return m, aux["routing_maps"]

    return step_fn
