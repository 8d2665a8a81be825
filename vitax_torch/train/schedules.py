"""Learning-rate schedules (counterpart of vitax/train/schedules.py).

Plain-python closed forms of the reference's schedulers, step → value:
  * `onecycle_lr` / `onecycle_momentum`: torch's `OneCycleLR` (cos anneal,
    two phases, `cycle_momentum=True`), clamped at the end values past
    `total_steps` as vitax's are (torch's own scheduler raises there);
  * `cosine_with_warmup_lr`: HF `get_cosine_schedule_with_warmup`;
  * `cosine_annealing_lr`: torch's `CosineAnnealingLR` closed form.
The port's optimizers use torch's schedulers (train/optim.py); these are the
tables they are held against, and the LR lambda of `adamw`.
`token_keep_switch_epoch` is framework-free and copied from vitax.
"""

from __future__ import annotations

import math
from typing import Callable


def _clip01(v: float) -> float:
    return min(1.0, max(0.0, v))


def _cos_anneal(start: float, end: float, pct: float) -> float:
    """Cosine interpolation from `start` (pct=0) to `end` (pct=1)."""
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)


def _onecycle(start: float, peak: float, end: float, total_steps: int,
              pct_start: float) -> Callable[[int], float]:
    up_end = float(pct_start * total_steps) - 1.0
    down_end = float(total_steps) - 1.0

    def schedule(step) -> float:
        step = float(step)
        if step <= up_end:
            return _cos_anneal(start, peak, _clip01(step / max(up_end, 1e-9)))
        return _cos_anneal(peak, end, _clip01(
            (step - up_end) / max(down_end - up_end, 1e-9)))

    return schedule


def onecycle_lr(max_lr: float, total_steps: int, pct_start: float,
                div_factor: float = 25.0,
                final_div_factor: float = 1e4) -> Callable[[int], float]:
    """OneCycle LR: initial_lr → max_lr over pct_start·total steps, then
    max_lr → min_lr, both cosine."""
    initial_lr = max_lr / div_factor
    return _onecycle(initial_lr, max_lr, initial_lr / final_div_factor,
                     total_steps, pct_start)


def onecycle_momentum(total_steps: int, pct_start: float,
                      base_momentum: float = 0.85,
                      max_momentum: float = 0.95) -> Callable[[int], float]:
    """Momentum cycle paired with `onecycle_lr`: max → base during warmup,
    base → max during the anneal."""
    return _onecycle(max_momentum, base_momentum, max_momentum, total_steps,
                     pct_start)


def cosine_with_warmup_lr(base_lr: float, warmup_steps: int, total_steps: int,
                          num_cycles: float = 0.5,
                          min_lr: float = 0.0) -> Callable[[int], float]:
    """HF `get_cosine_schedule_with_warmup`: linear 0 → base over warmup, then
    base · max(0, 0.5·(1 + cos(2π·cycles·progress)))."""

    def schedule(step) -> float:
        step = float(step)
        if step < warmup_steps:
            factor = step / max(1.0, float(warmup_steps))
        else:
            progress = (step - warmup_steps) / max(
                1.0, float(total_steps - warmup_steps))
            factor = max(0.0, 0.5 * (1.0 + math.cos(
                math.pi * 2.0 * num_cycles * progress)))
        return max(base_lr * factor, min_lr)

    return schedule


def cosine_annealing_lr(base_lr: float, t_max: int,
                        eta_min: float = 0.0) -> Callable[[int], float]:
    """torch `CosineAnnealingLR` closed form:
    eta_min + (base − eta_min)·(1 + cos(π·t/T_max))/2."""

    def schedule(step) -> float:
        return eta_min + (base_lr - eta_min) * (
            1.0 + math.cos(math.pi * float(step) / t_max)) / 2.0

    return schedule


def token_keep_switch_epoch(sched, token_keep: float, epochs: int) -> int:
    """Validate a --token-keep-schedule request and return the epoch the
    dense tail starts at (== epochs when no schedule is requested).

    The PatchDropout fine-tune recipe trains dropped for the first `sched`
    fraction of epochs and full-sequence for the rest (arXiv:2208.07220
    §4.4); the switch is at an epoch boundary."""
    if sched is None:
        return epochs
    if not (0.0 < sched <= 1.0):
        raise ValueError(f"--token-keep-schedule must be in (0,1], "
                         f"got {sched}")
    if token_keep >= 1.0:
        raise ValueError(
            "--token-keep-schedule requires --token-keep < 1.0 "
            "(the schedule switches FROM the dropped phase TO dense)")
    if epochs < 2:
        raise ValueError(
            f"--token-keep-schedule needs >= 2 epochs to fit both phases; "
            f"this run has {epochs} (train_steps // len(train_loader)) — "
            f"raise --train-steps or drop the schedule flag")
    # clamp so the dense tail always gets at least one epoch
    return min(max(1, int(round(sched * epochs))), epochs - 1)
