"""Experiment directory layout + config processing.

Reproduces the reference contract (src/utils.py:56-76, res-vit/utils.py:45-65):

    experiments/tb/<exp>/                      tensorboard logs
    experiments/save/<exp>/checkpoints/        model checkpoints
    experiments/save/<exp>/results/            metric CSVs / routing viz
    experiments/save/<exp>/config.json         full config dump

with `<exp> = {exp_name}_{dataset}_bs{batch}_lr{lr}_wd{wd}_{yymmdd_HHMMSS}`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from datetime import datetime
from typing import Any


def ensure_dir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def write_json(obj: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=4, sort_keys=False, default=str)


def read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def experiment_name(exp_name: str, dataset: str, batch_size, lr, wd,
                    timestamp: str = None) -> str:
    ts = timestamp or datetime.now().strftime("%y%m%d_%H%M%S")
    return f"{exp_name}_{dataset}_bs{batch_size}_lr{lr}_wd{wd}_{ts}"


def process_config(config: Any, root: str = "experiments",
                   write: bool = True) -> Any:
    """Create the experiment directory tree and dump config.json; annotates
    the config object with summary_dir / checkpoint_dir / result_dir. With
    `write` False (a data-parallel rank other than 0) only the
    annotation."""
    d = config if isinstance(config, dict) else vars(config)
    exp = experiment_name(d.get("exp_name", "exp"), d.get("dataset", "ds"),
                          d.get("batch_size", 0), d.get("lr", 0),
                          d.get("wd", d.get("weight_decay", 0)))
    summary_dir = os.path.join(root, "tb", exp)
    save_root = os.path.join(root, "save", exp)
    checkpoint_dir = os.path.join(save_root, "checkpoints")
    result_dir = os.path.join(save_root, "results")
    if write:
        for p in (summary_dir, checkpoint_dir, result_dir):
            ensure_dir(p)
        d_out = dict(d)
        d_out.update(summary_dir=summary_dir, checkpoint_dir=checkpoint_dir,
                     result_dir=result_dir)
        write_json(d_out, os.path.join(save_root, "config.json"))
    if isinstance(config, dict):
        config.update(summary_dir=summary_dir, checkpoint_dir=checkpoint_dir,
                      result_dir=result_dir)
    else:
        config.summary_dir = summary_dir
        config.checkpoint_dir = checkpoint_dir
        config.result_dir = result_dir
    return config


def config_to_dict(config: Any) -> dict:
    if dataclasses.is_dataclass(config):
        return dataclasses.asdict(config)
    if isinstance(config, dict):
        return dict(config)
    return dict(vars(config))
