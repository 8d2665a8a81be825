"""Checkpoint store: save and restore the full training state
(counterpart of vitax/checkpointing/store.py, with `torch.save` in place of
orbax/npz).

A checkpoint `<dir>/<name>/` holds `state.pt` — the parameter tree, the
optimizer's and the scheduler's state dicts, the step and the generator
state — and `vitax_meta.json` (epoch, metrics). `restore` writes them back
into a live `TrainState`, so `--resume` continues exactly.
`save_model` keeps the reference's current/best naming.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import torch


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.detach().cpu().clone()


def _copy_into(target: Any, src: Any, where: str = "params") -> None:
    if isinstance(target, dict):
        if set(target) != set(src):
            raise KeyError(f"checkpoint {where} has keys {sorted(src)}, "
                           f"expected {sorted(target)}")
        for k in target:
            _copy_into(target[k], src[k], f"{where}/{k}")
    elif isinstance(target, list):
        if len(target) != len(src):
            raise KeyError(f"checkpoint {where} has {len(src)} entries, "
                           f"expected {len(target)}")
        for i, (t, s) in enumerate(zip(target, src)):
            _copy_into(t, s, f"{where}/{i}")
    else:
        if tuple(target.shape) != tuple(src.shape):
            raise ValueError(f"checkpoint {where} has shape "
                             f"{tuple(src.shape)}, expected "
                             f"{tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(src)


class CheckpointStore:
    """Directory of named checkpoints, each one training state + metadata."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def save(self, name: str, state, metadata: Optional[dict] = None) -> str:
        path = self._path(name)
        tmp = f"{path}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"step": state.step, "params": _to_cpu(state.params),
                    "optimizer": state.optimizer.state_dict(),
                    "scheduler": state.scheduler.state_dict(),
                    "gen": state.gen.get_state()},
                   os.path.join(tmp, "state.pt"))
        with open(os.path.join(tmp, "vitax_meta.json"), "w") as f:
            json.dump(metadata or {}, f, indent=2, default=str)
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        return path

    def restore(self, name: str, state):
        """Load checkpoint `name` into `state` (same model and optimizer
        layout) and return it."""
        blob = torch.load(os.path.join(self._path(name), "state.pt"),
                          map_location="cpu", weights_only=False)
        _copy_into(state.params, blob["params"])
        state.optimizer.load_state_dict(blob["optimizer"])
        state.scheduler.load_state_dict(blob["scheduler"])
        state.gen.set_state(blob["gen"])
        state.step = int(blob["step"])
        return state

    def restore_params(self, name: str, params: Any) -> Any:
        """Load only the parameters of checkpoint `name` into `params` (the
        same layout; an eval has no optimizer) and return them."""
        blob = torch.load(os.path.join(self._path(name), "state.pt"),
                          map_location="cpu", weights_only=False)
        _copy_into(params, blob["params"])
        return params

    def metadata(self, name: str) -> dict:
        p = os.path.join(self._path(name), "vitax_meta.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {}

    def exists(self, name: str) -> bool:
        return os.path.isdir(self._path(name))

    def save_model(self, state, epoch: int, is_best: bool = False,
                   metrics: Optional[dict] = None) -> None:
        """Always overwrite `current`; copy it to `best` when val acc
        improved (the reference's current/best saves)."""
        self.save("current", state, {"epoch": epoch, **(metrics or {})})
        if is_best:
            best = self._path("best")
            shutil.rmtree(best, ignore_errors=True)
            shutil.copytree(self._path("current"), best)
