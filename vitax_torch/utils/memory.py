"""Device memory introspection (counterpart of vitax/utils/memory.py) over
`torch.cuda.memory_stats`.

Model/gradient/optimizer sizes are computed exactly from the tensors; live
device usage comes from the CUDA caching allocator where a card is present.
"""

from __future__ import annotations

from typing import Any, Optional

import torch


def named_leaves(tree: Any, path: str = ""):
    """(path, tensor) pairs of a tree of dicts, lists and tensors, in a fixed
    order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from named_leaves(tree[k], f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{path}/{i}" if path else str(i))
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def tree_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for _, t in named_leaves(tree))


def device_memory_stats(device=None) -> Optional[dict]:
    """The allocator's live and peak bytes, or None without a card."""
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
            "bytes_limit": torch.cuda.get_device_properties(
                device or 0).total_memory}


def format_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024:
            return f"{n:.2f} {unit}"
        n /= 1024
    return f"{n:.2f} TiB"


def log_model_layers(params: Any, log=print) -> int:
    """Per-leaf shape/param-count report (the reference's
    `log_model_layers`). Returns the total parameter count."""
    total = 0
    for key, leaf in named_leaves(params):
        n = leaf.numel()
        total += n
        log(f"  {key:<60} {str(tuple(leaf.shape)):<20} {n:>12,}")
    log(f"  {'TOTAL':<60} {'':<20} {total:>12,}")
    return total


def print_memory_usage(params: Any = None, optimizer=None, grads: Any = None,
                       log=print) -> dict:
    """Model / optimizer / grad sizes plus live device stats."""
    report = {}
    if params is not None:
        report["model_bytes"] = tree_bytes(params)
    if optimizer is not None:
        report["optimizer_bytes"] = tree_bytes(
            [list(s.values()) for s in optimizer.state.values()])
    if grads is not None:
        report["gradient_bytes"] = tree_bytes(grads)
    stats = device_memory_stats()
    if stats:
        report.update(stats)
    for k, v in report.items():
        log(f"  {k:>20}: {format_bytes(v)}")
    return report
