"""Metric tracking — running averages with the reference's surface
(copied from vitax/utils/metrics.py; framework-free).

`MetricTracker` mirrors src/utils.py:79-100 / res-vit/utils.py:68-89 (pandas
running mean keyed by metric name, optional writer hookup) without the pandas
dependency; `result()` returns the same {metric: mean} dict shape.
"""

from __future__ import annotations

from typing import Dict, Iterable


class MetricTracker:
    def __init__(self, *keys: str, writer=None):
        self.writer = writer
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._keys = list(keys)
        self.reset()

    def reset(self) -> None:
        for k in self._keys:
            self._totals[k] = 0.0
            self._counts[k] = 0

    def update(self, key: str, value: float, n: int = 1) -> None:
        if key not in self._totals:
            self._totals[key] = 0.0
            self._counts[key] = 0
            self._keys.append(key)
        self._totals[key] += float(value) * n
        self._counts[key] += n
        if self.writer is not None:
            self.writer.add_scalar(key, float(value))

    def avg(self, key: str) -> float:
        c = self._counts.get(key, 0)
        return self._totals.get(key, 0.0) / c if c else 0.0

    def result(self) -> Dict[str, float]:
        return {k: self.avg(k) for k in self._keys}

    def keys(self) -> Iterable[str]:
        return tuple(self._keys)
