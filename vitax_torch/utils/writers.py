"""Experiment writers: TensorBoard / SwanLab shims + console fallback
(copied from vitax/utils/writers.py, with the `warnings` import the original
lacks).

Same observable contract as the reference's writers (src/utils.py:103-308,
res-vit/utils.py:91-138): `set_step(step, mode)` then `add_scalar(tag, value)`
logs under `{tag}/{mode}`, with a derived `steps_per_sec` scalar computed from
wall-clock deltas (src/utils.py:138-146). Backends are optional imports —
when neither tensorboard nor swanlab is installed the writer degrades to a
no-op (metrics still flow to MetricTracker/console).
"""

from __future__ import annotations

import time
import warnings


class NullBackend:
    def add_scalar(self, tag, value, step): pass
    def add_scalars(self, tag, values, step): pass
    def add_image(self, tag, img, step): pass
    def add_histogram(self, tag, values, step): pass
    def flush(self): pass
    def close(self): pass


class TensorboardBackend:
    def __init__(self, logdir: str):
        from torch.utils.tensorboard import SummaryWriter  # optional dep
        self._w = SummaryWriter(logdir)

    def add_scalar(self, tag, value, step):
        self._w.add_scalar(tag, value, step)

    def add_scalars(self, tag, values, step):
        self._w.add_scalars(tag, values, step)

    def add_image(self, tag, img, step):
        self._w.add_image(tag, img, step)

    def add_histogram(self, tag, values, step):
        self._w.add_histogram(tag, values, step)

    def flush(self):
        self._w.flush()

    def close(self):
        self._w.close()


class SwanlabBackend:
    def __init__(self, project: str, exp_name: str, logdir: str):
        import swanlab  # optional dep
        self._sl = swanlab
        swanlab.init(project=project, experiment_name=exp_name, logdir=logdir)

    def add_scalar(self, tag, value, step):
        self._sl.log({tag: value}, step=step)

    def add_scalars(self, tag, values, step):
        self._sl.log({f"{tag}/{k}": v for k, v in values.items()}, step=step)

    def add_image(self, tag, img, step):
        self._sl.log({tag: self._sl.Image(img)}, step=step)

    def add_histogram(self, tag, values, step):
        # swanlab shim parity (src/utils.py:259-276): log summary stats
        import numpy as _np
        v = _np.asarray(values)
        self._sl.log({f"{tag}/mean": float(v.mean()),
                      f"{tag}/std": float(v.std())}, step=step)

    def flush(self): pass

    def close(self):
        self._sl.finish()


class ExperimentWriter:
    """Mode-tagged scalar writer with steps_per_sec tracking."""

    def __init__(self, logdir: str, backend: str = "none",
                 project: str = "vision-transformer",
                 exp_name: str = "exp"):
        self.step = 0
        self.mode = ""
        self._timer = time.time()
        if backend == "tensorboard":
            try:
                self._b = TensorboardBackend(logdir)
            except Exception as e:
                warnings.warn(
                    f"tensorboard writer init failed ({e!r}); metrics will "
                    "NOT be logged — falling back to the no-op backend")
                self._b = NullBackend()
        elif backend == "swanlab":
            try:
                self._b = SwanlabBackend(project, exp_name, logdir)
            except Exception as e:
                warnings.warn(
                    f"swanlab writer init failed ({e!r}); metrics will "
                    "NOT be logged — falling back to the no-op backend")
                self._b = NullBackend()
        else:
            self._b = NullBackend()

    def set_step(self, step: int, mode: str = "train") -> None:
        self.mode = mode
        self.step = step
        if step == 0:
            self._timer = time.time()
        else:
            now = time.time()
            dt = now - self._timer
            if dt > 0:
                self.add_scalar("steps_per_sec", 1.0 / dt)
            self._timer = now

    def _tag(self, tag: str) -> str:
        return f"{tag}/{self.mode}" if self.mode else tag

    def add_scalar(self, tag: str, value: float) -> None:
        self._b.add_scalar(self._tag(tag), value, self.step)

    def add_scalars(self, tag: str, values: dict) -> None:
        self._b.add_scalars(self._tag(tag), values, self.step)

    def add_image(self, tag: str, img) -> None:
        self._b.add_image(self._tag(tag), img, self.step)

    def flush(self) -> None:
        self._b.flush()

    def close(self) -> None:
        self._b.close()
