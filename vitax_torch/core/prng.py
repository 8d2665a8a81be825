"""Seeding.

Counterpart of `vitax/core/prng.py:19`: seed the host RNGs (python and numpy,
which order the data) and hand back an explicit `torch.Generator` for
parameter init. The port draws from no global torch RNG. For one seed, its
numbers are not jax.random's, so tests build shared inputs with numpy.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_seed(seed: int = 42) -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return torch.Generator().manual_seed(seed)
