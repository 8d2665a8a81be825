"""vitax_torch.core against vitax.core: presets, dataset table, seeding."""

import dataclasses
import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from vitax.core import config as jc  # noqa: E402
from vitax.core import prng as jprng  # noqa: E402
from vitax_torch.core import config as tc  # noqa: E402
from vitax_torch.core import prng as tprng  # noqa: E402


def _norm(v):
    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    if isinstance(v, type):
        return np.dtype(v).name  # jnp.bfloat16 / jnp.float32
    return v


def _fields(cfg):
    return {f.name: _norm(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", sorted(jc.ARCH_PRESETS))
def test_arch_presets_equal_field_by_field(arch):
    assert tc.ARCH_PRESETS[arch] == jc.ARCH_PRESETS[arch]
    for image_size, ncls in ((224, 1000), (384, 10)):
        a = jc.arch_config(arch, image_size, ncls)
        b = tc.arch_config(arch, image_size, ncls)
        assert _fields(a) == _fields(b)
        for prop in ("grid", "num_patches", "seq_len", "head_dim"):
            assert getattr(a, prop) == getattr(b, prop)


def test_defaults_and_tables_equal():
    assert _fields(jc.ViTConfig()) == _fields(tc.ViTConfig())
    assert tc.DATASET_NUM_CLASSES == jc.DATASET_NUM_CLASSES
    for ds in list(jc.DATASET_NUM_CLASSES) + ["Unknown"]:
        assert tc.num_classes_for_dataset(ds) == jc.num_classes_for_dataset(ds)
    with pytest.raises(ValueError):
        tc.arch_config("b8")
    with pytest.raises(ValueError):
        tc.ViTConfig(token_keep=0.0)


def test_set_seed_seeds_host_rngs_and_returns_generator():
    jprng.set_seed(7)
    ref = (random.random(), np.random.rand())
    gen = tprng.set_seed(7)
    assert (random.random(), np.random.rand()) == ref
    assert isinstance(gen, torch.Generator)
    a = torch.randn(4, generator=gen)
    assert torch.equal(a, torch.randn(4, generator=tprng.set_seed(7)))
