"""vitax_torch.ops plain versions against vitax.ops, same numpy inputs.

Tolerances: fp32 1e-4 (both compute the same fp32 arithmetic; sums are
taken in another order); bf16 2e-2 (bf16 keeps 8 bits, ulp 2^-8 relative,
and one-ulp flips from the order of sums are allowed).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from vitax.ops import attention as jatt  # noqa: E402
from vitax.ops import layernorm as jln  # noqa: E402
from vitax.ops import mlp as jmlp  # noqa: E402
from vitax.ops import patchify as jpat  # noqa: E402
from vitax_torch.ops import attention as tatt  # noqa: E402
from vitax_torch.ops import layernorm as tln  # noqa: E402
from vitax_torch.ops import mlp as tmlp  # noqa: E402
from vitax_torch.ops import patchify as tpat  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]


def _pair(a, dtype):
    """The same values as a jax array and a torch tensor of `dtype`."""
    a = np.asarray(a, np.float32)
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _close(j, t, dtype):
    np.testing.assert_allclose(np.asarray(j.astype(jnp.float32)),
                               t.float().numpy(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_layer_norm_matches_vitax(dtype, eps):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal((3, 10, 128)) * 2 + 0.5, dtype)
    g = rng.standard_normal(128).astype(np.float32) * 0.1 + 1
    b = rng.standard_normal(128).astype(np.float32) * 0.1
    ref = jln.layer_norm_ref(xj, jnp.asarray(g), jnp.asarray(b), eps)
    out = tln.layer_norm(xt, torch.from_numpy(g), torch.from_numpy(b), eps)
    assert out.dtype == xt.dtype
    _close(ref, out, dtype)
    _close(ref, tln.layer_norm_ref(xt, torch.from_numpy(g),
                                   torch.from_numpy(b), eps), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mha_ref_bhsd_matches_vitax(dtype):
    rng = np.random.default_rng(1)
    pairs = [_pair(rng.standard_normal((2, 3, 17, 32)), dtype)
             for _ in range(3)]
    ref = jatt.mha_ref_bhsd(*(p[0] for p in pairs))
    out = tatt.mha_ref_bhsd(*(p[1] for p in pairs))
    _close(ref, out, dtype)
    # a CPU tensor takes the plain version even when the kernels are asked for
    _close(ref, tatt.multi_head_attention_bhsd(*(p[1] for p in pairs),
                                               use_kernels=True), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gelu_and_mlp_ref_match_vitax(dtype):
    rng = np.random.default_rng(2)
    aj, at = _pair(rng.standard_normal((4, 64)) * 3, dtype)
    _close(jmlp.gelu_exact(aj), tmlp.gelu_exact(at), dtype)
    xj, xt = _pair(rng.standard_normal((2, 5, 64)), dtype)
    w1 = rng.standard_normal((64, 128)).astype(np.float32) / 8
    b1 = rng.standard_normal(128).astype(np.float32) * 0.1
    w2 = rng.standard_normal((128, 64)).astype(np.float32) / 11
    b2 = rng.standard_normal(64).astype(np.float32) * 0.1
    ref = jmlp.mlp_ref(xj, *map(jnp.asarray, (w1, b1, w2, b2)))
    out = tmlp.mlp_ref(xt, *map(torch.from_numpy, (w1, b1, w2, b2)))
    _close(ref, out, dtype)


@pytest.mark.parametrize("hw,patch", [(48, 16), (40, 14)])
def test_extract_patches_is_exact(hw, patch):
    rng = np.random.default_rng(3)
    img = rng.standard_normal((2, hw, hw, 3)).astype(np.float32)
    ref = jpat.extract_patches(jnp.asarray(img), (patch, patch))
    out = tpat.extract_patches(torch.from_numpy(img), (patch, patch))
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())


@pytest.mark.parametrize("dtype", DTYPES)
def test_patchify_matmul_matches_vitax(dtype):
    rng = np.random.default_rng(4)
    img = rng.standard_normal((2, 48, 48, 3)).astype(np.float32)
    kernel = rng.standard_normal((16, 16, 3, 128)).astype(np.float32) / 27
    bias = rng.standard_normal(128).astype(np.float32) * 0.1
    ref = jpat.patchify_matmul(jnp.asarray(img), jnp.asarray(kernel),
                               jnp.asarray(bias), dtype=getattr(jnp, dtype))
    out = tpat.patchify_matmul(torch.from_numpy(img), torch.from_numpy(kernel),
                               torch.from_numpy(bias),
                               dtype=getattr(torch, dtype))
    assert out.dtype == getattr(torch, dtype)
    _close(ref, out, dtype)
