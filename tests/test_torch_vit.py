"""vitax_torch.models.vit against vitax.models.vit on the same weights.

vitax's parameters (perturbed with numpy noise so no bias or LN vector is
trivial) go through `params_from_jax`; both packages run the same images.
The fused path on the vitax side runs its Pallas kernels in interpret mode;
on the port's side, CPU tensors take the kernels' plain twins. The small
config (image 48, patch 16: seq 10 → spq 16) engages the padded stream.
Tolerances: fp32 1e-4; bf16 2e-2.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from vitax.core.config import arch_config as j_arch  # noqa: E402
from vitax.models import vit as jvit  # noqa: E402
from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax.train_cli import make_weighted_eval_step as j_eval_step  # noqa: E402
from vitax_torch.core.config import arch_config as t_arch  # noqa: E402
from vitax_torch.core.prng import set_seed  # noqa: E402
from vitax_torch.eval_cli import make_weighted_eval_step as t_eval_step  # noqa: E402
from vitax_torch.models import vit as tvit  # noqa: E402

SMALL = dict(emb_dim=128, mlp_dim=256, num_heads=2, num_layers=2)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _cfgs(dtype, fused):
    kw = dict(fused_qkv=fused, fused_mlp=fused, use_pallas=fused)
    jc = j_arch("tiny", 48, 10).replace(dtype=getattr(jnp, dtype), **SMALL,
                                         **kw)
    tc = t_arch("tiny", 48, 10).replace(dtype=getattr(torch, dtype), **SMALL,
                                         **kw)
    return jc, tc


@pytest.fixture(scope="module")
def weights():
    jc, _ = _cfgs("float32", True)
    p = jax.tree.map(np.asarray, jvit.init_params(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        p)


def _images(batch, seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (batch, 48, 48, 3)).astype(np.float32)


def _logits_pair(weights, dtype, fused, batch):
    jc, tc = _cfgs(dtype, fused)
    img = _images(batch)
    ref = jvit.apply(jax.tree.map(jnp.asarray, weights),
                     jnp.asarray(img, jc.dtype), jc)
    with torch.inference_mode():
        out = tvit.apply(tvit.params_from_jax(weights),
                         torch.from_numpy(img).to(tc.dtype), tc)
    return np.asarray(ref, np.float32), out.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3])
def test_fused_forward_matches_vitax(weights, dtype, batch):
    ref, out = _logits_pair(weights, dtype, True, batch)
    assert out.shape == (batch, 10) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_vitax_xla_path(weights, dtype):
    ref, out = _logits_pair(weights, dtype, False, 3)
    np.testing.assert_allclose(out, ref, rtol=TOL[dtype], atol=TOL[dtype])


def test_padded_stream_engages_only_with_both_fused_halves(weights):
    _, tc = _cfgs("float32", True)
    params = tvit.params_from_jax(weights)
    x = tvit.embed(params, torch.from_numpy(_images(2)), tc)
    assert x.shape == (2, 10, 128)
    assert tvit._padded_stream_len(x, params, tc) == 16
    assert tvit._padded_stream_len(x, params, tc.replace(fused_mlp=False)) \
        is None


def test_params_from_jax_unstacks_layers(weights):
    params = tvit.params_from_jax(weights)
    assert len(params["layers"]) == 2
    for i, lp in enumerate(params["layers"]):
        np.testing.assert_array_equal(
            lp["attn"]["query"]["kernel"].numpy(),
            weights["layers"]["attn"]["query"]["kernel"][i])
        np.testing.assert_array_equal(
            lp["mlp"]["fc2"]["bias"].numpy(),
            weights["layers"]["mlp"]["fc2"]["bias"][i])
    np.testing.assert_array_equal(params["embedding"]["kernel"].numpy(),
                                  weights["embedding"]["kernel"])


def test_init_params_has_vitax_layout():
    jc, tc = _cfgs("float32", True)
    jp = jvit.init_params(jax.random.PRNGKey(0), jc)
    tp = tvit.init_params(set_seed(0), tc)
    layer0 = jax.tree.map(lambda a: a[0], jp["layers"])
    top = {k: v for k, v in jp.items() if k != "layers"}
    shapes = jax.tree.map(lambda a: tuple(a.shape), top)
    assert shapes == jax.tree.map(lambda a: tuple(a.shape),
                                  {k: v for k, v in tp.items()
                                   if k != "layers"})
    assert jax.tree.map(lambda a: tuple(a.shape), layer0) == \
        jax.tree.map(lambda a: tuple(a.shape), tp["layers"][0])
    assert len(tp["layers"]) == jc.num_layers


def test_apply_nchw_and_embed(weights):
    jc, tc = _cfgs("float32", True)
    params = tvit.params_from_jax(weights)
    img = torch.from_numpy(_images(2))
    with torch.inference_mode():
        a = tvit.apply(params, img, tc)
        b = tvit.apply_nchw(params, img.permute(0, 3, 1, 2), tc)
    torch.testing.assert_close(a, b)
    ref = jvit.embed(jax.tree.map(jnp.asarray, weights),
                     jnp.asarray(img.numpy()), jc)
    np.testing.assert_allclose(tvit.embed(params, img, tc).numpy(),
                               np.asarray(ref), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        tvit.embed(params, img[:, :32], tc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_eval_step_matches_vitax(weights, dtype):
    jc, tc = _cfgs(dtype, True)
    img = _images(4, seed=5)
    labels = np.array([3, 1, 4, 1], np.int32)
    weight = np.array([1, 1, 1, 0], np.float32)  # padded final row
    ref = j_eval_step(jc)(jax.tree.map(jnp.asarray, weights),
                          jnp.asarray(img, jc.dtype), jnp.asarray(labels),
                          jnp.asarray(weight))
    out = t_eval_step(tc)(tvit.params_from_jax(weights),
                          torch.from_numpy(img).to(tc.dtype),
                          torch.from_numpy(labels), torch.from_numpy(weight))
    for k in ("loss", "acc1", "acc5"):
        np.testing.assert_allclose(float(out[k]), float(ref[k]),
                                   rtol=TOL[dtype], atol=TOL[dtype])
