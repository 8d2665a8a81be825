"""The plain twins of the Hopper kernels (vitax_torch/ops/cuda_kernels.py)
against vitax's Pallas kernels run in interpret mode. The Hopper kernels
themselves are held against these twins on the card by
tests/test_torch_cuda_kernels.py (no jax there) and chip_smoke.py.

Small shapes that pass both packages' gates: D 128, H 2 (head_dim 64),
M 256, spq 16 with seq_len 10 (the padded stream), batch 1 and 3.
Tolerances: fp32 1e-4; bf16 2e-2 (ulp 2^-8, same rounding points, sums in
another order).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402

D, H, HD, M, SPQ, SEQ, EPS = 128, 2, 64, 256, 16, 10, 1e-5
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _weights(seed):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(gamma=1 + n(D, scale=0.1), beta=n(D, scale=0.1),
                wqkv=n(D, 3 * H * HD, scale=D ** -0.5),
                bqkv=n(3 * H * HD, scale=0.1),
                wo=n(H * HD, D, scale=(H * HD) ** -0.5), bo=n(D, scale=0.1),
                w1=n(D, M, scale=D ** -0.5), b1=n(M, scale=0.1),
                w2=n(M, D, scale=M ** -0.5), b2=n(D, scale=0.1))


# matrices and activations go in the compute dtype, vectors stay fp32
_MATS = ("x", "wqkv", "wo", "w1", "w2")


def _both(arrays, dtype):
    j = {k: jnp.asarray(v, getattr(jnp, dtype) if k in _MATS else jnp.float32)
         for k, v in arrays.items()}
    t = {k: torch.from_numpy(v).to(getattr(torch, dtype) if k in _MATS
                                   else torch.float32)
         for k, v in arrays.items()}
    return j, t


def _close(j, t, dtype):
    np.testing.assert_allclose(np.asarray(j.astype(jnp.float32)),
                               t.float().numpy(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def _x(batch, rows, seed):
    rng = np.random.default_rng(100 + seed)
    return (rng.standard_normal((batch, rows, D)) * 1.5 + 0.3).astype(
        np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3])
def test_layer_norm_ref_matches_pallas(dtype, batch):
    arr = dict(_weights(0), x=_x(batch, SPQ, 0))
    j, t = _both(arr, dtype)
    ref = pk.layer_norm(j["x"], j["gamma"], j["beta"], EPS)
    _close(ref, ck.layer_norm_ref(t["x"], t["gamma"], t["beta"], EPS), dtype)
    _close(ref, ck.layer_norm(t["x"], t["gamma"], t["beta"], EPS), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3])
def test_fused_ln_qkvo_attention_ref_matches_pallas(dtype, batch):
    arr = dict(_weights(1), x=_x(batch, SPQ, 1))  # pad rows hold garbage
    j, t = _both(arr, dtype)
    args = ("x", "gamma", "beta", "wqkv", "bqkv", "wo", "bo")
    ref = pk.fused_ln_qkvo_attention(*(j[k] for k in args), EPS, SEQ, H, HD)
    out = ck.fused_ln_qkvo_attention_ref(*(t[k] for k in args), EPS, SEQ, H,
                                         HD)
    assert out.shape == (batch, SPQ, D) and out.dtype == t["x"].dtype
    _close(ref, out, dtype)
    _close(ref, ck.fused_ln_qkvo_attention(*(t[k] for k in args), EPS, SEQ,
                                           H, HD), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,rows", [(1, SPQ), (3, SPQ), (3, SEQ)])
def test_fused_ln_mlp_ref_matches_pallas(dtype, batch, rows):
    arr = dict(_weights(2), x=_x(batch, rows, 2))
    j, t = _both(arr, dtype)
    args = ("x", "gamma", "beta", "w1", "b1", "w2", "b2")
    ref = pk.fused_ln_mlp(*(j[k] for k in args), EPS)
    out = ck.fused_ln_mlp_ref(*(t[k] for k in args), EPS)
    assert out.shape == (batch, rows, D) and out.dtype == t["x"].dtype
    _close(ref, out, dtype)
    _close(ref, ck.fused_ln_mlp(*(t[k] for k in args), EPS), dtype)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    ck.reset_launch_counts()
    _, t = _both(dict(_weights(3), x=_x(2, SPQ, 3)), "float32")
    ck.layer_norm(t["x"], t["gamma"], t["beta"], EPS)
    ck.fused_ln_mlp(t["x"], t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"],
                    t["b2"], EPS)
    ck.fused_ln_qkvo_attention(t["x"], t["gamma"], t["beta"], t["wqkv"],
                               t["bqkv"], t["wo"], t["bo"], EPS, SEQ, H, HD)
    assert ck.launch_counts() == {"layer_norm": 0,
                                  "fused_ln_qkvo_attention": 0,
                                  "fused_ln_mlp": 0}


def test_hopper_gates():
    def x(b, s, d):
        return torch.empty((b, s, d), device="meta")

    def w(*shape):
        return torch.empty(shape, device="meta")

    # ViT-B/16 at 224 (spq 200) and 384 (spq 584), and the test config
    assert ck.qkv_attention_supported(x(8, 197, 768), w(768, 2304), 12)
    assert ck.qkv_attention_supported(x(8, 577, 768), w(768, 2304), 12)
    assert ck.qkv_attention_supported(x(3, SEQ, D), w(D, 3 * H * HD), H)
    # scores + K/V past 227 KB of shared memory; head_dim 80 (ViT-H/14)
    assert not ck.qkv_attention_supported(x(1, 1024, 768), w(768, 2304), 12)
    assert not ck.qkv_attention_supported(x(1, 257, 1280), w(1280, 3840), 16)
    assert ck.attention_smem_bytes(584, 64) <= ck.SMEM_LIMIT
    assert ck.ln_mlp_supported(x(8, 200, 768), w(768, 3072), w(3072, 768))
    assert not ck.ln_mlp_supported(x(8, 200, 768), w(768, 3000), w(3000, 768))
    assert not ck.ln_mlp_supported(x(8, 200, 768), w(768, 3072), w(768, 3072))
    assert ck.layernorm_supported(x(8, 197, 768))
    assert not ck.layernorm_supported(x(8, 197, 770))
