"""K1's, K2's and K12's forwards composed from plain versions in the order
their C entry points launch them on the card (csrc/ln_qkvo_attention.cu
with kv_heads == heads, csrc/ln_mlp.cu, csrc/ln_mlp_save.cu), on CPU
tensors:

- K1: LN, `gemm_sm90_ref("nn_bias")` (qkv), K13's core on the packed rows
  (keys masked at seq_len, the pad query rows computed), then
  `gemm_sm90_ref("nn_bias")` (the out-projection);
- K2: LN, `nn_bias_gelu` (fc1), then `nn_bias_residual` or `nn_bias` (fc2);
- K12: LN, `nn_bias_gelu_save` (fc1 with g'), then K2's fc2.

Each composition must equal the fused twin (`fused_ln_qkvo_attention_ref`,
`fused_ln_mlp_ref` in both branches, `fused_ln_mlp_save_ref`) to the bit:
the same fp32 products and the same rounding points, step by step. The
twins are held against vitax's Pallas kernels by test_torch_kernels_ref.py;
here the composed K2 is also held against vitax's `fused_ln_mlp` under
`jax.jit` in interpret mode, within the bf16 tolerance 2e-2 (ulp 2^-8, the
same rounding points, sums in another order).

Tiny widths: D 128, 2 heads of 64, M 256, spq 16 with seq_len 10, bf16.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402
from vitax_torch.ops.layernorm import layer_norm_ref  # noqa: E402

D, H, HD, M, SPQ, SEQ, EPS = 128, 2, 64, 256, 16, 10, 1e-5
BF = torch.bfloat16
TOL = 2e-2


def _inputs(batch, rows, seed):
    """bf16 activations and matrices, fp32 vectors, from numpy."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    arr = dict(x=n(batch, rows, D, scale=1.5) + 0.3, gamma=1 + n(D, scale=0.1),
               beta=n(D, scale=0.1), wqkv=n(D, 3 * H * HD, scale=D ** -0.5),
               bqkv=n(3 * H * HD, scale=0.1),
               wo=n(H * HD, D, scale=(H * HD) ** -0.5), bo=n(D, scale=0.1),
               w1=n(D, M, scale=D ** -0.5), b1=n(M, scale=0.1),
               w2=n(M, D, scale=M ** -0.5), b2=n(D, scale=0.1))
    mats = ("x", "wqkv", "wo", "w1", "w2")
    return arr, {k: torch.from_numpy(v).to(BF if k in mats else torch.float32)
                 for k, v in arr.items()}


def _k1_composed(t):
    xn = layer_norm_ref(t["x"], t["gamma"], t["beta"], EPS)
    qkv = ck.gemm_sm90_ref("nn_bias", xn, t["wqkv"], t["bqkv"])
    *_, o32 = ck._attn_core(qkv, SEQ, H, HD)
    attn = ck._heads_to_rows(o32.to(BF))
    out = ck.gemm_sm90_ref("nn_bias", attn, t["wo"], t["bo"])
    return out.view(t["x"].shape)


def _k2_composed(t, residual, save=False):
    x = t["x"]
    xn = layer_norm_ref(x, t["gamma"], t["beta"], EPS).reshape(-1, D)
    fc1 = "nn_bias_gelu_save" if save else "nn_bias_gelu"
    h1 = ck.gemm_sm90_ref(fc1, xn, t["w1"], t["b1"])
    if save:
        h1, gp = h1
    if residual:
        out = ck.gemm_sm90_ref("nn_bias_residual", h1, t["w2"], t["b2"],
                               residual=x.reshape(-1, D))
    else:
        out = ck.gemm_sm90_ref("nn_bias", h1, t["w2"], t["b2"])
    out = out.view(x.shape)
    return (out, h1, gp) if save else out


@pytest.mark.parametrize("batch", [1, 3])
def test_k1_forward_launch_order_equals_its_twin(batch):
    _, t = _inputs(batch, SPQ, 1)  # the pad rows hold garbage
    twin = ck.fused_ln_qkvo_attention_ref(
        *(t[k] for k in ("x", "gamma", "beta", "wqkv", "bqkv", "wo", "bo")),
        EPS, SEQ, H, HD)
    out = _k1_composed(t)
    assert out.dtype == BF and out.shape == (batch, SPQ, D)
    assert torch.equal(out, twin)


_MLP = ("x", "gamma", "beta", "w1", "b1", "w2", "b2")


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("batch,rows", [(1, SPQ), (3, SPQ), (3, SEQ)])
def test_k2_forward_launch_order_equals_its_twin(batch, rows, residual):
    _, t = _inputs(batch, rows, 2)
    twin = ck.fused_ln_mlp_ref(*(t[k] for k in _MLP), EPS, residual)
    out = _k2_composed(t, residual)
    assert out.dtype == BF and out.shape == (batch, rows, D)
    assert torch.equal(out, twin)


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("batch,rows", [(3, SPQ), (3, SEQ)])
def test_k12_forward_launch_order_equals_its_twin(batch, rows, residual):
    _, t = _inputs(batch, rows, 3)
    twin = ck.fused_ln_mlp_save_ref(*(t[k] for k in _MLP), EPS, residual)
    composed = _k2_composed(t, residual, save=True)
    for out, ref in zip(composed, twin):
        assert out.dtype == ref.dtype and torch.equal(out, ref)
    # K12's out is K2's: the same products and the same fc2 launch
    assert torch.equal(composed[0], _k2_composed(t, residual))


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


@pytest.mark.parametrize("residual", [True, False])
def test_composed_k2_matches_vitax_under_jit(interpret_mode, residual):
    arr, t = _inputs(3, SEQ, 4)
    j = {k: jnp.asarray(v, jnp.bfloat16 if t[k].dtype == BF else jnp.float32)
         for k, v in arr.items()}
    fn = jax.jit(lambda *a: pk.fused_ln_mlp(*a, EPS, residual=residual))
    ref = np.asarray(fn(*(j[k] for k in _MLP)).astype(jnp.float32))
    out = _k2_composed(t, residual).float().numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["nn_bias_gelu", "nn_bias_gelu_save",
                                  "nn_bias_residual"])
def test_gemm_sm90_takes_its_twin_on_cpu_tensors(kind):
    _, t = _inputs(1, 8, 5)
    a, b = t["x"].reshape(-1, D), t["w1"]
    res = torch.ones((8, M), dtype=BF) if kind == "nn_bias_residual" else None
    out = ck.gemm_sm90(kind, a, b, t["b1"], residual=res)
    ref = ck.gemm_sm90_ref(kind, a, b, t["b1"], residual=res)
    outs, refs = ((out, ref) if kind == "nn_bias_gelu_save"
                  else ((out,), (ref,)))
    for o, r in zip(outs, refs):
        assert o.shape == (8, M) and o.dtype == BF and torch.equal(o, r)
