"""The plain twins of the Hopper backward kernels (vitax_torch/ops/
cuda_kernels.py, `*_bwd_ref`) against vitax's Pallas backwards run in
interpret mode, and the autograd Functions on CPU against autograd through
the `*_ref` forwards. The kernels themselves are held against these twins on
the card by tests/test_torch_cuda_kernels.py (no jax there) and
chip_smoke.py.

Small shapes that pass both packages' gates: D 128, H 2 (head_dim 64),
M 256, spq 16 with seq_len 10 (the padded stream), batch 1 and 3; ragged
rows (3 x 10) for LN and K2; K1 at spq 72 with seq_len 65 (pad rows past
a 64-row tile, as the card's K1 backward tiles them) and K2 on 3 x 72 rows;
LN also at D 768 and 1280 on 513 and 1100 rows (vitax's dγ/dβ carried
across its 512-row blocks, the last one ragged).
Tolerances, as max|port - pallas| <= tol * max(1, max|pallas|) per output:
fp32 1e-4 for dx and the vector grads and 1e-3 for the weight grads (sums
over all rows); bf16 2e-2 (ulp 2^-8, same rounding points, sums in another
order). Functions vs autograd through the twins: fp32 1e-4.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402

D, H, HD, M, SPQ, SEQ, EPS = 128, 2, 64, 256, 16, 10, 1e-5
TOL = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 2e-2)}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _arrays(seed, batch, rows):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(x=n(batch, rows, D) * 1.5 + 0.3, do=n(batch, rows, D),
                gamma=1 + n(D, scale=0.1), beta=n(D, scale=0.1),
                wqkv=n(D, 3 * H * HD, scale=D ** -0.5),
                bqkv=n(3 * H * HD, scale=0.1),
                wo=n(H * HD, D, scale=(H * HD) ** -0.5),
                w1=n(D, M, scale=D ** -0.5), b1=n(M, scale=0.1),
                w2=n(M, D, scale=M ** -0.5))


# matrices and activations go in the compute dtype, vectors stay fp32
_MATS = ("x", "do", "wqkv", "wo", "w1", "w2")


def _both(arrays, dtype):
    j = {k: jnp.asarray(v, getattr(jnp, dtype) if k in _MATS else jnp.float32)
         for k, v in arrays.items()}
    t = {k: torch.from_numpy(v).to(getattr(torch, dtype) if k in _MATS
                                   else torch.float32)
         for k, v in arrays.items()}
    return j, t


def _close(ref, out, tol, what):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    out = out.float().numpy()
    assert out.shape == ref.shape, what
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= bound, f"{what}: max error {err:.3e} > {bound:.3e}"


def _check_all(refs, outs, dtype, names, weight_names):
    small, weights = TOL[dtype]
    assert len(refs) == len(outs) == len(names)
    for name, r, o in zip(names, refs, outs):
        _close(r, o, weights if name in weight_names else small, name)


def _ln_wide(batch, rows, d, seed):
    """x, do [batch, rows, d] and fp32 γ [d] at a ViT width."""
    rng = np.random.default_rng(300 + seed)
    n = rng.standard_normal
    return dict(x=(n((batch, rows, d)) * 1.5 + 0.3).astype(np.float32),
                do=n((batch, rows, d)).astype(np.float32),
                gamma=(1 + 0.1 * n(d)).astype(np.float32))


# ViT-B's and ViT-H's widths on row counts that cross vitax's 512-row LN
# blocks (_LN_BLOCK_ROWS): its dγ/dβ carried across grid steps and its
# ragged last block masked (pallas_kernels.py:298-314); vitax under jax.jit
LN_WIDE = [pytest.param(1, 513, 768, id="1-513-768"),
           pytest.param(2, 550, 768, id="2-550-768"),
           pytest.param(2, 550, 1280, id="2-550-1280")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,rows,d", [pytest.param(1, SPQ, D, id="1-16"),
                                          pytest.param(3, SPQ, D, id="3-16"),
                                          pytest.param(3, SEQ, D, id="3-10"),
                                          *LN_WIDE])
def test_layer_norm_bwd_ref_matches_pallas(dtype, batch, rows, d):
    if d == D:
        arrays, call = _arrays(0, batch, rows), pk._ln_bwd_call
    else:
        arrays = _ln_wide(batch, rows, d, 0)
        call = jax.jit(pk._ln_bwd_call, static_argnums=3)
    j, t = _both(arrays, dtype)
    ref = call(j["x"].reshape(-1, d), j["gamma"], j["do"].reshape(-1, d), EPS)
    out = ck.layer_norm_bwd_ref(t["x"], t["gamma"], t["do"], EPS)
    assert out[0].shape == t["x"].shape and out[0].dtype == t["x"].dtype
    _check_all(ref, (out[0].reshape(-1, d), *out[1:]), dtype,
               ("dx", "dgamma", "dbeta"), ())
    # on CPU tensors the wrapper is the twin
    for a, b in zip(out, ck.layer_norm_bwd(t["x"], t["gamma"], t["do"], EPS)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,rows,residual",
                         [(1, SPQ, True), (3, SPQ, True), (3, SEQ, True),
                          (3, SPQ, False), (3, 72, True)])
def test_fused_ln_mlp_bwd_ref_matches_pallas(dtype, batch, rows, residual):
    j, t = _both(_arrays(1, batch, rows), dtype)
    n = batch * rows
    # vitax pads the rows to its row block with zeros (fused_ln_mlp); zero
    # rows with a zero cotangent add nothing to any grad
    npad = pk._ln_mlp_pad(n)

    def pad(a):
        return jnp.pad(a.reshape(n, D), ((0, npad - n), (0, 0)))

    ref = pk._ln_mlp_bwd_call(pad(j["x"]), j["gamma"], j["beta"], j["w1"],
                              j["b1"], j["w2"], pad(j["do"]), EPS, residual)
    ref = (ref[0][:n], *ref[1:])
    args = (t["x"], t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"],
            t["do"], EPS, residual)
    out = ck.fused_ln_mlp_bwd_ref(*args)
    assert out[0].shape == t["x"].shape and out[0].dtype == t["x"].dtype
    assert all(o.dtype == torch.float32 for o in out[1:])
    _check_all(ref, (out[0].reshape(n, D), *out[1:]), dtype,
               ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"),
               ("dw1", "dw2"))
    for a, b in zip(out, ck.fused_ln_mlp_bwd(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,seq_len", [(1, SEQ), (3, SEQ), (2, SPQ)])
def test_fused_ln_qkvo_attention_bwd_ref_matches_pallas(dtype, batch,
                                                        seq_len):
    j, t = _both(_arrays(2, batch, SPQ), dtype)  # pad rows hold garbage
    keys = ("x", "gamma", "beta", "wqkv", "bqkv", "wo")
    ref = pk._fused_ln_qkvo_bwd(EPS, seq_len, H, HD, False, False, False,
                                False, False, None,
                                tuple(j[k] for k in keys), j["do"])
    args = (*(t[k] for k in keys), t["do"], EPS, seq_len, H, HD)
    out = ck.fused_ln_qkvo_attention_bwd_ref(*args)
    assert out[0].shape == t["x"].shape and out[0].dtype == t["x"].dtype
    assert all(o.dtype == torch.float32 for o in out[1:])
    _check_all(ref, out, dtype,
               ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwo", "dbo"),
               ("dwqkv", "dwo"))
    for a, b in zip(out, ck.fused_ln_qkvo_attention_bwd(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ln_qkvo_attention_bwd_ref_matches_pallas_past_a_tile(dtype):
    """spq 72, seq_len 65: the keys end one row into the second 64-row tile
    and the garbage pad rows 65..71 follow them, with a nonzero do."""
    j, t = _both(_arrays(7, 1, 72), dtype)
    keys = ("x", "gamma", "beta", "wqkv", "bqkv", "wo")
    ref = pk._fused_ln_qkvo_bwd(EPS, 65, H, HD, False, False, False, False,
                                False, None, tuple(j[k] for k in keys),
                                j["do"])
    out = ck.fused_ln_qkvo_attention_bwd_ref(*(t[k] for k in keys), t["do"],
                                             EPS, 65, H, HD)
    _check_all(ref, out, dtype,
               ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwo", "dbo"),
               ("dwqkv", "dwo"))


def _fn_vs_autograd(fused, plain, inputs, seed):
    """Grads through the autograd Function (its backward is the *_bwd twin on
    CPU) against autograd through the plain forward twin, fp32."""
    a = [x.clone().requires_grad_() for x in inputs]
    b = [x.clone().requires_grad_() for x in inputs]
    out_a, out_b = fused(*a), plain(*b)
    torch.testing.assert_close(out_a, out_b, rtol=0, atol=0)
    gen = torch.Generator().manual_seed(seed)
    do = torch.randn(out_b.shape, generator=gen)
    torch.autograd.backward(out_a, do)
    torch.autograd.backward(out_b, do)
    for i, (ta, tb) in enumerate(zip(a, b)):
        bound = 1e-4 * max(1.0, tb.grad.abs().max().item())
        err = (ta.grad - tb.grad).abs().max().item()
        assert ta.grad.dtype == ta.dtype and err <= bound, (i, err, bound)


@pytest.mark.parametrize("kernel", ["layer_norm", "fused_ln_mlp",
                                    "fused_ln_qkvo_attention"])
def test_autograd_functions_match_autograd_through_the_twins(kernel):
    _, t = _both(_arrays(3, 3, SPQ), "float32")
    rng = np.random.default_rng(4)
    bo = torch.from_numpy(rng.standard_normal(D).astype(np.float32) * 0.1)
    b2 = torch.from_numpy(rng.standard_normal(D).astype(np.float32) * 0.1)
    if kernel == "layer_norm":
        inputs = [t["x"], t["gamma"], t["beta"]]
        extra = (EPS,)
    elif kernel == "fused_ln_mlp":
        inputs = [t["x"], t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"],
                  b2]
        extra = (EPS,)
    else:
        inputs = [t["x"], t["gamma"], t["beta"], t["wqkv"], t["bqkv"],
                  t["wo"], bo]
        extra = (EPS, SEQ, H, HD)
    fused = getattr(ck, kernel)
    plain = getattr(ck, kernel + "_ref")
    _fn_vs_autograd(lambda *a: fused(*a, *extra), lambda *a: plain(*a, *extra),
                    inputs, seed=5)


def test_functions_return_grads_in_the_pallas_dtypes():
    """bf16 activations and weights with fp32 LN and bias vectors: grads in
    each input's dtype (vitax casts dW to the weight's dtype, keeps the
    vector grads fp32)."""
    _, t = _both(_arrays(6, 2, SPQ), "bfloat16")
    leaves = [t[k].clone().requires_grad_() for k in
              ("x", "gamma", "beta", "wqkv", "bqkv", "wo")]
    bo = torch.zeros(D, requires_grad=True)
    out = ck.fused_ln_qkvo_attention(*leaves, bo, EPS, SEQ, H, HD)
    assert type(out.grad_fn).__name__ == "FusedLnQkvoAttentionFnBackward"
    out.float().sum().backward()
    for leaf in leaves + [bo]:
        assert leaf.grad.dtype == leaf.dtype and leaf.grad.shape == leaf.shape
        assert torch.isfinite(leaf.grad.float()).all()
