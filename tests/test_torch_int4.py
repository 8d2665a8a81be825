"""The A4W4 tiers of vitax_torch (`--int4`, `--int4-attn`, `--int4-grad`)
against vitax's.

The int4 quantizers against vitax's own functions; the plain twins of K11's
four kernels (the MLP half's forward and backward, the attention half's
forward and the int4_grad branch of its backward, each backward with and
without int8_dw; vitax_torch/ops/cuda_kernels.py) against vitax's Pallas
kernels in interpret mode; the autograd Functions' dispatch on every tier;
`vit.apply` and `train_cli` with the int4 flags; what still raises (d >
1024). Res-ViT's int4 tiers are in tests/test_torch_resvit_int4.py. The
kernels themselves are held against these twins on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).

Shapes: the kernels at D 64, M 256, 2 heads of 32, batch 2 at spq 24 and
with a ragged 19 (the attention's seq_len, the MLP's rows a image); the
models at D 128, M 256, 2 heads of 64, 2 layers (vitax's fused attention
takes D % 128 == 0 only). Tolerances of the kernels' twins,
max|port - vitax| <= tol·max(1, max|vitax|) per output: fp32 1e-4 for
activations and vector grads (measured <= 7e-7), 5e-3 for weight grads,
where under int8_dw a column code on a .5 tie of its int8 grid moves one
step (measured 1.5e-3 on dW2; <= 4e-7 without int8_dw); bf16 1e-2
(measured 3.1e-3: bf16 rounds at other places in XLA and torch, and a
moved int4 code is 1/7 of its row's largest value). The models: fp32
logits 1e-4, grads 1e-3 (measured <= 1.8e-6).
"""

import argparse
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from vitax import train_cli as j_train  # noqa: E402
from vitax.core import config as j_config  # noqa: E402
from vitax.core.config import arch_config as j_arch  # noqa: E402
from vitax.models import vit as jvit  # noqa: E402
from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax_torch import train_cli  # noqa: E402
from vitax_torch.checkpointing.npz import save_npz_params  # noqa: E402
from vitax_torch.core import config as t_config  # noqa: E402
from vitax_torch.core.config import arch_config as t_arch  # noqa: E402
from vitax_torch.models import vit as tvit  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402
from vitax_torch.ops import quant  # noqa: E402
from vitax_torch.train import param_leaves  # noqa: E402

D, H, HD, M, SPQ, SEQ, EPS = 64, 2, 32, 256, 24, 19, 1e-5
TOL = {"float32": (1e-4, 5e-3), "bfloat16": (1e-2, 1e-2)}


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
                wo=n(H * HD, D, scale=(H * HD) ** -0.5), bo=n(D, scale=0.1),
                w1=n(D, M, scale=D ** -0.5), b1=n(M, scale=0.1),
                w2=n(M, D, scale=M ** -0.5), b2=n(D, scale=0.1))


_MATS = ("x", "do", "wqkv", "wo", "w1", "w2")
_MLP = ("x", "gamma", "beta", "w1", "b1", "w2", "b2")
_QKVO = ("x", "gamma", "beta", "wqkv", "bqkv", "wo", "bo")
MLP_GRADS = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
QKVO_GRADS = ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwo", "dbo")


def _both(arrays, dtype):
    j = {k: jnp.asarray(v, getattr(jnp, dtype) if k in _MATS else jnp.float32)
         for k, v in arrays.items()}
    t = {k: torch.from_numpy(v).to(getattr(torch, dtype) if k in _MATS
                                   else torch.float32)
         for k, v in arrays.items()}
    return j, t


def _close(ref, out, tol, what):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    out = out.detach().float().numpy().reshape(ref.shape)
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= bound, f"{what}: max error {err:.3e} > {bound:.3e}"


def _check_all(refs, outs, dtype, names):
    small, weights = TOL[dtype]
    assert len(refs) == len(outs) == len(names)
    for name, r, o in zip(names, refs, outs):
        _close(r, o, weights if name.startswith("dw") else small, name)


def _same(outs, refs):
    for a, b in zip(outs, refs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------ quantizers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_quantizers_match_vitax(dtype):
    """Codes and scales bit for bit: per-row activations (fp32, with .5 ties
    on the grid and an all-zero row) and the weights' per-column and
    per-row forms (fp32 or bf16 weights, an all-zero column and row)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 96)).astype(np.float32)
    x[0, :8] = [7, 0.5, 1.5, 2.5, -3.5, 3.5, 6.5, -6.5]  # scale 1: ties
    x[1] = 0
    x[:, 50] = 0
    q, s = quant.quant_rows4(torch.from_numpy(x))
    qj, sj = pk._quant_rows4(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    assert q[0, :8].tolist() == [7, 0, 2, 2, -4, 4, 6, -6]
    assert not q[1].any() and q.dtype == torch.int8
    assert int(q.abs().max()) == 7
    w_t = torch.from_numpy(x).to(getattr(torch, dtype))
    w_j = jnp.asarray(x, getattr(jnp, dtype))
    for host, ref in ((quant.quant_cols_host4, pk._quant_cols_host4),
                      (quant.quant_rows_host4, pk._quant_rows_host4)):
        q, s = host(w_t)
        qj, sj = ref(w_j)
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
        assert int(q.abs().max()) == 7


# --------------------------------------------------------- K11-A, K11-B

def _pad(a, n, npad):
    return jnp.pad(a.reshape(n, D), ((0, npad - n), (0, 0)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [SPQ, SEQ])
def test_int4_mlp_forward_twin_matches_pallas(dtype, rows):
    """K11-A against vitax's fused_ln_mlp(int4=True) (:1880 on its padded
    rows): the output, the weights' codes and scales exactly vitax's; the
    wrapper on CPU tensors is the twin."""
    j, t = _both(_arrays(1, 2, rows), dtype)
    ref = pk.fused_ln_mlp(*(j[k] for k in _MLP), EPS, int4=True)
    scratch = {}
    args = (*(t[k] for k in _MLP), EPS)
    out = ck.fused_ln_mlp_int4_ref(*args, scratch=scratch)
    assert out.shape == t["x"].shape and out.dtype == t["x"].dtype
    _close(ref, out, TOL[dtype][0], "out")
    for key, name in (("w1q", "w1"), ("w2q", "w2")):
        q_j, s_j = pk._quant_cols_host4(j[name])
        np.testing.assert_array_equal(scratch[key][0].numpy(), np.asarray(q_j))
        np.testing.assert_array_equal(scratch[key][1].numpy(), np.asarray(s_j))
    assert int(scratch["h1q"][0].abs().max()) <= 7
    _same([ck.fused_ln_mlp_int4(*args)], [out])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8_dw", [False, True], ids=["bf16-dw", "int8-dw"])
@pytest.mark.parametrize("batch,rows", [(4, SPQ), (2, SEQ)])
def test_int4_mlp_backward_twin_matches_pallas(dtype, int8_dw, batch, rows):
    """K11-B against vitax's _ln_mlp_bwd_int4_call (:1914) on the rows
    padded as fused_ln_mlp pads them, all 7 outputs. Under int8_dw the
    groups are vitax's (a grid step's chunk, `mlp_int4_dw_group`): 96 rows
    in two groups of 48, and 38 rows padded to one group of 48, whose 10 pad
    rows' h1 and xn enter the column scales; the bf16-product twin misses
    those int8 weight grads."""
    j, t = _both(_arrays(2, batch, rows), dtype)
    n = batch * rows
    npad = pk._ln_mlp_pad(n, int8=True)
    ref = pk._ln_mlp_bwd_int4_call(
        _pad(j["x"], n, npad), j["gamma"], j["beta"], j["w1"], j["b1"],
        j["w2"], _pad(j["do"], n, npad), EPS, True, int8_dw=int8_dw)
    ref = (ref[0][:n], *ref[1:])
    block = pk._ln_mlp_rows(npad, int8=True)
    group = block // pk._bwd_chunks(block)
    assert ck.mlp_int4_dw_group(n) == group == 48
    args = (*(t[k] for k in _MLP[:6]), t["do"], EPS)
    twin = (ck.fused_ln_mlp_int4_dw_bwd_ref if int8_dw
            else ck.fused_ln_mlp_int4_bwd_ref)
    scratch = {}
    out = twin(*args, scratch=scratch)
    assert out[0].shape == t["x"].shape and out[0].dtype == t["x"].dtype
    assert all(o.dtype == torch.float32 for o in out[1:])
    _check_all(ref, out, dtype, MLP_GRADS)
    for key, fn, w in (("w1r", pk._quant_rows_host4, "w1"),
                       ("w2r", pk._quant_rows_host4, "w2"),
                       ("w1c", pk._quant_cols_host4, "w1")):
        q_j, s_j = fn(j[w])
        np.testing.assert_array_equal(scratch[key][0].numpy(), np.asarray(q_j))
        np.testing.assert_array_equal(scratch[key][1].numpy(), np.asarray(s_j))
    wrapper = (ck.fused_ln_mlp_int4_dw_bwd if int8_dw
               else ck.fused_ln_mlp_int4_bwd)
    _same(wrapper(*args), out)
    if int8_dw:
        groups = -(-n // group)
        assert scratch["h1c"][1].numel() == groups * M
        assert scratch["doc"][1].numel() == groups * D
        bf = ck.fused_ln_mlp_int4_bwd_ref(*args)
        assert not torch.equal(bf[3], out[3]) and not torch.equal(bf[5],
                                                                  out[5])


# --------------------------------------------------------- K11-C, K11-D

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,seq_len", [(2, SEQ), (1, SPQ)])
def test_int4_attention_forward_twin_matches_pallas(dtype, batch, seq_len):
    """K11-C against vitax's fused_ln_qkvo_attention(int4=True) (:3137),
    pad keys masked past seq_len: the output, the weights' codes exactly
    vitax's; the wrapper on CPU tensors is the twin."""
    j, t = _both(_arrays(3, batch, SPQ), dtype)
    ref = pk.fused_ln_qkvo_attention(*(j[k] for k in _QKVO), EPS, seq_len, H,
                                     HD, True, False, False, True)
    scratch = {}
    args = (*(t[k] for k in _QKVO), EPS, seq_len, H, HD)
    out = ck.fused_ln_qkvo_attention_int4_ref(*args, scratch=scratch)
    assert out.shape == t["x"].shape and out.dtype == t["x"].dtype
    _close(ref, out, TOL[dtype][0], "out")
    for key, name in (("w8", "wqkv"), ("wo8", "wo")):
        q_j, s_j = pk._quant_cols_host4(j[name])
        np.testing.assert_array_equal(scratch[key][0].numpy(), np.asarray(q_j))
        np.testing.assert_array_equal(scratch[key][1].numpy(), np.asarray(s_j))
    _same([ck.fused_ln_qkvo_attention_int4(*args)], [out])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8_dw", [False, True], ids=["bf16-dw", "int8-dw"])
@pytest.mark.parametrize("batch,seq_len", [(2, SEQ), (4, SPQ)])
def test_int4_attention_backward_twin_matches_pallas(dtype, int8_dw, batch,
                                                     seq_len):
    """K11-D against the int4_grad branch of vitax's _fused_ln_qkvo_bwd
    (:3252), all 7 outputs; under int8_dw vitax's group of whole images
    (tile·spq, 2 or 4 images, `qkvo_dw_group`), both operands packed fresh
    per column."""
    j, t = _both(_arrays(4, batch, SPQ), dtype)
    keys = _QKVO[:6]
    ref = pk._fused_ln_qkvo_bwd(EPS, seq_len, H, HD, True, True, int8_dw, True,
                                True, None, tuple(j[k] for k in keys),
                                j["do"])
    assert pk._qkvo_bwd_tile(batch, SPQ) * SPQ == ck.qkvo_dw_group(batch, SPQ)
    args = (*(t[k] for k in keys), t["do"], EPS, seq_len, H, HD)
    twin = (ck.fused_ln_qkvo_attention_int4_dw_bwd_ref if int8_dw
            else ck.fused_ln_qkvo_attention_int4_bwd_ref)
    scratch = {}
    out = twin(*args, scratch=scratch)
    assert all(o.dtype == torch.float32 for o in out[1:])
    _check_all(ref, out, dtype, QKVO_GRADS)
    for key, fn, w in (("w8", pk._quant_cols_host4, "wqkv"),
                       ("w8r", pk._quant_rows_host4, "wqkv"),
                       ("wo8r", pk._quant_rows_host4, "wo")):
        q_j, s_j = fn(j[w])
        np.testing.assert_array_equal(scratch[key][0].numpy(), np.asarray(q_j))
        np.testing.assert_array_equal(scratch[key][1].numpy(), np.asarray(s_j))
    wrapper = (ck.fused_ln_qkvo_attention_int4_dw_bwd if int8_dw
               else ck.fused_ln_qkvo_attention_int4_bwd)
    _same(wrapper(*args), out)
    if int8_dw:
        assert {"atc", "doc", "xnc", "dqc"} <= set(scratch)
        bf = ck.fused_ln_qkvo_attention_int4_bwd_ref(*args)
        assert not torch.equal(bf[3], out[3]) and not torch.equal(bf[5],
                                                                  out[5])


# ------------------------------------------------- the Functions' tiers

# (flags of the int4 wrapper, the backward twin its grads must equal)
MLP_TIERS = {
    "int4": ({}, "fused_ln_mlp_bwd_ref"),
    "int4+int8-grad": (dict(int8_grad=True), "fused_ln_mlp_int8_bwd_ref"),
    "int4-grad": (dict(int4_grad=True), "fused_ln_mlp_int4_bwd_ref"),
    "int4-grad+int8-grad": (dict(int4_grad=True, int8_grad=True),
                            "fused_ln_mlp_int4_bwd_ref"),
    "int4-grad+int8-dw": (dict(int4_grad=True, int8_grad=True, int8_dw=True),
                          "fused_ln_mlp_int4_dw_bwd_ref"),
}
ATTN_TIERS = {
    "int4": ({}, "fused_ln_qkvo_attention_bwd_ref"),
    "int4+int8-grad": (dict(int8_grad=True),
                       "fused_ln_qkvo_attention_int8_bwd_ref"),
    "int4-grad alone": (dict(int4_grad=True),
                        "fused_ln_qkvo_attention_bwd_ref"),
    "int4-grad+int8-grad": (dict(int4_grad=True, int8_grad=True),
                            "fused_ln_qkvo_attention_int4_bwd_ref"),
    "int4-grad+int8-dw": (dict(int4_grad=True, int8_grad=True, int8_dw=True),
                          "fused_ln_qkvo_attention_int4_dw_bwd_ref"),
}


@pytest.mark.parametrize("half,tier", [("mlp", k) for k in MLP_TIERS]
                         + [("attention", k) for k in ATTN_TIERS])
def test_int4_functions_dispatch_as_vitax(half, tier):
    """Under autograd the int4 forward is the twin's and the grads are those
    of vitax's backward for the tier (_ln_mlp_2d_int4_bwd :1948-1970,
    _fused_ln_qkvo_bwd :3246): the MLP's K11-B under int4_grad, else K4's
    under int8_grad, else K2's; the attention half's K11-D only under
    int8_grad and int4_grad, else K3's under int8_grad, else K1's (so
    int4_grad alone keeps K1's backward, ROADMAP's reference caveats)."""
    _, t = _both(_arrays(6, 2, SPQ), "float32")
    if half == "mlp":
        keys, extra, fwd = _MLP, (EPS,), ck.fused_ln_mlp_int4
        flags, bwd = MLP_TIERS[tier]
    else:
        keys, extra = _QKVO, (EPS, SEQ, H, HD)
        fwd = ck.fused_ln_qkvo_attention_int4
        flags, bwd = ATTN_TIERS[tier]
    leaves = [t[k].clone().requires_grad_() for k in keys]
    y = fwd(*leaves, *extra, **flags)
    with torch.no_grad():
        _same([y], [fwd(*(t[k] for k in keys), *extra)])
    y.backward(t["do"])
    ref = getattr(ck, bwd)(*(t[k] for k in keys[:6]), t["do"], *extra)
    for leaf, g in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad, g.to(leaf.dtype), rtol=0,
                                   atol=0)


# ------------------------------------------------------------ vit.apply

SMALL = dict(emb_dim=128, mlp_dim=256, num_heads=2, num_layers=2)
INT8 = dict(int8_mlp=True, int8_attn=True)
# train_cli's flag sets (vitax/train_cli.py:132-153: --int4-attn and
# --int4-grad imply --int4, which implies --int8 but not --int8-grad)
FLAG_SETS = {
    "--int4": dict(INT8, int4_mlp=True),
    "--int4 --int8-grad": dict(INT8, int4_mlp=True, int8_mlp_grad=True,
                               int8_attn_grad=True),
    "--int4-attn": dict(INT8, int4_mlp=True, int4_attn=True),
    "--int4-grad": dict(INT8, int4_mlp=True, int4_grad=True),
    "--int4-attn --int4-grad": dict(INT8, int4_mlp=True, int4_attn=True,
                                    int4_grad=True),
    "--int4-attn --int4-grad --int8-dw": dict(
        INT8, int4_mlp=True, int4_attn=True, int4_grad=True,
        int8_mlp_grad=True, int8_attn_grad=True, int8_dw=True),
    "--save-acts --int4": dict(INT8, int4_mlp=True, fused_mlp_save=True),
    "--int4 --token-keep 0.5": dict(INT8, int4_mlp=True, token_keep=0.5),
}


@pytest.fixture(scope="module")
def weights():
    jc = j_arch("tiny", 48, 10).replace(**SMALL)
    p = jax.tree.map(np.asarray, jvit.init_params(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        p)


def _vitax_layout(tree):
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return t.detach().float().numpy()

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = jax.tree.map(lambda *a: np.stack(a),
                                 *[conv(lp) for lp in tree["layers"]])
    return out


@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
def test_apply_int4_matches_vitax(flags, weights, monkeypatch):
    """fp32, image 48 at patch 16 (10 tokens, spq 16; with token keep 0.5
    both packages keep the same cls + 4 tokens, spq 8), train mode: the
    logits and the grads of every parameter of a cross-entropy loss against
    vitax's, within 1e-4 and 1e-3·max(1, max|g|). No flag set hands off
    (int4 keeps K5 off), and `--save-acts --int4` runs K11-A, not K12."""
    cfg = dict(FLAG_SETS[flags], fused_qkv=True, fused_mlp=True,
               use_pallas=True, patch_size=(16, 16), **SMALL)
    jc = j_arch("tiny", 48, 10).replace(dtype=jnp.float32, **cfg)
    tc = t_arch("tiny", 48, 10).replace(dtype=torch.float32, **cfg)
    img = np.random.default_rng(1).uniform(-1, 1, (2, 48, 48, 3)).astype(
        np.float32)
    labels = np.array([3, 7], np.int32)
    if cfg.get("token_keep", 1.0) < 1.0:
        idx = np.array([[0, 2, 3, 6, 9], [0, 1, 4, 5, 8]], np.int32)
        t_drop = tvit.drop_tokens
        monkeypatch.setattr(jvit, "drop_tokens", lambda x, *a, **k:
                            jnp.take_along_axis(x, jnp.asarray(idx)[..., None],
                                                axis=1))
        monkeypatch.setattr(tvit, "drop_tokens", lambda x, gen, keep, *a, **k:
                            t_drop(x, gen, keep, idx=torch.from_numpy(idx)))
    calls = {}
    for name in ("fused_ln_mlp_int4_ref", "fused_ln_mlp_int8_save_ref",
                 "fused_ln_mlp_save_ref", "fused_block_int8_handoff_ref"):
        fn = getattr(ck, name)
        monkeypatch.setattr(ck, name, lambda *a, _f=fn, _n=name, **k: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _f(*a, **k))[1])

    def j_loss(p):
        logits = jvit.apply(p, jnp.asarray(img), jc, train=True,
                            rng=jax.random.PRNGKey(1))
        lse = jax.nn.logsumexp(logits, axis=-1)
        return jnp.mean(lse - logits[jnp.arange(2), labels]), logits

    (_, j_logits), j_grads = jax.value_and_grad(j_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, weights))
    params = tvit.params_from_jax(weights)
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    logits = tvit.apply(params, torch.from_numpy(img), tc, train=True,
                        gen=torch.Generator().manual_seed(1))
    lse = torch.logsumexp(logits, dim=-1)
    loss = (lse - logits[torch.arange(2), torch.from_numpy(labels).long()]
            ).mean()
    grads = torch.autograd.grad(loss, leaves)
    assert calls == {"fused_ln_mlp_int4_ref": 2}
    _close(j_logits, logits, 1e-4, "logits")
    for p, g in zip(leaves, grads):
        p.grad = g
    flat = dict(jax.tree_util.tree_flatten_with_path(_vitax_layout(
        jax.tree.map(lambda p: p.grad, params, is_leaf=torch.is_tensor)))[0])
    for path, r in jax.tree_util.tree_flatten_with_path(j_grads)[0]:
        r = np.asarray(r, np.float32)
        err = float(np.abs(flat[path] - r).max())
        assert err <= 1e-3 * max(1.0, float(np.abs(r).max())), \
            (jax.tree_util.keystr(path), err)


def test_int4_tiers_still_raise_above_d_1024():
    cfg = t_arch("h14", 224, 10, int4_mlp=True, int4_grad=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        tvit.apply(None, torch.zeros(1, 224, 224, 3), cfg)


# ------------------------------------------------------------ train_cli

TINY_INT4 = dict(patch=16, emb_dim=128, mlp_dim=256, num_heads=2,
                 num_layers=2)
CLI = ["--dataset", "Synthetic", "--model-arch", "tiny", "--image-size", "32",
       "--batch-size", "8", "--num-workers", "0", "--dtype", "float32",
       "--fused-qkv", "--fused-mlp", "--synthetic-samples", "8",
       "--train-steps", "1", "--lr", "0.05", "--warmup-steps", "0",
       "--wd", "0"]


def test_train_cli_int4_grad_int8_dw_matches_vitax(tmp_path, monkeypatch,
                                                    capsys):
    """`train_cli --int4-attn --int4-grad --int8-dw` on a tiny preset of
    vitax's fused width (D 128, 2 layers, image 32: spq 8) from one npz, in
    both packages: the epoch's validation metrics against those vitax
    prints; the port ran K11's four twins (a step and an eval batch)."""
    monkeypatch.setenv("VITAX_NO_CACHE", "1")
    monkeypatch.setitem(t_config.ARCH_PRESETS, "tiny", TINY_INT4)
    monkeypatch.setitem(j_config.ARCH_PRESETS, "tiny", TINY_INT4)
    params = jvit.init_params(jax.random.PRNGKey(3), j_arch("tiny", 32, 10))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape), params)
    npz = str(tmp_path / "w.npz")
    save_npz_params(npz, params)
    names = ("fused_ln_mlp_int4_ref", "fused_ln_mlp_int4_dw_bwd_ref",
             "fused_ln_qkvo_attention_int4_ref",
             "fused_ln_qkvo_attention_int4_dw_bwd_ref")
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(ck, name)
        monkeypatch.setattr(ck, name, lambda *a, _f=fn, _n=name, **k: (
            calls.__setitem__(_n, calls[_n] + 1), _f(*a, **k))[1])
    argv = CLI + ["--checkpoint-path", npz, "--int4-attn", "--int4-grad",
                  "--int8-dw"]
    capsys.readouterr()
    j_train.main(argv + ["--exp-root", str(tmp_path / "j")])
    printed = re.findall(r"epoch \d+ valid: (.*)", capsys.readouterr().out)
    j_valid = [{k: float(v) for k, v in re.findall(r"(\w+)=([-\d.e]+)", line)}
               for line in printed]
    out = train_cli.main(argv + ["--exp-root", str(tmp_path / "t")],
                         device="cpu")
    assert len(out["epochs"]) == len(j_valid) == 1
    for t, j in zip(out["epochs"], j_valid):
        np.testing.assert_allclose(t["valid"]["loss"], j["loss"], rtol=1e-4,
                                   atol=1e-4)
        for k in ("acc1", "acc5"):
            assert t["valid"][k] == pytest.approx(j[k], abs=1e-6)
    # 2 layers: a step forward and backward, an eval batch forward
    assert calls == {"fused_ln_mlp_int4_ref": 4,
                     "fused_ln_mlp_int4_dw_bwd_ref": 2,
                     "fused_ln_qkvo_attention_int4_ref": 4,
                     "fused_ln_qkvo_attention_int4_dw_bwd_ref": 2}


def test_train_cli_int4_flag_map():
    ns = argparse.Namespace(model_arch="b16", image_size=224, num_classes=10,
                            dtype="bfloat16", fused_qkv=None, fused_mlp=None,
                            token_keep=1.0, no_pallas=False, int8=False,
                            int8_grad=False, int8_dw=False, int4=False,
                            int4_attn=True, int4_grad=False)
    cfg = train_cli.model_config_from_cli(ns, on_gpu=True)
    assert (cfg.int8_mlp, cfg.int8_attn, cfg.int4_mlp, cfg.int4_attn) == \
        (True,) * 4
    assert not (cfg.int8_mlp_grad or cfg.int8_attn_grad or cfg.int4_grad)
    ns.int4_attn, ns.int4_grad = False, True
    cfg = train_cli.model_config_from_cli(ns, on_gpu=True)
    assert cfg.int4_mlp and cfg.int4_grad and not cfg.int4_attn
    assert not cfg.int8_mlp_grad
