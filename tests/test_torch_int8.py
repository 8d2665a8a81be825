"""The W8A8 tiers of vitax_torch (`--int8`, `--int8-grad`) against vitax's.

The quantizers and the int8 GELU against vitax's own functions; the plain
twins of the four int8 kernels (K3/K4 forward and int8-grad backward,
vitax_torch/ops/cuda_kernels.py) against vitax's Pallas kernels in interpret
mode; the `--int8`-alone backward against the bf16 one; `vit.apply`, three
train steps and the CLIs with the int8 flags. The kernels themselves are
held against these twins on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py).

Shapes: D 128, H 2 (head_dim 64), M 256, spq 16 with seq_len 10 (the
padded stream), batch 1 and 3, ragged rows (3 x 10) for K4. Tolerances,
max|port - vitax| <= tol * max(1, max|vitax|) per output: fp32 1e-4 for
activations and vector grads, 1e-3 for weight grads; bf16 2e-2. Both sides
quantize on the same grid, so an output moves past rounding noise only
where a code moves one step; the tests count such codes.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from vitax.core.config import arch_config as j_arch  # noqa: E402
from vitax.models import vit as jvit  # noqa: E402
from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax.train import (create_train_state as j_state,  # noqa: E402
                         make_train_step as j_step, onecycle_lr as j_lr,
                         onecycle_momentum as j_mom, sgd_momentum as j_sgd)
from vitax_torch import eval_cli, train_cli  # noqa: E402
from vitax_torch.core.config import ARCH_PRESETS  # noqa: E402
from vitax_torch.core.config import arch_config as t_arch  # noqa: E402
from vitax_torch.models import vit as tvit  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402
from vitax_torch.ops import mlp as tmlp  # noqa: E402
from vitax_torch.ops import quant  # noqa: E402
from vitax_torch.train import (create_train_state as t_state,  # noqa: E402
                               make_train_step as t_step,
                               sgd_momentum as t_sgd)

D, H, HD, M, SPQ, SEQ, EPS = 128, 2, 64, 256, 16, 10, 1e-5
TOL = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 2e-2)}
# share of the activation codes of LN+quant that may sit one step away from
# vitax's (the LN sums are taken in another order, which can move a value
# across a .5 tie); no code may move two steps
CODE_SHARE = 1e-3
INT8 = dict(int8_mlp=True, int8_attn=True)
INT8_GRAD = dict(INT8, int8_mlp_grad=True, int8_attn_grad=True)


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


def _both(arrays, dtype):
    j = {k: jnp.asarray(v, getattr(jnp, dtype) if k in _MATS else jnp.float32)
         for k, v in arrays.items()}
    t = {k: torch.from_numpy(v).to(getattr(torch, dtype) if k in _MATS
                                   else torch.float32)
         for k, v in arrays.items()}
    return j, t


def _close(ref, out, tol, what):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    out = out.float().numpy().reshape(ref.shape)
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= bound, f"{what}: max error {err:.3e} > {bound:.3e}"


MLP_GRADS = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
QKVO_GRADS = ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwo", "dbo")


def _check_all(refs, outs, dtype, names):
    """Weight grads (sums over all rows) at the looser tolerance."""
    small, weights = TOL[dtype]
    assert len(refs) == len(outs) == len(names)
    for name, r, o in zip(names, refs, outs):
        _close(r, o, weights if name.startswith("dw") else small, name)


@jax.jit
def _vitax_ln_codes(x, gamma, beta):
    """The LN1/LN2 prologue of vitax's int8 kernels (pallas_kernels.py:
    2699-2706), compiled as the interpret-mode kernels are."""
    x = x.reshape(-1, D).astype(jnp.float32)
    mu = jnp.mean(x, axis=-1, keepdims=True)
    xc = x - mu
    var = jnp.mean(xc * xc, axis=-1, keepdims=True)
    return pk._quant_rows(xc * jax.lax.rsqrt(var + EPS) * gamma + beta)[0]


def _moved_codes(j, t):
    """|vitax's codes - the twin's| of the LN output, each package with its
    own LN arithmetic."""
    xhat, _ = ck._ln_stats(t["x"].reshape(-1, D).float(), EPS)
    q_t = quant.quant_rows(ck._affine(xhat, t["gamma"], t["beta"]))[0]
    q_j = _vitax_ln_codes(j["x"], j["gamma"], j["beta"])
    return np.abs(np.asarray(q_j, np.int32) - q_t.numpy().astype(np.int32))


# ---------------------------------------------------------------- (a), (b)

def _tie_matrix():
    """Rows (and columns) whose max |x| is 127, so the step is 1 and every
    k + 0.5 below is a tie that half-to-even rounding must send to even."""
    ties = np.arange(-126.5, 127.0, 1.0, dtype=np.float32)  # 254 values
    m = np.zeros((254, 256), np.float32)
    m[:, 0] = 127.0
    m[:, 1] = -127.0
    m[:, 2:] = np.stack([np.roll(ties, i) for i in range(254)])
    return m


@pytest.mark.parametrize("name", ["_quant_rows", "_quant_cols",
                                  "_quant_cols_host", "_quant_rows_host"])
@pytest.mark.parametrize("data", ["random", "ties"])
def test_quantizers_match_vitax_exactly(name, data):
    if data == "ties":
        x = _tie_matrix()
        if "cols" in name:
            x = np.ascontiguousarray(x.T)
    else:
        rng = np.random.default_rng(0)
        x = (rng.standard_normal((64, 96))
             * rng.uniform(0.01, 5.0, (64, 1))).astype(np.float32)
    q_j, s_j = getattr(pk, name)(jnp.asarray(x))
    q_t, s_t = getattr(quant, name.lstrip("_"))(torch.from_numpy(x))
    assert q_t.dtype == torch.int8
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy().ravel(),
                                  np.asarray(s_j).ravel())
    if data == "ties":  # half to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
        body = q_t.numpy()[2:] if "cols" in name else q_t.numpy()[:, 2:]
        assert {0, 2, -2} <= set(np.unique(body).tolist())
        assert np.all(body % 2 == 0)


@pytest.mark.parametrize("name", ["gelu_q", "gelu_grad_q"])
def test_int8_gelu_matches_vitax(name):
    """fp32, vitax's compiled as its kernels run it; |Δ| <= 1e-6·max(1, |a|):
    one-ulp differences in exp and rsqrt, scaled by a (and by 1.702a(1 − σ)
    in the derivative). Measured 3.6e-7."""
    a = np.random.default_rng(1).standard_normal(20000).astype(np.float32) * 5
    ref = np.asarray(jax.jit(getattr(pk, "_" + name))(jnp.asarray(a)))
    out = getattr(tmlp, name)(torch.from_numpy(a)).numpy()
    assert out.dtype == np.float32
    assert np.all(np.abs(out - ref) <= 1e-6 * np.maximum(1.0, np.abs(a)))


# ---------------------------------------------------------------- (c)

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,rows", [(3, SPQ), (3, SEQ)])
def test_fused_ln_mlp_int8_ref_matches_pallas(dtype, batch, rows):
    j, t = _both(_arrays(1, batch, rows), dtype)
    ref = pk.fused_ln_mlp(*(j[k] for k in _MLP), EPS, int8=True)
    out = ck.fused_ln_mlp_int8_ref(*(t[k] for k in _MLP), EPS)
    assert out.shape == t["x"].shape and out.dtype == t["x"].dtype
    _close(ref, out, TOL[dtype][0], "out")
    torch.testing.assert_close(ck.fused_ln_mlp_int8(*(t[k] for k in _MLP),
                                                    EPS), out, rtol=0, atol=0)
    moved = _moved_codes(j, t)
    assert moved.max() <= 1 and moved.mean() <= CODE_SHARE, moved.mean()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3])
def test_fused_ln_qkvo_attention_int8_ref_matches_pallas(dtype, batch):
    """The padded stream: seq_len 10 < spq 16, pad rows holding garbage."""
    j, t = _both(_arrays(2, batch, SPQ), dtype)
    ref = pk.fused_ln_qkvo_attention(*(j[k] for k in _QKVO), EPS, SEQ, H, HD,
                                     True)
    args = (*(t[k] for k in _QKVO), EPS, SEQ, H, HD)
    out = ck.fused_ln_qkvo_attention_int8_ref(*args)
    assert out.shape == t["x"].shape and out.dtype == t["x"].dtype
    _close(ref, out, TOL[dtype][0], "out")
    torch.testing.assert_close(ck.fused_ln_qkvo_attention_int8(*args), out,
                               rtol=0, atol=0)
    moved = _moved_codes(j, t)
    assert moved.max() <= 1 and moved.mean() <= CODE_SHARE, moved.mean()


# ---------------------------------------------------------------- (d)

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,rows", [(3, SPQ), (3, SEQ), (1, SPQ)])
def test_fused_ln_mlp_int8_bwd_ref_matches_pallas(dtype, batch, rows):
    j, t = _both(_arrays(3, batch, rows), dtype)
    n = batch * rows
    # vitax pads the rows to its row block with zeros; a zero row with a
    # zero cotangent quantizes to zero codes and adds nothing to any grad
    npad = pk._ln_mlp_pad(n, int8=True)

    def pad(a):
        return jnp.pad(a.reshape(n, D), ((0, npad - n), (0, 0)))

    ref = pk._ln_mlp_bwd_int8_call(pad(j["x"]), j["gamma"], j["beta"],
                                   j["w1"], j["b1"], j["w2"], pad(j["do"]),
                                   EPS, True)
    ref = (ref[0][:n], *ref[1:])
    args = (t["x"], t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"],
            t["do"], EPS)
    out = ck.fused_ln_mlp_int8_bwd_ref(*args)
    assert out[0].shape == t["x"].shape and out[0].dtype == t["x"].dtype
    assert all(o.dtype == torch.float32 for o in out[1:])
    _check_all(ref, out, dtype, MLP_GRADS)
    for a, b in zip(out, ck.fused_ln_mlp_int8_bwd(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,seq_len", [(1, SEQ), (3, SEQ), (2, SPQ)])
def test_fused_ln_qkvo_attention_int8_bwd_ref_matches_pallas(dtype, batch,
                                                             seq_len):
    j, t = _both(_arrays(4, batch, SPQ), dtype)
    keys = _QKVO[:6]
    ref = pk._fused_ln_qkvo_bwd(EPS, seq_len, H, HD, True, True, False,
                                False, False, None,
                                tuple(j[k] for k in keys), j["do"])
    args = (*(t[k] for k in keys), t["do"], EPS, seq_len, H, HD)
    out = ck.fused_ln_qkvo_attention_int8_bwd_ref(*args)
    assert out[0].shape == t["x"].shape and out[0].dtype == t["x"].dtype
    assert all(o.dtype == torch.float32 for o in out[1:])
    _check_all(ref, out, dtype, QKVO_GRADS)
    for a, b in zip(out, ck.fused_ln_qkvo_attention_int8_bwd(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------- K7's int8 tier (GQA)

GQA_H, GQA_KV, GQA_HD = 4, 2, 32  # D 128 = 4 query heads over 2 kv groups


def _gqa_arrays(seed, batch):
    """_arrays with the packed GQA [q | k | v] weight, (4 + 2·2)·32 wide."""
    a = _arrays(seed, batch, SPQ)
    rng = np.random.default_rng(seed + 1000)
    w = (GQA_H + 2 * GQA_KV) * GQA_HD
    a["wqkv"] = (rng.standard_normal((D, w)) * D ** -0.5).astype(np.float32)
    a["bqkv"] = (rng.standard_normal(w) * 0.1).astype(np.float32)
    return a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3])
def test_int8_gqa_twin_matches_pallas(dtype, batch):
    """K7's int8 tier forward (the kv_heads branch of vitax's int8 kernel,
    the padded stream): the output, the weights' codes bit for bit, xq
    within CODE_SHARE; the wrapper routes kv_heads < heads to the GQA
    twin."""
    j, t = _both(_gqa_arrays(16, batch), dtype)
    ref = pk.fused_ln_qkvo_attention(*(j[k] for k in _QKVO), EPS, SEQ, GQA_H,
                                     GQA_HD, True, kv_heads=GQA_KV)
    args = (*(t[k] for k in _QKVO), EPS, SEQ, GQA_H, GQA_HD)
    scratch = {}
    out = ck.fused_ln_qkvo_attention_int8_ref(*args, GQA_KV, scratch=scratch)
    assert out.shape == t["x"].shape and out.dtype == t["x"].dtype
    _close(ref, out, TOL[dtype][0], "out")
    for key, name in (("w8", "wqkv"), ("wo8", "wo")):
        q_j, s_j = pk._quant_cols_host(j[name])
        np.testing.assert_array_equal(scratch[key][0].numpy(), np.asarray(q_j))
        np.testing.assert_array_equal(scratch[key][1].numpy(),
                                      np.asarray(s_j).ravel())
    moved = _moved_codes(j, t)
    assert moved.max() <= 1 and moved.mean() <= CODE_SHARE, moved.mean()
    before = ck.fused_ln_qkvo_attention_int8_gqa.launches
    torch.testing.assert_close(
        ck.fused_ln_qkvo_attention_int8(*args, kv_heads=GQA_KV), out,
        rtol=0, atol=0)
    assert ck.fused_ln_qkvo_attention_int8_gqa.launches == before  # CPU


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8_dw", [False, True], ids=["int8_grad",
                                                        "int8_dw"])
@pytest.mark.parametrize("batch", [1, 3])
def test_int8_gqa_backward_twins_match_pallas_vjp(dtype, int8_dw, batch):
    """K7's int8 tier backward (int8_grad, and int8_dw at vitax's group of
    whole images): all 7 grads against vitax's VJP, dK and dV of each kv
    group summed over its 2 query heads; the wrappers and, under autograd,
    the Function give the twin's grads."""
    j, t = _both(_gqa_arrays(17, batch), dtype)
    keys = _QKVO[:6]
    ref = pk._fused_ln_qkvo_bwd(EPS, SEQ, GQA_H, GQA_HD, True, True, int8_dw,
                                False, False, GQA_KV,
                                tuple(j[k] for k in keys), j["do"])
    assert pk._qkvo_bwd_tile(batch, SPQ) * SPQ == ck.qkvo_dw_group(batch,
                                                                   SPQ)
    args = (*(t[k] for k in keys), t["do"], EPS, SEQ, GQA_H, GQA_HD, GQA_KV)
    twin = (ck.fused_ln_qkvo_attention_int8_dw_bwd_ref if int8_dw
            else ck.fused_ln_qkvo_attention_int8_bwd_ref)
    out = twin(*args)
    assert out[3].shape == (D, (GQA_H + 2 * GQA_KV) * GQA_HD)
    _check_all(ref, out, dtype, QKVO_GRADS)
    wrapper = (ck.fused_ln_qkvo_attention_int8_dw_bwd if int8_dw
               else ck.fused_ln_qkvo_attention_int8_bwd)
    for a, b in zip(out, wrapper(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    leaves = [t[k].clone().requires_grad_() for k in _QKVO]
    y = ck.fused_ln_qkvo_attention_int8(*leaves, EPS, SEQ, GQA_H, GQA_HD,
                                        int8_grad=True, int8_dw=int8_dw,
                                        kv_heads=GQA_KV)
    assert type(y.grad_fn).__name__ == "FusedLnQkvoAttentionFnBackward"
    y.backward(t["do"])
    for leaf, g in zip(leaves, out[:6]):
        torch.testing.assert_close(leaf.grad, g.to(leaf.dtype), rtol=0,
                                   atol=0)


def _vitax_mlp_dw_group(n, padded):
    """vitax's int8_dw group of K4's backward over n rows: one grid step's
    chunk, _ln_mlp_rows // _bwd_chunks (pallas_kernels.py:1393, :1405), n
    first padded to its row block off the handoff path."""
    if padded:
        n = pk._ln_mlp_pad(n, int8=True)
    rows = pk._ln_mlp_rows(n, int8=True)
    return rows // pk._bwd_chunks(rows)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,rows", [(3, SPQ), (3, SEQ), (8, SPQ)])
def test_fused_ln_mlp_int8_dw_bwd_ref_matches_pallas(dtype, batch, rows):
    """int8_dw (per-group int8 dW1, dW2 with row-scale folding) at vitax's
    group, from its own geometry: 3 x 16 and the ragged 3 x 10 rows pad to
    one row block of 2 chunks (16 rows: groups 16, 16, 16 and 16, 14), and
    8 x 16 = 128 rows to 2 chunks of 64."""
    j, t = _both(_arrays(13, batch, rows), dtype)
    n = batch * rows
    npad = pk._ln_mlp_pad(n, int8=True)

    def pad(a):
        return jnp.pad(a.reshape(n, D), ((0, npad - n), (0, 0)))

    ref = pk._ln_mlp_bwd_int8_call(pad(j["x"]), j["gamma"], j["beta"],
                                   j["w1"], j["b1"], j["w2"], pad(j["do"]),
                                   EPS, True, int8_dw=True)
    ref = (ref[0][:n], *ref[1:])
    args = (t["x"], t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"],
            t["do"], EPS)
    group = _vitax_mlp_dw_group(n, True)
    out = ck.fused_ln_mlp_int8_bwd_ref(*args, int8_dw=True, group=group)
    assert all(o.dtype == torch.float32 for o in out[1:])
    _check_all(ref, out, dtype, MLP_GRADS)
    # the bf16-product twin is further off: the dW is int8
    bf = ck.fused_ln_mlp_int8_bwd_ref(*args)
    assert not torch.equal(bf[3], out[3]) and not torch.equal(bf[5], out[5])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,seq_len", [(1, SEQ), (3, SEQ), (4, SPQ)])
def test_fused_ln_qkvo_attention_int8_dw_bwd_ref_matches_pallas(dtype, batch,
                                                                seq_len):
    """int8_dw (per-group int8 dWqkv, dWo) at vitax's group, whole images:
    tile·spq rows (_qkvo_bwd_tile: 4 at spq 16, halved until it divides
    the batch), the port's own rule too."""
    j, t = _both(_arrays(14, batch, SPQ), dtype)
    keys = _QKVO[:6]
    ref = pk._fused_ln_qkvo_bwd(EPS, seq_len, H, HD, True, True, True,
                                False, False, None,
                                tuple(j[k] for k in keys), j["do"])
    group = pk._qkvo_bwd_tile(batch, SPQ) * SPQ
    assert group == ck.qkvo_dw_group(batch, SPQ)
    args = (*(t[k] for k in keys), t["do"], EPS, seq_len, H, HD)
    out = ck.fused_ln_qkvo_attention_int8_bwd_ref(*args, int8_dw=True,
                                                  group=group)
    assert all(o.dtype == torch.float32 for o in out[1:])
    _check_all(ref, out, dtype, QKVO_GRADS)
    for a, b in zip(out, ck.fused_ln_qkvo_attention_int8_dw_bwd(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["fused_ln_mlp_int8_dw_bwd",
                                  "fused_ln_qkvo_attention_int8_dw_bwd"])
def test_int8_dw_wrappers_hand_out_the_column_codes(name):
    """The int8_dw wrappers' `scratch` adds the column codes of the folded
    operands (h1c, xnc for K4; atc, xnc for K3) as [rows, width] int8, with
    one fp32 scale a column a group, each code tensor equal to vitax's
    _quant_cols of the same folded group."""
    _, t = _both(_arrays(15, 3, SPQ), "float32")
    mlp = "mlp" in name
    keys = _MLP[:6] if mlp else _QKVO[:6]
    args = [t[k] for k in keys] + [t["do"]] + (
        [EPS] if mlp else [EPS, SEQ, H, HD])
    scratch = {}
    getattr(ck, name)(*args, scratch=scratch)
    n = 3 * SPQ
    group = ck.MLP_DW_GROUP if mlp else ck.qkvo_dw_group(3, SPQ)
    groups = -(-n // group)
    pairs = (("h1c", "doq", M), ("xnc", "dh1q", D)) if mlp else \
        (("atc", "doq", H * HD), ("xnc", "dqq", D))
    for key, _, width in pairs:
        q, s = scratch[key]
        assert q.dtype == torch.int8 and q.shape == (n, width), key
        assert s.dtype == torch.float32 and s.shape == (groups * width,), key
    # the first group of the MLP's h1c from vitax's quantizer: h1·sdo
    if mlp:
        xhat, _ = ck._ln_stats(t["x"].reshape(n, D), EPS)
        xn = ck._affine(xhat, t["gamma"], t["beta"])
        xq, sx = quant.quant_rows(xn)
        w1c, s1c = quant.quant_cols_host(t["w1"])
        a1 = ck._dequant(quant.int_mm(xq, w1c), sx, s1c, t["b1"])
        h1 = tmlp.gelu_q(a1)
        sdo = scratch["doq"][1].reshape(n, 1)
        q_j, s_j = pk._quant_cols(jnp.asarray((h1 * sdo)[:group].numpy()))
        np.testing.assert_array_equal(scratch["h1c"][0][:group].numpy(),
                                      np.asarray(q_j))
        np.testing.assert_array_equal(scratch["h1c"][1][:M].numpy(),
                                      np.asarray(s_j).ravel())


_WEIGHT_CODES = {
    "fused_ln_mlp_int8": dict(w1q=("_quant_cols_host", "w1"),
                              w2q=("_quant_cols_host", "w2")),
    "fused_ln_mlp_int8_bwd": dict(w1r=("_quant_rows_host", "w1"),
                                  w2r=("_quant_rows_host", "w2"),
                                  w1c=("_quant_cols_host", "w1")),
    "fused_ln_qkvo_attention_int8": dict(w8=("_quant_cols_host", "wqkv"),
                                         wo8=("_quant_cols_host", "wo")),
    "fused_ln_qkvo_attention_int8_bwd": dict(
        w8=("_quant_cols_host", "wqkv"), w8r=("_quant_rows_host", "wqkv"),
        wo8r=("_quant_rows_host", "wo")),
}


@pytest.mark.parametrize("name", sorted(_WEIGHT_CODES))
def test_int8_wrappers_hand_out_the_codes(name):
    """A wrapper's `scratch` receives the (codes, scale) pairs of its
    kernel, here of its twin on CPU tensors (the card compares the two):
    the weights' equal vitax's quantizers bit for bit; xq within CODE_SHARE
    of vitax's LN codes; doq equal to vitax's quantized do; every activation
    code tensor int8 [rows, width] with one fp32 scale a row."""
    j, t = _both(_arrays(8, 3, SPQ), "float32")
    keys = _MLP if "mlp" in name else _QKVO
    args = [t[k] for k in keys]
    if name.endswith("_bwd"):
        args = args[:6] + [t["do"]]
    args += [EPS] if "mlp" in name else [EPS, SEQ, H, HD]
    scratch = {}
    getattr(ck, name)(*args, scratch=scratch)
    for key, (fn, w) in _WEIGHT_CODES[name].items():
        q_j, s_j = getattr(pk, fn)(j[w])
        q, s = scratch.pop(key)
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
        np.testing.assert_array_equal(s.numpy(), np.asarray(s_j).ravel())
    n = 3 * SPQ
    for key, (q, s) in scratch.items():
        assert q.dtype == torch.int8 and q.shape[0] == n, key
        assert s.dtype == torch.float32 and s.shape == (n,), key
    moved = np.abs(scratch["xq"][0].numpy().astype(np.int32)
                   - np.asarray(_vitax_ln_codes(j["x"], j["gamma"], j["beta"]),
                                np.int32))
    assert moved.max() <= 1 and moved.mean() <= CODE_SHARE, moved.mean()
    if "doq" in scratch:
        q_j, s_j = pk._quant_rows(j["do"].reshape(n, D))
        np.testing.assert_array_equal(scratch["doq"][0].numpy(),
                                      np.asarray(q_j))


# ---------------------------------------------------------------- (e)

@pytest.mark.parametrize("half", ["mlp", "attention"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_alone_keeps_the_bf16_backward(half, dtype):
    """`--int8` without `--int8-grad`: under a linear loss the grads of the
    int8 forward equal the bf16 tier's exactly (vitax's own requirement,
    tests/test_pallas_kernels.py:254-313), and through the Functions the
    int8-grad backward differs from them."""
    _, t = _both(_arrays(5, 3, SPQ), dtype)
    keys, extra = (_MLP, (EPS,)) if half == "mlp" else \
        (_QKVO, (EPS, SEQ, H, HD))
    fused = {"mlp": (ck.fused_ln_mlp, ck.fused_ln_mlp_int8),
             "attention": (ck.fused_ln_qkvo_attention,
                           ck.fused_ln_qkvo_attention_int8)}[half]
    c = torch.from_numpy(np.random.default_rng(6).standard_normal(
        t["x"].shape).astype(np.float32))

    def grads(fn, **kw):
        leaves = [t[k].clone().requires_grad_() for k in keys]
        out = fn(*leaves, *extra, **kw)
        (out.float() * c).sum().backward()
        return [leaf.grad for leaf in leaves]

    ref = grads(fused[0])
    for a, b in zip(grads(fused[1], int8_grad=False), ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in
                   zip(grads(fused[1], int8_grad=True), ref))


# ---------------------------------------------------------------- (f), (g)

SMALL = dict(emb_dim=D, mlp_dim=M, num_heads=H, num_layers=2)


def _cfgs(dtype, image=48, patch=16, **kw):
    kw = dict(fused_qkv=True, fused_mlp=True, use_pallas=True,
              patch_size=(patch, patch), **SMALL, **kw)
    return (j_arch("tiny", image, 10).replace(dtype=getattr(jnp, dtype), **kw),
            t_arch("tiny", image, 10).replace(dtype=getattr(torch, dtype),
                                               **kw))


def _weights(jc):
    p = jax.tree.map(np.asarray, jvit.init_params(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        p)


def _images(batch, image=48, seed=1):
    return np.random.default_rng(seed).uniform(
        -1, 1, (batch, image, image, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_forward_matches_vitax(dtype):
    """eval mode at spq 16 (seq 10): the padded stream through K3 and K4."""
    jc, tc = _cfgs(dtype, **INT8)
    w = _weights(jc)
    img = _images(3)
    ref = jvit.apply(jax.tree.map(jnp.asarray, w), jnp.asarray(img, jc.dtype),
                     jc)
    with torch.inference_mode():
        out = tvit.apply(tvit.params_from_jax(w),
                         torch.from_numpy(img).to(tc.dtype), tc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32),
                               rtol=TOL[dtype][0], atol=TOL[dtype][0])


def _vitax_layout(tree):
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return t.detach().float().numpy()

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = jax.tree.map(lambda *a: np.stack(a),
                                 *[conv(lp) for lp in tree["layers"]])
    return out


def test_three_int8_grad_train_steps_match_vitax():
    """All four int8 flags (the `--int8-grad` configuration) on a stream
    vitax does not hand off (K5 takes spq <= 128): image 48 at patch 4,
    145 tokens -> spq 152. fp32: losses 5e-3 relative, params
    2e-3·max(1, |p|). Wider than the bf16 tier's 1e-4/1e-3: the LN, the
    softmax and the GELU round in the last ulp differently in XLA and torch
    (rsqrt, exp, sum order), and where a value sits on a .5 tie its code moves
    one step; over 2 layers x 3 steps a few such codes (one in 4e4 per
    quantized tensor) move the loss by up to 9.5e-4 relative and the params
    by 4e-4 (measured)."""
    _three_train_steps(INT8_GRAD, patch=4)


@pytest.mark.parametrize("patch", [4, 16], ids=["spq152", "spq16-handoff"])
def test_three_int8_dw_train_steps_match_vitax(patch, monkeypatch):
    """`--int8-dw` (all four int8 flags and the per-group int8 dW): at spq
    152 through K3/K4, and at image 48 patch 16 (10 tokens, spq 16) through
    the K5 handoff, with vitax's int8_dw groups (K3 whole images, the port's
    rule too; K4 a grid step's chunk of the padded or, on the handoff, the
    unpadded rows). The same bands as the --int8-grad steps, for the same
    reason."""
    n = 2 * (152 if patch == 4 else 16)
    monkeypatch.setattr(ck, "MLP_DW_GROUP",
                        _vitax_mlp_dw_group(n, padded=patch == 4))
    _three_train_steps(dict(INT8_GRAD, int8_dw=True), patch=patch)


def _three_train_steps(flags, patch):
    jc, tc = _cfgs("float32", patch=patch, **flags)
    w = _weights(jc)
    rng = np.random.default_rng(7)
    batches = [(_images(2, seed=10 + i),
                rng.integers(0, 10, 2).astype(np.int32)) for i in range(3)]
    total, pct, lr, wd = 10, 0.2, 0.003, 1e-4
    tx = j_sgd(j_lr(lr, total, pct), momentum_schedule=j_mom(total, pct),
               weight_decay=wd)
    state = j_state(jax.tree.map(jnp.asarray, w), tx, jax.random.PRNGKey(1))
    step = j_step(jc, tx, donate=False)
    j_losses = []
    for img, lab in batches:
        state, m = step(state, jnp.asarray(img), jnp.asarray(lab))
        j_losses.append(float(m["loss"]))
    params = tvit.params_from_jax(w)
    opt, sched = t_sgd(params, lr, total, pct, weight_decay=wd)
    tstate = t_state(params, opt, sched, torch.Generator().manual_seed(1))
    tstep = t_step(tc, opt, sched)
    t_losses = [float(tstep(tstate, torch.from_numpy(img),
                            torch.from_numpy(lab))[1]["loss"])
                for img, lab in batches]
    np.testing.assert_allclose(t_losses, j_losses, rtol=5e-3)
    ref = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, state.params))[0]
    out = dict(jax.tree_util.tree_flatten_with_path(
        _vitax_layout(tstate.params))[0])
    for path, r in ref:
        bound = 2e-3 * max(1.0, float(np.abs(r).max()))
        assert np.abs(out[path] - r).max() <= bound, \
            jax.tree_util.keystr(path)


# ---------------------------------------------------------------- (h)

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flags", [dict(INT8_GRAD), dict(INT8_GRAD,
                                                          int8_dw=True)],
                         ids=["int8-grad", "int8-dw"])
def test_int8_handoff_forward_matches_vitax(flags, dtype):
    """The padded stream at spq 16 <= 128 with all four int8 flags, where
    both packages take the K5 handoff (eval mode; int8_dw changes only the
    backward): logits against vitax's, max|Δ| <= TOL·max(1, max|logit|).
    bf16 and int8 round both paths at many places: the port's handoff lands
    2.6e-2 from vitax's handoff here (max|logit| 2.8), its non-handoff path
    1.9e-2 from vitax's, while each package's two paths sit 5.4e-2 to 5.9e-2
    apart (measured)."""
    jc, tc = _cfgs(dtype, **flags)
    w = _weights(jc)
    img = _images(2)
    ref = jvit.apply(jax.tree.map(jnp.asarray, w), jnp.asarray(img, jc.dtype),
                     jc)
    with torch.inference_mode():
        out = tvit.apply(tvit.params_from_jax(w),
                         torch.from_numpy(img).to(tc.dtype), tc)
    _close(ref, out, TOL[dtype][0], "logits")


TINY = ["--dataset", "Synthetic", "--model-arch", "tiny", "--num-workers", "0",
        "--dtype", "float32", "--fused-qkv", "--fused-mlp"]
# the tiny preset at D 128 (2 heads of 64): vitax's fused gates take D %
# 128 == 0 only, and the port picks its fused halves where they do
WIDE_TINY = dict(patch=16, emb_dim=128, mlp_dim=256, num_heads=2,
                 num_layers=3)


def test_train_cli_int8_grad_runs_the_int8_twins(tmp_path, monkeypatch):
    """`--int8-grad` at image 224 (spq 200, no handoff) maps all four int8
    flags and trains through the int8 forward and backward twins."""
    calls = dict.fromkeys(("fused_ln_mlp_int8_ref",
                           "fused_ln_mlp_int8_bwd_ref",
                           "fused_ln_qkvo_attention_int8_ref",
                           "fused_ln_qkvo_attention_int8_bwd_ref"), 0)
    for name in calls:
        fn = getattr(ck, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(ck, name, counted)
    monkeypatch.setitem(ARCH_PRESETS, "tiny", WIDE_TINY)
    out = train_cli.main(TINY + [
        "--image-size", "224", "--batch-size", "4", "--synthetic-samples", "8",
        "--train-steps", "2", "--warmup-steps", "0", "--int8-grad",
        "--exp-root", str(tmp_path)], device="cpu")
    losses = out["epochs"][0]["train"]["losses"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    # 3 layers: 2 steps forward and backward, and 2 eval batches forward
    assert calls == {"fused_ln_mlp_int8_ref": 12,
                     "fused_ln_mlp_int8_bwd_ref": 6,
                     "fused_ln_qkvo_attention_int8_ref": 12,
                     "fused_ln_qkvo_attention_int8_bwd_ref": 6}


def test_train_cli_int8_flag_map():
    import argparse
    ns = argparse.Namespace(model_arch="b16", image_size=224, num_classes=10,
                            dtype="bfloat16", fused_qkv=None, fused_mlp=None,
                            token_keep=1.0, no_pallas=False, int8=False,
                            int8_grad=True, int8_dw=False)
    cfg = train_cli.model_config_from_cli(ns, on_gpu=True)
    assert (cfg.int8_mlp, cfg.int8_attn, cfg.int8_mlp_grad,
            cfg.int8_attn_grad, cfg.int8_dw) == (True,) * 4 + (False,)
    ns.int8_grad, ns.int8 = False, True
    cfg = train_cli.model_config_from_cli(ns, on_gpu=True)
    assert cfg.int8_mlp and cfg.int8_attn and not cfg.int8_mlp_grad


@pytest.mark.parametrize("flag", ["--int8-dw", "--int8-grad"])
def test_train_cli_int8_grad_tiers_hand_off_short_streams(flag, tmp_path,
                                                          monkeypatch):
    """`--int8-grad` and `--int8-dw` at image 32 (spq 8 <= 128): the train
    steps and the eval batches run K5's twins, and the backward the int8
    twin of their tier."""
    names = ("fused_ln_qkvo_attention_int8_ho_ref",
             "fused_ln_qkvo_attention_int8_dw_bwd_ref",
             "fused_ln_qkvo_attention_int8_bwd_ref")
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(ck, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(ck, name, counted)
    monkeypatch.setitem(ARCH_PRESETS, "tiny", WIDE_TINY)
    out = train_cli.main(TINY + [
        "--image-size", "32", "--batch-size", "4", "--synthetic-samples", "8",
        "--train-steps", "2", "--warmup-steps", "0", "--exp-root",
        str(tmp_path), flag], device="cpu")
    losses = out["epochs"][0]["train"]["losses"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    # 3 layers: 2 train steps and 2 eval batches forward, 2 steps backward
    # (the int8_dw twin calls the int8 backward twin with int8_dw on)
    dw = flag == "--int8-dw"
    assert calls == {"fused_ln_qkvo_attention_int8_ho_ref": 12,
                     "fused_ln_qkvo_attention_int8_dw_bwd_ref": 6 * dw,
                     "fused_ln_qkvo_attention_int8_bwd_ref": 6}


def test_eval_cli_int8_serves_through_the_int8_twin(monkeypatch):
    seen = []
    fn = ck.fused_ln_mlp_int8_ref
    monkeypatch.setattr(ck, "fused_ln_mlp_int8_ref",
                        lambda *a, **k: seen.append(1) or fn(*a, **k))
    out = eval_cli.main(TINY + ["--image-size", "32", "--batch-size", "8",
                                "--synthetic-samples", "8", "--int8"],
                        device="cpu")
    assert len(seen) == 3 and np.isfinite(out["loss"])


@pytest.mark.parametrize("tag", ["int4", "int4-grad"])
def test_convergence_harness_names_the_item_of_unported_tags(tag):
    """The tags that named their unported item (K11) now carry vitax's
    definitions and pass the tag check (here the harness then stops: no
    card); no tag is left unported."""
    from vitax_torch.scripts import int8_convergence as harness
    assert harness.CONFIGS[tag] == _vitax_harness_configs()[tag]
    assert not hasattr(harness, "UNPORTED")
    assert set(harness.CONFIGS) == {"bf16", "int8-fwd", "int8-full",
                                    "int8-dw", "tokdrop-0.5", "tokdrop-0.75",
                                    "int4", "int4-grad"}
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA card"):
            harness.main(["bf16", tag])


def _vitax_harness_configs():
    """CONFIGS of scripts/int8_convergence.py, read from its source (the
    script trains when it is imported)."""
    import ast
    import pathlib
    src = pathlib.Path(pk.__file__).resolve().parents[2] / "scripts" / \
        "int8_convergence.py"
    for node in ast.parse(src.read_text()).body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "CONFIGS":
            return eval(compile(ast.Expression(node.value), str(src), "eval"),
                        {"dict": dict})
    raise AssertionError("no CONFIGS in the vitax harness")


@pytest.mark.parametrize("tag", ["int8-dw", "tokdrop-0.5", "tokdrop-0.75"])
def test_convergence_harness_tags_are_vitaxs(tag):
    """The tags ported with int8_dw and K5 carry vitax's definitions, and
    the harness accepts them (here it then stops: no card)."""
    from vitax_torch.scripts import int8_convergence as harness
    assert harness.CONFIGS[tag] == _vitax_harness_configs()[tag]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA card"):
            harness.main(["bf16", tag])


# ---------------------------------------------------------------- K8 int8

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,cap", [(1, 6), (3, 9)])
def test_fused_ln_qkvo_attention_rect_int8_ref_matches_pallas(dtype, batch,
                                                               cap):
    """K8's W8A8 twin against vitax's rect int8 kernel (seq_len 10 < spq
    16, cpq 8 or 16 with zero pad rows): the weights' codes and scales are
    exactly vitax's for its split Wq and Wkv; the LN codes of both row sets
    within CODE_SHARE of one step; the output rows equal K3's twin's on the
    same tokens bit for bit."""
    arr = _arrays(9, batch, SPQ)
    rng = np.random.default_rng(9)
    idx = np.stack([rng.permutation(SEQ)[:cap] for _ in range(batch)])
    xc = np.zeros((batch, (cap + 7) // 8 * 8, D), np.float32)
    xc[:, :cap] = np.take_along_axis(arr["x"], idx[..., None], axis=1)
    j, t = _both(dict(arr, xc=xc), dtype)
    jxc = j["xc"].astype(j["x"].dtype)
    txc = t["xc"].to(t["x"].dtype)
    rest = _QKVO[1:]
    ref = pk.fused_ln_qkvo_attention_rect(jxc, j["x"], *(j[k] for k in rest),
                                          EPS, SEQ, H, HD, True)
    scratch = {}
    args = (txc, t["x"], *(t[k] for k in rest), EPS, SEQ, H, HD)
    out = ck.fused_ln_qkvo_attention_rect_int8_ref(*args, scratch=scratch)
    assert out.shape == txc.shape and out.dtype == txc.dtype
    _close(ref[:, :cap], out[:, :cap], TOL[dtype][0], "out")
    hhd = H * HD
    w8, sw = scratch["w8"]
    for cols, wj in ((slice(0, hhd), j["wqkv"][:, :hhd]),
                     (slice(hhd, 3 * hhd), j["wqkv"][:, hhd:])):
        qj, sj = pk._quant_cols_host(wj)
        np.testing.assert_array_equal(w8[:, cols].numpy(), np.asarray(qj))
        np.testing.assert_array_equal(sw[cols].numpy(), np.asarray(sj))
    for key, rows in (("xq", j["xc"]), ("xqk", j["x"])):
        moved = np.abs(np.asarray(_vitax_ln_codes(rows.astype(j["x"].dtype),
                                                  j["gamma"], j["beta"]),
                                  np.int32)
                       - scratch[key][0].numpy().astype(np.int32))
        assert moved.max() <= 1 and moved.mean() <= CODE_SHARE, key
    torch.testing.assert_close(ck.fused_ln_qkvo_attention_rect_int8(*args),
                               out, rtol=0, atol=0)
    square = ck.fused_ln_qkvo_attention_int8_ref(
        *(t[k] for k in _QKVO), EPS, SEQ, H, HD)
    gathered = torch.gather(square, 1, torch.from_numpy(idx)[..., None]
                            .expand(-1, -1, D))
    torch.testing.assert_close(out[:, :cap], gathered, rtol=0, atol=0)


# ------------------------------------------------------- K8 int8 backward

RECT_GRADS = ("dxc", "dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwo", "dbo")


def _rect_bwd_inputs(batch, spq, seq, cap, seed):
    """x [B, spq, D], xc: `cap` of its first seq rows in random order,
    zero-padded to cpq = round_up(cap, 8), do zero on xc's pad rows (the
    caller's row cut)."""
    arr = _arrays(seed, batch, spq)
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(seq)[:cap] for _ in range(batch)])
    cpq = (cap + 7) // 8 * 8
    xc = np.zeros((batch, cpq, D), np.float32)
    xc[:, :cap] = np.take_along_axis(arr["x"], idx[..., None], axis=1)
    do = rng.standard_normal((batch, cpq, D)).astype(np.float32)
    do[:, cap:] = 0
    return dict(arr, xc=xc, do=do)


def _rect_both(batch, spq, seq, cap, seed, dtype):
    j, t = _both(_rect_bwd_inputs(batch, spq, seq, cap, seed), dtype)
    rest = ("gamma", "beta", "wqkv", "bqkv", "wo")
    jargs = (j["xc"].astype(j["x"].dtype), j["x"], *(j[k] for k in rest))
    targs = (t["xc"].to(t["x"].dtype), t["x"], *(t[k] for k in rest),
             t["do"], EPS, seq, H, HD)
    return j, t, jargs, targs


# (batch, spq, seq_len, cap): ragged seq_len 13 in spq 16, cap 7 (cpq 8),
# at b 2 and 4 (vitax's grid tile, and so the int8_dw groups, change)
RECT_INT8_CASES = [(2, 16, 13, 7), (4, 16, 13, 7)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,spq,seq,cap", RECT_INT8_CASES)
@pytest.mark.parametrize("int8_dw", [False, True])
def test_rect_int8_bwd_ref_matches_pallas(dtype, batch, spq, seq, cap,
                                          int8_dw):
    """K8's backward under int8_grad (and int8_dw) against vitax's rect VJP
    on every output. The weights' codes and scales are vitax's exactly: Wq8
    and Wkv8 per column of its slices, Wq_r and Wkv_r per row of the slices
    (not of Wqkv's whole rows), Wo_r per row. The int8_dw groups are vitax's
    grid step, tile·cpq rows of xc and tile·spq rows of x; the bf16-product
    twin misses the int8 weight grads."""
    j, t, jargs, targs = _rect_both(batch, spq, seq, cap, 50 + batch, dtype)
    ref = pk._fused_ln_qkvo_rect_bwd(EPS, seq, H, HD, True, True, int8_dw,
                                     False, False, jargs,
                                     j["do"].astype(j["x"].dtype))
    tile = pk._qkvo_bwd_tile(batch, spq)
    cpq = targs[0].shape[1]
    assert ck.qkvo_rect_dw_groups(batch, cpq, spq) == (tile * cpq,
                                                       tile * spq)
    scratch = {}
    twin = (ck.fused_ln_qkvo_attention_rect_int8_dw_bwd_ref if int8_dw
            else ck.fused_ln_qkvo_attention_rect_int8_bwd_ref)
    out = twin(*targs, scratch=scratch)
    assert all(o.dtype == torch.float32 for o in out[2:])
    _check_all(ref, out, dtype, RECT_GRADS)
    hhd = H * HD
    for key, w, host in (("wq8r", j["wqkv"][:, :hhd], pk._quant_rows_host),
                         ("wkv8r", j["wqkv"][:, hhd:], pk._quant_rows_host),
                         ("wo8r", j["wo"], pk._quant_rows_host)):
        qj, sj = host(w)
        np.testing.assert_array_equal(scratch[key][0].numpy(),
                                      np.asarray(qj))
        np.testing.assert_array_equal(scratch[key][1].numpy(),
                                      np.asarray(sj))
    w8, sw = scratch["w8"]
    for cols, wj in ((slice(0, hhd), j["wqkv"][:, :hhd]),
                     (slice(hhd, 3 * hhd), j["wqkv"][:, hhd:])):
        qj, sj = pk._quant_cols_host(wj)
        np.testing.assert_array_equal(w8[:, cols].numpy(), np.asarray(qj))
        np.testing.assert_array_equal(sw[cols].numpy(), np.asarray(sj))
    wrapper = (ck.fused_ln_qkvo_attention_rect_int8_dw_bwd if int8_dw
               else ck.fused_ln_qkvo_attention_rect_int8_bwd)
    for a, b in zip(out, wrapper(*targs)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if int8_dw:
        assert scratch["atc"][1].numel() == (batch // tile) * hhd
        assert scratch["xnk"][1].numel() == (batch // tile) * D
        bf = ck.fused_ln_qkvo_attention_rect_int8_bwd_ref(*targs)
        assert not torch.equal(bf[4], out[4]) and not torch.equal(bf[6],
                                                                  out[6])


def test_rect_int8_alone_keeps_the_bf16_backward():
    """--int8 without --int8-grad: K8's int8 forward, its bf16 backward
    (vitax's tier rule, :4526), under the autograd Function."""
    _, t, _, targs = _rect_both(2, 16, 13, 7, 60, "float32")
    bo = torch.zeros(D)
    leaves = [a.clone().requires_grad_() for a in targs[:7]]
    y = ck.fused_ln_qkvo_attention_rect_int8(*leaves, bo, *targs[8:])
    y.backward(targs[7])
    ref = ck.fused_ln_qkvo_attention_rect_bwd_ref(*targs)
    for leaf, grad in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad, grad, rtol=0, atol=0)
    leaves = [a.clone().requires_grad_() for a in targs[:7]]
    y = ck.fused_ln_qkvo_attention_rect_int8(*leaves, bo, *targs[8:],
                                             int8_grad=True, int8_dw=True)
    y.backward(targs[7])
    ref = ck.fused_ln_qkvo_attention_rect_int8_dw_bwd_ref(*targs)
    for leaf, grad in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad, grad, rtol=0, atol=0)
