"""K9 (the attention half after its LN, Res-ViT's `attention` under a mesh)
composed from plain versions in the order its Hopper entry points launch
them on the card (csrc/qkvo_attention.cu, csrc/qkvo_attention_bwd.cu, both
qkvo_sm90.cuh's sequence, which K1 runs after its LN), on CPU tensors.

- The forward: qkv on `gemm_sm90_ref("nn_bias")`, K13's core on the packed
  rows (p from the row statistics in exp2, rounded to bf16 once; the head
  outputs rounded to bf16 once), the out-projection on `nn_bias`. Against
  the twin (`fused_qkvo_attention_ref`) and vitax's `fused_qkvo_attention`
  under `jax.jit` in interpret mode within 2e-2 (K13's p comes from exp2 of
  the scaled scores, the twin's and vitax's from exp).
- The backward: the recompute above, dattn (`nt_store`), dWo (`tn_f32`),
  dbo, K13's three passes (the row pass's dd from the bf16 head outputs),
  dx (`nt_store`: one rounding, no LN tail), dWqkv (`tn_f32`), dbqkv.
  Against the twin and vitax's VJP (`_fused_qkvo_bwd`) under `jax.jit` in
  interpret mode within 2e-2, with dY nonzero on the pad rows (vitax
  computes those query rows too).
- K9 on x̂ = LN(x) against K1 composed in its own launch order (LN, then the
  same pieces; the backward's dxn in fp32 and the LN tail): the forward
  output and the backward's dWqkv, dbqkv, dWo and dbo to the bit.
- A source check that K9's entry points run the shared Hopper sequence
  only: no whole-row core, no gemm.cuh product, no P or ds.

Tiny widths: D 128, 2 heads of 64, spq 24 with seq_len 21, bf16, 2 images.
"""

import functools
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tests import torch_int8_compose as compose  # noqa: E402
from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax_torch.kernels import build  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402
from vitax_torch.ops.layernorm import layer_norm_ref  # noqa: E402

D, H, HD, SPQ, SEQ, EPS = 128, 2, 64, 24, 21, 1e-5
HHD = H * HD
B = 2
BF = torch.bfloat16
TOL = 2e-2
NAMES = ("dx", "dwqkv", "dbqkv", "dwo", "dbo")
_MATS = ("x", "xh", "do", "wqkv", "wo")


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _arrays(seed):
    """x [B, SPQ, D] (the pad rows garbage, as the padded stream may hold
    them), x̂ at an LN output's scale, γ, β, the weights, and dY, nonzero
    on the pad rows too."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(x=n(B, SPQ, D) * 1.5 + 0.3, xh=n(B, SPQ, D),
                do=n(B, SPQ, D), gamma=1 + n(D, scale=0.1),
                beta=n(D, scale=0.1), wqkv=n(D, 3 * HHD, scale=D ** -0.5),
                bqkv=n(3 * HHD, scale=0.1), wo=n(HHD, D, scale=HHD ** -0.5),
                bo=n(D, scale=0.1))


def _torch(arrays):
    return {k: torch.from_numpy(v).to(BF if k in _MATS else torch.float32)
            for k, v in arrays.items()}


def _jax(arrays):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in _MATS else jnp.float32)
            for k, v in arrays.items()}


def _heads(qkv):
    return tuple(ck._split_heads(qkv.view(B, SPQ, -1)[..., i * HHD:
                                                      (i + 1) * HHD], H)
                 for i in range(3))


def k9_fwd_composed(xh, t):
    """K9's forward in its launch order on x̂ [B, SPQ, D]: out, and the
    recompute's packed qkv rows, per-head q, k, v and bf16 head outputs."""
    x2 = xh.reshape(-1, D)
    qkv = ck.gemm_sm90_ref("nn_bias", x2, t["wqkv"], t["bqkv"])
    q, k, v = _heads(qkv)
    o = compose.k13_core_f32(q, k, v, SEQ).to(BF)
    out = ck.gemm_sm90_ref("nn_bias", ck._heads_to_rows(o), t["wo"], t["bo"])
    return out.view(B, SPQ, D), (q, k, v, o)


def k9_bwd_composed(xh, t):
    """K9's backward in its launch order: (dx, dWqkv, dbqkv, dWo, dbo), and
    the core's dk, dv [B, H, SPQ, HD]."""
    x2, do2 = xh.reshape(-1, D), t["do"].reshape(-1, D)
    _, (q, k, v, o) = k9_fwd_composed(xh, t)
    attn = ck._heads_to_rows(o)
    dattn = ck.gemm_sm90_ref("nt_store", do2, t["wo"])
    dwo = ck.gemm_sm90_ref("tn_f32", attn, do2)
    dbo = do2.float().sum(dim=0)
    d_o = ck._split_heads(dattn.view(B, SPQ, -1), H)
    dq, dk, dv = compose.k13_core_grads(q, k, v, o, d_o, SEQ)
    dqkv = torch.cat([ck._heads_to_rows(g) for g in (dq, dk, dv)], dim=1)
    dx = ck.gemm_sm90_ref("nt_store", dqkv, t["wqkv"])
    dw = ck.gemm_sm90_ref("tn_f32", x2, dqkv)
    return (dx.view(B, SPQ, D), dw, dqkv.float().sum(dim=0), dwo, dbo), dk, dv


def k1_fwd_composed(t):
    """K1's forward (ln_qkvo_attention.cu, kv_heads == heads) in its launch
    order on x: LN, qkv, K13's core on the packed rows, the
    out-projection."""
    xn = layer_norm_ref(t["x"], t["gamma"], t["beta"], EPS).reshape(-1, D)
    qkv = ck.gemm_sm90_ref("nn_bias", xn, t["wqkv"], t["bqkv"])
    q, k, v = _heads(qkv)
    o = compose.k13_core_f32(q, k, v, SEQ).to(BF)
    out = ck.gemm_sm90_ref("nn_bias", ck._heads_to_rows(o), t["wo"], t["bo"])
    return out.view(B, SPQ, D)


def k1_bwd_composed(t):
    """K1's backward (ln_qkvo_attention_bwd.cu, kv_heads == heads) in its
    launch order: the LN and qkv recompute, the core, dattn, dWo, dbo,
    K13's passes, dxn in fp32, dWqkv, dbqkv, the LN tail. Returns (dx, dγ,
    dβ, dWqkv, dbqkv, dWo, dbo), the twin's order."""
    do2 = t["do"].reshape(-1, D)
    xn = layer_norm_ref(t["x"], t["gamma"], t["beta"], EPS).reshape(-1, D)
    qkv = ck.gemm_sm90_ref("nn_bias", xn, t["wqkv"], t["bqkv"])
    q, k, v = _heads(qkv)
    o = compose.k13_core_f32(q, k, v, SEQ).to(BF)
    attn = ck._heads_to_rows(o)
    dattn = ck.gemm_sm90_ref("nt_store", do2, t["wo"])
    dwo = ck.gemm_sm90_ref("tn_f32", attn, do2)
    dbo = do2.float().sum(dim=0)
    d_o = ck._split_heads(dattn.view(B, SPQ, -1), H)
    dqkv = torch.cat([ck._heads_to_rows(g) for g in compose.k13_core_grads(
        q, k, v, o, d_o, SEQ)], dim=1)
    dxn = ck.gemm_sm90_ref("nt_f32", dqkv, t["wqkv"])
    dw = ck.gemm_sm90_ref("tn_f32", xn, dqkv)
    xhat, rstd = ck._ln_stats(t["x"].reshape(-1, D).float(), EPS)
    dx, dg, dbe = ck._ln_bwd_tail(dxn, xhat, rstd, t["gamma"])
    return (dx.to(BF).view(B, SPQ, D), dg, dbe, dw, dqkv.float().sum(dim=0),
            dwo, dbo)


def _close(out, ref, what):
    ref = np.asarray(ref, np.float32)
    out = out.float().numpy().reshape(ref.shape)
    bound = TOL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= bound, f"{what}: max error {err:.3e} > {bound:.3e}"


def _k9_args(t):
    return (t["xh"], t["wqkv"], t["bqkv"], t["wo"])


def test_forward_launch_order_matches_its_twin_and_vitax_under_jit():
    arrays = _arrays(271)
    j, t = _jax(arrays), _torch(arrays)
    out, _ = k9_fwd_composed(t["xh"], t)
    twin = ck.fused_qkvo_attention_ref(*_k9_args(t), t["bo"], SEQ, H, HD)
    assert out.dtype == BF and out.shape == twin.shape == (B, SPQ, D)
    _close(out, twin.float().numpy(), "K9 out vs its twin")
    fn = jax.jit(lambda *a: pk.fused_qkvo_attention(*a, SEQ, H, HD))
    ref = fn(j["xh"], j["wqkv"], j["bqkv"], j["wo"], j["bo"])
    # vitax's pad query rows attend as the port's do; every row is held
    _close(out, jnp.asarray(ref, jnp.float32), "K9 vs vitax")


def test_backward_launch_order_matches_its_twin_and_vitax_under_jit():
    arrays = _arrays(272)
    j, t = _jax(arrays), _torch(arrays)
    outs, dk, dv = k9_bwd_composed(t["xh"], t)
    # the key pass's masked keys, and the pad rows, whose dY is nonzero
    assert not dk[:, :, SEQ:].any() and not dv[:, :, SEQ:].any()
    assert dk[:, :, :SEQ].any() and t["do"][:, SEQ:].any()
    twin = ck.fused_qkvo_attention_bwd_ref(*_k9_args(t), t["do"], SEQ, H, HD)
    fn = jax.jit(functools.partial(pk._fused_qkvo_bwd, SEQ, H, HD))
    refs = fn((j["xh"], j["wqkv"], j["bqkv"], j["wo"]), j["do"])
    for name, o, r, v in zip(NAMES, outs, twin, refs):
        assert o.dtype == r.dtype and o.shape == r.shape, name
        if name == "dbo":  # what the core does not reach
            assert torch.equal(o, r), name
        else:
            _close(o, r.float().numpy(), name)
        _close(o, jnp.asarray(v, jnp.float32), f"{name} vs vitax")


def test_k9_on_layer_norm_is_k1_to_the_bit():
    """K9 runs K1's launches after its LN: on x̂ = LN(x) its forward output
    and its backward's weight and bias grads are K1's bits; K1's own
    composition holds its twin (forward to the bit, as
    test_torch_fwd_decomposition.py holds it, backward within 2e-2)."""
    t = _torch(_arrays(273))
    xh = layer_norm_ref(t["x"], t["gamma"], t["beta"], EPS)
    k1 = k1_fwd_composed(t)
    assert torch.equal(k9_fwd_composed(xh, t)[0], k1)
    qkvo = (t["x"], t["gamma"], t["beta"], t["wqkv"], t["bqkv"], t["wo"])
    twin = ck.fused_ln_qkvo_attention_ref(*qkvo, t["bo"], EPS, SEQ, H, HD)
    _close(k1, twin.float().numpy(), "K1 out vs its twin")
    (_, dw, db, dwo, dbo), _, _ = k9_bwd_composed(xh, t)
    k1_grads = k1_bwd_composed(t)
    for name, a, b in zip(("dwqkv", "dbqkv", "dwo", "dbo"),
                          (dw, db, dwo, dbo), k1_grads[3:]):
        assert torch.equal(a, b), name
    k1_twin = ck.fused_ln_qkvo_attention_bwd_ref(*qkvo, t["do"], EPS, SEQ,
                                                 H, HD)
    for i, (a, b) in enumerate(zip(k1_grads, k1_twin)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        _close(a, b.float().numpy(), f"K1 grad {i} vs its twin")


def _body(src, name):
    """The text of the function `name` of a source, up to its closing
    brace at column 0."""
    start = re.search(rf"^\S.* {name}\(", src, re.M).start()
    return src[start:src.index("\n}\n", start)]


_FIRST_DESIGN = ('#include "attention.cuh"', '#include "attention_bwd.cuh"',
                 '#include "gemm.cuh"', "vitax::launch_gemm",
                 "launch_gemm_nt", "launch_gemm_tn",
                 "launch_attention_core_geom", "launch_attention_bwd",
                 "AttnGeom")


@pytest.mark.parametrize("source,entry,call", [
    ("qkvo_attention.cu", "vitax_qkvo_attention_fwd", "vitax::qkvo::fwd("),
    ("qkvo_attention_bwd.cu", "vitax_qkvo_attention_bwd",
     "vitax::qkvo::bwd("),
    ("ln_qkvo_attention.cu", "vitax_ln_qkvo_attention_fwd",
     "vitax::qkvo::fwd("),
    ("ln_qkvo_attention_bwd.cu", "vitax_ln_qkvo_attention_bwd",
     "vitax::qkvo::bwd("),
])
def test_k9_and_k1_run_the_shared_hopper_sequence(source, entry, call):
    """K9's two entry points and K1's (kv_heads == heads) call the one
    sequence of qkvo_sm90.cuh, which launches gemm_sm90.cuh's products,
    K13's core and colsum.cuh's sums only; K9's sources include no
    first-design header, and no entry point takes P or ds."""
    src = (build.CSRC / source).read_text()
    body = _body(src, entry)
    assert call in body
    assert "void* p," not in body and "void* ds," not in body
    if source.startswith("qkvo"):
        for first_design in _FIRST_DESIGN:
            assert first_design not in src, first_design
    shared = (build.CSRC / "qkvo_sm90.cuh").read_text()
    for launch in ("sm90::gemm_nn<sm90::kEpiBias>(",
                   "k13::launch_core_fwd(", "k13::launch_core_bwd(",
                   "sm90::gemm_nt<sm90::kEpiStore>(",
                   "sm90::gemm_nt<sm90::kEpiF32>(", "sm90::gemm_tn(",
                   "launch_colsum("):
        assert launch in shared, launch
    for first_design in _FIRST_DESIGN:
        assert first_design not in shared, first_design
