"""The bf16 K8 (the rect attention half) composed from plain versions in
the order its Hopper entry points launch them on the card
(csrc/ln_qkvo_attention_rect.cu, csrc/ln_qkvo_attention_rect_bwd.cu), on
CPU tensors: K1's launches on K8's two row sets, with K13's core in its
rect geometry (the cpq query rows of xc, xc's zero pad rows [cap, cpq)
included, against the spq key rows of x, keys masked at seq_len).

- The forward: LN of xc and of x, q and kv on `gemm_sm90_ref("nn_bias")`
  over the Q and the KV column slices of Wqkv, K13's core (p from the row
  statistics in exp2, rounded to bf16 once; the head outputs rounded to
  bf16 once), the out-projection on `nn_bias`. Against the twin
  (`fused_ln_qkvo_attention_rect_ref`) and vitax's
  `fused_ln_qkvo_attention_rect` under `jax.jit` in interpret mode within
  2e-2 (K13's p comes from exp2 of the scaled scores, the twin's and
  vitax's from exp); and on the kept rows, K1's forward composed in its
  own launch order on x (qkv on the whole Wqkv, the same core on the
  packed rows) followed by the row gather, to the bit: every launch is per
  row (vitax's contract for this kernel, pallas_kernels.py:3944-3946).
- The backward: the recompute above, dattn (`nt_store`), dWo (`tn_f32`),
  dbo, K13's three passes in the rect geometry (the row pass's m, 1/l, dd;
  the key pass's dk, dv, 0 on the keys >= seq_len; the query pass's dq),
  dxnc and dxn (`nt_f32` through the slices), dWq and dWkv (`tn_f32`),
  dbq, dbkv and the two LN tails, dγ and dβ summed over both row sets.
  Against the twin and vitax's VJP (`_fused_ln_qkvo_rect_bwd`, bf16 tier)
  under `jax.jit` in interpret mode within 2e-2, with do nonzero on xc's
  pad rows (vitax computes those query rows, and their dO enters dk, dv,
  dWq, dWo and dbq).
- A source check that the two entry points launch only the Hopper pieces
  this file composes.

Tiny widths: D 128, 2 heads of 64, spq 16 with seq_len 10, cap 6 in cpq 8,
bf16, 4 images.
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
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402
from vitax_torch.ops.layernorm import layer_norm_ref  # noqa: E402

D, H, HD, SPQ, SEQ, CAP, CPQ, EPS = 128, 2, 64, 16, 10, 6, 8, 1e-5
HHD = H * HD
B = 4
BF = torch.bfloat16
TOL = 2e-2
ARGS = ("xc", "x", "gamma", "beta", "wqkv", "bqkv", "wo")
NAMES = ("dxc", "dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwo", "dbo")
_MATS = ("xc", "x", "do", "wqkv", "wo")


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _arrays(seed):
    """x [B, SPQ, D] (pad rows garbage, as the padded stream may hold), xc:
    CAP of each image's first SEQ rows in random order, zero-padded to CPQ,
    and their indices; do on xc's rows, nonzero on the pad rows too."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = n(B, SPQ, D) * 1.5 + 0.3
    idx = np.stack([rng.permutation(SEQ)[:CAP] for _ in range(B)])
    xc = np.zeros((B, CPQ, D), np.float32)
    xc[:, :CAP] = np.take_along_axis(x, idx[..., None], axis=1)
    return dict(xc=xc, x=x, do=n(B, CPQ, D), gamma=1 + n(D, scale=0.1),
                beta=n(D, scale=0.1), wqkv=n(D, 3 * HHD, scale=D ** -0.5),
                bqkv=n(3 * HHD, scale=0.1), wo=n(HHD, D, scale=HHD ** -0.5),
                bo=n(D, scale=0.1)), idx


def _torch(arrays):
    return {k: torch.from_numpy(v).to(BF if k in _MATS else torch.float32)
            for k, v in arrays.items()}


def _jax(arrays):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in _MATS else jnp.float32)
            for k, v in arrays.items()}


def _recompute(t):
    """The forward's first five launches: xnc, xn, q, kv, the per-head
    q, k, v and the bf16 head outputs o."""
    xnc = layer_norm_ref(t["xc"], t["gamma"], t["beta"], EPS).reshape(-1, D)
    xn = layer_norm_ref(t["x"], t["gamma"], t["beta"], EPS).reshape(-1, D)
    q = ck.gemm_sm90_ref("nn_bias", xnc, t["wqkv"][:, :HHD],
                         t["bqkv"][:HHD])
    kv = ck.gemm_sm90_ref("nn_bias", xn, t["wqkv"][:, HHD:],
                          t["bqkv"][HHD:])
    qh, k, v = ck._rect_heads(q.view(B, CPQ, -1), kv.view(B, SPQ, -1), H)
    o = compose.k13_core_f32(qh, k, v, SEQ).to(BF)
    return xnc, xn, q, kv, qh, k, v, o


def rect_fwd_composed(t):
    """The bf16 K8's forward in its launch order: out [B, CPQ, D]."""
    *_, o = _recompute(t)
    out = ck.gemm_sm90_ref("nn_bias", ck._heads_to_rows(o), t["wo"], t["bo"])
    return out.view(B, CPQ, D)


def k1_fwd_composed(t):
    """K1's forward (ln_qkvo_attention.cu, kv_heads == heads) in its launch
    order on all of x's rows: LN, qkv on the whole Wqkv, K13's core on the
    packed rows (the pad query rows computed), the out-projection."""
    xn = layer_norm_ref(t["x"], t["gamma"], t["beta"], EPS).reshape(-1, D)
    qkv = ck.gemm_sm90_ref("nn_bias", xn, t["wqkv"], t["bqkv"])
    q, k, v = (ck._split_heads(qkv.view(B, SPQ, -1)[..., i * HHD:
                                                    (i + 1) * HHD], H)
               for i in range(3))
    o = compose.k13_core_f32(q, k, v, SEQ).to(BF)
    out = ck.gemm_sm90_ref("nn_bias", ck._heads_to_rows(o), t["wo"], t["bo"])
    return out.view(B, SPQ, D)


def rect_bwd_composed(t):
    """The bf16 K8's backward in its launch order: its eight outputs, and
    the core's dk, dv [B, H, SPQ, HD]."""
    do2 = t["do"].reshape(-1, D)
    xnc, xn, q, kv, qh, k, v, o = _recompute(t)
    attn = ck._heads_to_rows(o)
    dattn = ck.gemm_sm90_ref("nt_store", do2, t["wo"])
    dwo = ck.gemm_sm90_ref("tn_f32", attn, do2)
    dbo = do2.float().sum(dim=0)
    d_o = ck._split_heads(dattn.view(B, CPQ, -1), H)
    dqh, dk, dv = compose.k13_core_grads(qh, k, v, o, d_o, SEQ)
    dq = ck._heads_to_rows(dqh)
    dkv = torch.cat([ck._heads_to_rows(dk), ck._heads_to_rows(dv)], dim=1)
    dxnc = ck.gemm_sm90_ref("nt_f32", dq, t["wqkv"][:, :HHD])
    dxn = ck.gemm_sm90_ref("nt_f32", dkv, t["wqkv"][:, HHD:])
    dwq = ck.gemm_sm90_ref("tn_f32", xnc, dq)
    dwkv = ck.gemm_sm90_ref("tn_f32", xn, dkv)
    xhat_c, rstd_c = ck._ln_stats(t["xc"].reshape(-1, D).float(), EPS)
    xhat_k, rstd_k = ck._ln_stats(t["x"].reshape(-1, D).float(), EPS)
    dxc, dg, dbe = ck._ln_bwd_tail(dxnc, xhat_c, rstd_c, t["gamma"])
    dx, dg2, dbe2 = ck._ln_bwd_tail(dxn, xhat_k, rstd_k, t["gamma"])
    return (dxc.to(BF).view(B, CPQ, D), dx.to(BF).view(B, SPQ, D), dg + dg2,
            dbe + dbe2, torch.cat([dwq, dwkv], dim=1),
            torch.cat([dq.float().sum(dim=0), dkv.float().sum(dim=0)]), dwo,
            dbo), dk, dv


def _close(out, ref, what):
    ref = np.asarray(ref, np.float32)
    out = out.float().numpy().reshape(ref.shape)
    bound = TOL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= bound, f"{what}: max error {err:.3e} > {bound:.3e}"


def test_forward_launch_order_matches_its_twin_and_vitax_under_jit():
    arrays, _ = _arrays(61)
    j, t = _jax(arrays), _torch(arrays)
    out = rect_fwd_composed(t)
    twin = ck.fused_ln_qkvo_attention_rect_ref(*(t[k] for k in ARGS),
                                               t["bo"], EPS, SEQ, H, HD)
    assert out.dtype == BF and out.shape == twin.shape
    _close(out, twin.float().numpy(), "K8 out vs its twin")
    fn = jax.jit(lambda *a: pk.fused_ln_qkvo_attention_rect(
        *a, EPS, SEQ, H, HD))
    ref = fn(*(j[k] for k in ARGS), j["bo"])
    # vitax's pad query rows attend as the port's do; every row is held
    _close(out, jnp.asarray(ref, jnp.float32), "K8 vs vitax")


def test_forward_on_kept_rows_is_k1_then_gather_to_the_bit():
    arrays, idx = _arrays(62)
    t = _torch(arrays)
    out = rect_fwd_composed(t)
    rows = torch.from_numpy(idx)[..., None].expand(-1, -1, D)
    assert torch.equal(out[:, :CAP], torch.gather(k1_fwd_composed(t), 1,
                                                  rows))


def test_backward_launch_order_matches_its_twin_and_vitax_under_jit():
    arrays, _ = _arrays(63)
    j, t = _jax(arrays), _torch(arrays)
    outs, dk, dv = rect_bwd_composed(t)
    # the key pass's masked keys, and xc's pad rows, whose dO is nonzero
    assert not dk[:, :, SEQ:].any() and not dv[:, :, SEQ:].any()
    assert dk[:, :, :SEQ].any() and t["do"][:, CAP:].any()
    assert not outs[1][:, SEQ:].any()  # dx on the masked keys' rows of x
    twin = ck.fused_ln_qkvo_attention_rect_bwd_ref(
        *(t[k] for k in ARGS), t["do"], EPS, SEQ, H, HD)
    fn = jax.jit(functools.partial(pk._fused_ln_qkvo_rect_bwd, EPS, SEQ, H,
                                   HD, False, False, False, False, False))
    refs = fn(tuple(j[k] for k in ARGS), j["do"])
    for name, o, r, v in zip(NAMES, outs, twin, refs):
        assert o.dtype == r.dtype and o.shape == r.shape, name
        if name == "dbo":  # what the core does not reach
            assert torch.equal(o, r), name
        else:
            _close(o, r.float().numpy(), name)
        _close(o, jnp.asarray(v, jnp.float32), f"{name} vs vitax")


def _body(src, name):
    """The text of the function `name` of a source, up to its closing
    brace at column 0."""
    start = re.search(rf"^\S.* {name}\(", src, re.M).start()
    return src[start:src.index("\n}\n", start)]


@pytest.mark.parametrize("source,entry,launches", [
    ("ln_qkvo_attention_rect.cu", "vitax_ln_qkvo_attention_rect_fwd",
     ("launch_layer_norm(", "sm90::gemm_nn<sm90::kEpiBias>(",
      "k13::launch_core_fwd(", "3 * hhd);",
      "a.kv_rows = a.kv_img_rows = spq")),
    ("ln_qkvo_attention_rect_bwd.cu", "vitax_ln_qkvo_attention_rect_bwd",
     ("launch_layer_norm(", "sm90::gemm_nn<sm90::kEpiBias>(",
      "k13::launch_core_fwd(", "k13::launch_core_bwd(",
      "sm90::gemm_nt<sm90::kEpiStore>(", "sm90::gemm_nt<sm90::kEpiF32>(",
      "sm90::gemm_tn(", "launch_colsum(", "launch_layer_norm_bwd_two<",
      "a.kv_rows = a.kv_img_rows = spq")),
])
def test_k8_bf16_sources_launch_the_hopper_pieces_only(source, entry,
                                                       launches):
    """The bf16 entry points launch layernorm.cuh's rows, gemm_sm90.cuh's
    products (the slices of Wqkv by row stride 3·hhd), K13's core in the
    rect geometry and the column sums that this file composes; no gemm.cuh
    product and no whole-row core, forward or backward."""
    from vitax_torch.kernels import build
    body = _body((build.CSRC / source).read_text(), entry)
    for call in launches:
        assert call in body, call
    for first_design in ("vitax::launch_gemm", "launch_gemm_nt",
                         "launch_gemm_tn", "launch_attention_core_geom",
                         "launch_attention_bwd", "AttnGeom"):
        assert first_design not in body, first_design
