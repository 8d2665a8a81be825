"""K8's int8 tier (the rect attention half, W8A8) composed from plain
versions in the order its Hopper entry points launch them on the card
(csrc/ln_qkvo_attention_rect_int8.cu, csrc/ln_qkvo_attention_rect_int8_bwd.cu
at L = 127), on CPU tensors: K3's launches on K8's two row sets, with
K13's core in its rect geometry (the cpq query rows of xc, xc's zero pad
rows [cap, cpq) included, against the spq key rows of x, keys masked at
seq_len).

- The forward: the weights' column codes (Wqkv whole), the LN-quant of xc
  and of x, q and kv on `gemm_sm90_s8_ref("s8_bf16")` over the Q and the
  KV rows of the codes, K13's core with the fp32 out, the attn's row codes,
  the out-projection on `s8_bf16`. Against the twin: q and kv (and the
  codes) to the bit, out within 2e-2 (K13's p comes from the row
  statistics in exp2, the twin's from its softmax); against vitax's
  `fused_ln_qkvo_attention_rect(int8=True)` under `jax.jit` in interpret
  mode within 2e-2; and on the kept rows, K3's composition
  (tests/torch_int8_compose.py) on x followed by the row gather, to the
  bit: vitax's contract for this kernel (pallas_kernels.py:4418-4419).
- The backward, `int8_dw` off and on: the weights' codes, the LN-quant
  recompute, q and kv, K13's forward (attn bf16), do's codes, dattn
  (`s8_bf16`), dWo (`tn_f32`, or the group fold over group_c rows), dbo,
  K13's three passes in the rect geometry, dq's and dkv's codes, dxnc and
  dxn (`s8_f32`), dWq and dWkv (`tn_f32`, or the folds over group_c and
  group_k rows), dbq, dbkv and the two LN tails. Against the twin and
  vitax's VJP (`_fused_ln_qkvo_rect_bwd`, int8 and int8_grad) under
  `jax.jit` in interpret mode, within 2e-2; with do nonzero on xc's pad
  rows, and dk = dv = 0 on the keys >= seq_len.
- A source check that the L = 127 entry points, and R-B's at L = 7, reach
  only the Hopper pieces this file composes.

Tiny widths: D 128, 2 heads of 64, spq 16 with seq_len 10, cap 6 in cpq 8,
bf16, 8 images (int8_dw groups of 4 images: 32 rows of xc, 64 of x, each
padded to one 128-code K tile).
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tests import torch_int8_compose as compose  # noqa: E402
from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402
from vitax_torch.ops.quant import (int_mm, quant_cols_host,  # noqa: E402
                                   quant_rows)

D, H, HD, SPQ, SEQ, CAP, CPQ, EPS = 128, 2, 64, 16, 10, 6, 8, 1e-5
HHD = H * HD
B = 8
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


def _q_kv(t, xqc, sxc, xq, sx):
    """q and kv on the s8 path over the Q and the KV rows of Wqkv's codes."""
    w8, sw = quant_cols_host(t["wqkv"])
    w8t = w8.t().contiguous()  # stored [3·HHD, D]
    q = ck.gemm_sm90_s8_ref("s8_bf16", xqc, w8t[:HHD], sxc, sw[:HHD],
                            t["bqkv"][:HHD])
    kv = ck.gemm_sm90_s8_ref("s8_bf16", xq, w8t[HHD:], sx, sw[HHD:],
                             t["bqkv"][HHD:])
    return q, kv


def rect_fwd_composed(t):
    """K8's int8 forward in its launch order: (out, q, kv, xqc, xq)."""
    wo8, swo = quant_cols_host(t["wo"])
    xqc, sxc = compose.ln_quant(t["xc"].reshape(-1, D), t["gamma"],
                                t["beta"], EPS)
    xq, sx = compose.ln_quant(t["x"].reshape(-1, D), t["gamma"], t["beta"],
                              EPS)
    q, kv = _q_kv(t, xqc, sxc, xq, sx)
    heads = ck._rect_heads(q.view(B, CPQ, -1), kv.view(B, SPQ, -1), H)
    aq, sa = quant_rows(ck._heads_to_rows(compose.k13_core_f32(*heads, SEQ)))
    out = ck.gemm_sm90_s8_ref("s8_bf16", aq, wo8.t().contiguous(), sa, swo,
                              t["bo"])
    return out.view(B, CPQ, D), q, kv, xqc, xq


def rect_bwd_composed(t, int8_dw):
    """K8's int8 backward in its launch order: its eight outputs, and the
    core's dk, dv [B, H, SPQ, HD]."""
    return compose.rect_int8_bwd_composed(t, SEQ, H, HD, EPS, int8_dw)


def _close(out, ref, what):
    ref = np.asarray(ref, np.float32)
    out = out.float().numpy().reshape(ref.shape)
    bound = TOL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= bound, f"{what}: max error {err:.3e} > {bound:.3e}"


def _fwd_args(t):
    return (*(t[k] for k in ARGS), t["bo"], EPS, SEQ, H, HD)


def test_forward_launch_order_matches_its_twin():
    arrays, _ = _arrays(51)
    t = _torch(arrays)
    out, q, kv, xqc, xq = rect_fwd_composed(t)
    st = {}
    twin = ck.fused_ln_qkvo_attention_rect_int8_ref(*_fwd_args(t),
                                                    scratch=st)
    assert out.dtype == BF and out.shape == twin.shape
    _close(out, twin.float().numpy(), "K8 int8 out vs its twin")
    # the codes, and q and kv as the twin forms them (:4091-4100): the bits
    (xqc_t, sxc_t), (xq_t, sx_t) = st["xq"], st["xqk"]
    assert torch.equal(xqc, xqc_t) and torch.equal(xq, xq_t)
    w8, sw = st["w8"]
    assert torch.equal(q, ck._dequant(int_mm(xqc_t, w8[:, :HHD]),
                                      sxc_t.reshape(-1, 1), sw[:HHD],
                                      t["bqkv"][:HHD]).to(BF))
    assert torch.equal(kv, ck._dequant(int_mm(xq_t, w8[:, HHD:]),
                                       sx_t.reshape(-1, 1), sw[HHD:],
                                       t["bqkv"][HHD:]).to(BF))


def test_forward_launch_order_matches_vitax_under_jit():
    arrays, _ = _arrays(52)
    j, t = _jax(arrays), _torch(arrays)
    fn = jax.jit(lambda *a: pk.fused_ln_qkvo_attention_rect(
        *a, EPS, SEQ, H, HD, int8=True))
    ref = fn(*(j[k] for k in ARGS), j["bo"])
    # vitax's pad query rows attend as the port's do; every row is held
    _close(rect_fwd_composed(t)[0], jnp.asarray(ref, jnp.float32),
           "K8 int8 vs vitax")


def test_forward_on_kept_rows_is_k3_then_gather_to_the_bit():
    arrays, idx = _arrays(53)
    t = _torch(arrays)
    out = rect_fwd_composed(t)[0]
    square, _ = compose.k3_fwd_composed(t, SEQ, H, HD, EPS)
    rows = torch.from_numpy(idx)[..., None].expand(-1, -1, D)
    assert torch.equal(out[:, :CAP], torch.gather(square, 1, rows))


@pytest.mark.parametrize("int8_dw", [False, True])
def test_backward_launch_order_matches_its_twin(int8_dw):
    arrays, _ = _arrays(54)
    t = _torch(arrays)
    (outs, dk, dv) = rect_bwd_composed(t, int8_dw)
    # the key pass's masked keys, and xc's pad rows, whose dO is nonzero
    assert not dk[:, :, SEQ:].any() and not dv[:, :, SEQ:].any()
    assert dk[:, :, :SEQ].any() and t["do"][:, CAP:].any()
    twin = ck.fused_ln_qkvo_attention_rect_int8_bwd_ref(
        *(t[k] for k in ARGS), t["do"], EPS, SEQ, H, HD, int8_dw=int8_dw)
    for name, o, r in zip(NAMES, outs, twin):
        assert o.dtype == r.dtype and o.shape == r.shape, name
        if name == "dbo":  # what the core grads do not reach
            assert torch.equal(o, r), name
        else:
            _close(o, r.float().numpy(), name)


@pytest.mark.parametrize("int8_dw", [False, True])
def test_backward_launch_order_matches_vitax_under_jit(int8_dw):
    arrays, _ = _arrays(55)
    j, t = _jax(arrays), _torch(arrays)
    fn = jax.jit(functools.partial(pk._fused_ln_qkvo_rect_bwd, EPS, SEQ, H,
                                   HD, True, True, int8_dw, False, False))
    refs = fn(tuple(j[k] for k in ARGS), j["do"])
    outs, _, _ = rect_bwd_composed(t, int8_dw)
    for name, o, r in zip(NAMES, outs, refs):
        _close(o, jnp.asarray(r, jnp.float32), f"{name} vs vitax")


# the launches of the rect backward's Hopper body at either grid, and what
# its int8_dw adds at each: the row-scale folds (L = 127), the column packs
# of both operands and the two-scale fold (L = 7)
_RECT_BWD = ("launch_quant_weight_cols_t<L>(", "launch_quant_weight_rows<L>(",
             "launch_layer_norm_quant<false, true, L>(",
             "launch_layer_norm_quant<false, false, L>(",
             "sm90::gemm_s8<sm90::kEpiS8Bf16>(",
             "sm90::gemm_s8<sm90::kEpiS8F32>(", "k13::launch_core_fwd(",
             "k13::launch_core_bwd(", "sm90::gemm_tn(", "launch_quant_rows<L>(",
             "launch_colsum(", "launch_layer_norm_bwd_two<",
             "a.kv_rows = a.kv_img_rows = spq")


@pytest.mark.parametrize("source,hopper,entry,launches", [
    ("ln_qkvo_attention_rect_int8.cu", "ln_qkvo_attention_rect_int8_fwd_sm90",
     "vitax_ln_qkvo_attention_rect_int8_fwd",
     ("launch_quant_weight_cols_t(", "launch_layer_norm_quant<false, false>(",
      "sm90::gemm_s8<sm90::kEpiS8Bf16>(",
      "k13::launch_core_rows<vitax::k13::kRowsFwdF32>(",
      "launch_quant_rows(", "a.kv_rows = a.kv_img_rows = spq")),
    ("ln_qkvo_attention_rect_int8_bwd.cu",
     "ln_qkvo_attention_rect_quant_bwd_sm90",
     "vitax_ln_qkvo_attention_rect_int8_bwd",
     _RECT_BWD + ("launch_dw_int8_operands(", "sm90::gemm_s8_groups(")),
    ("ln_qkvo_attention_rect_int8_bwd.cu",
     "ln_qkvo_attention_rect_quant_bwd_sm90",
     "vitax_ln_qkvo_attention_rect_int4_bwd",
     _RECT_BWD + ("launch_dw_cols_operands(", "sm90::gemm_s8_groups_rc(")),
])
def test_k8_int8_sources_launch_the_hopper_pieces_only(source, hopper, entry,
                                                       launches):
    """The L = 127 entry points, and R-B's at L = 7, call their Hopper
    function alone, which launches gemm_sm90.cuh's s8 products (and kTN
    for the bf16 weight grads), K13's core in the rect geometry, quant.cuh's
    and layernorm.cuh's row passes, dw_int8.cuh's operand packs and the
    column sums that this file composes; no gemm.cuh product (s8, kTN, the
    group fold) and no whole-row core. R-F keeps the first design in its
    own function."""
    compose.check_hopper_body(source, hopper, entry, launches)
