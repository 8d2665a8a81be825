"""The two int4_grad backwards composed from plain versions in the order
their Hopper entry points launch them on the card, on CPU tensors:

- K11-B (csrc/ln_mlp_int8_bwd.cu at L = 7: K4's sequence on the int4 grid)
  with int8_dw off and on and with and without the residual: the weights'
  codes, the LN-quant recompute from the bf16 xn, do's codes, the dual
  product (`s8_gelu_pair`), db2, db1, dh1_32's codes, dW2 and dW1
  (`tn_f32`, or under int8_dw the column packs of h1 | do and xn | dh1_32
  over vitax's groups, each padded to the 128-code K tile, folded by
  `s8_group_rc`), dxn (`s8_f32`) and the LN tail;
- R-B (csrc/ln_qkvo_attention_rect_int8_bwd.cu at L = 7: K8's int8
  sequence on the int4 grid) with int8_dw off and on: K8's launches with
  every code of the recompute and the dx-path at L = 7, K13's three passes
  in the rect geometry, and under int8_dw the column packs of attn | do,
  xnc32 | dq and xn32 | dkv folded by `s8_group_rc`.

The compositions are held against the twins (`ck.*_int4*_bwd_ref`): K11-B
to the bit on every output (K4's design keeps the twin's arithmetic, and
the zero-padded integer sums are exact), R-B to the bit on dbo and within
2e-2 (‖Δ‖/‖ref‖, the int4 card checks' measure) where K13's core reaches;
then against vitax's `_ln_mlp_bwd_int4_call` and `_fused_ln_qkvo_rect_bwd`
with int8_grad and int4_grad, run eagerly in interpret mode, within 2e-2
(under `jax.jit` vitax moves its int4 weight codes at ties:
test_torch_int4_attn_decomposition.py). And a source check that K4's and
K11-B's entry points reach only the Hopper pieces composed here.

Tiny widths: D 128, M 256, bf16. K11-B on 3 images of 20 rows: 60 rows,
vitax's int8_dw group 32, so the rows are padded with 4 zero rows whose h1
and xn enter the last group's column scales. R-B at 2 heads of 64, spq 16
with seq_len 10, cap 6 in cpq 8, 8 images (int8_dw groups of 4 images: 32
rows of xc, 64 of x).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tests import torch_int8_compose as compose  # noqa: E402
from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402

D, M, H, HD, SPQ, SEQ, CAP, CPQ, EPS = 128, 256, 2, 64, 16, 10, 6, 8, 1e-5
HHD = H * HD
MLP_SHAPE, RECT_B = (3, 20), 8
BF = torch.bfloat16
TOL = 2e-2
MLP = ("x", "gamma", "beta", "w1", "b1", "w2")
RECT = ("xc", "x", "gamma", "beta", "wqkv", "bqkv", "wo")
MLP_NAMES = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
RECT_NAMES = ("dxc", "dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwo", "dbo")
_MATS = ("xc", "x", "do", "wqkv", "wo", "w1", "w2")
# (int8_dw, residual): K11-B's four branches
MLP_CASES = [(False, True), (True, True), (False, False), (True, False)]


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _mlp_arrays(seed):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(x=n(*MLP_SHAPE, D) * 1.5 + 0.3, do=n(*MLP_SHAPE, D),
                gamma=1 + n(D, scale=0.1), beta=n(D, scale=0.1),
                w1=n(D, M, scale=D ** -0.5), b1=n(M, scale=0.1),
                w2=n(M, D, scale=M ** -0.5))


def _rect_arrays(seed):
    """x [B, SPQ, D], xc: CAP of each image's first SEQ rows in random
    order, zero-padded to CPQ; do on xc's rows, nonzero on the pad rows
    too."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = n(RECT_B, SPQ, D) * 1.5 + 0.3
    idx = np.stack([rng.permutation(SEQ)[:CAP] for _ in range(RECT_B)])
    xc = np.zeros((RECT_B, CPQ, D), np.float32)
    xc[:, :CAP] = np.take_along_axis(x, idx[..., None], axis=1)
    return dict(xc=xc, x=x, do=n(RECT_B, CPQ, D), gamma=1 + n(D, scale=0.1),
                beta=n(D, scale=0.1), wqkv=n(D, 3 * HHD, scale=D ** -0.5),
                bqkv=n(3 * HHD, scale=0.1), wo=n(HHD, D, scale=HHD ** -0.5))


def _torch(arrays):
    return {k: torch.from_numpy(v).to(BF if k in _MATS else torch.float32)
            for k, v in arrays.items()}


def _jax(arrays):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in _MATS else jnp.float32)
            for k, v in arrays.items()}


def _close(out, ref, what):
    """‖out − ref‖/‖ref‖ <= TOL (chip_smoke.py's INT4_REL)."""
    ref = np.asarray(ref, np.float32)
    out = out.float().numpy().reshape(ref.shape)
    err = float(np.linalg.norm(out - ref) / max(np.linalg.norm(ref), 1e-30))
    assert err <= TOL, f"{what}: ‖Δ‖/‖ref‖ {err:.3e} > {TOL}"


def k11b_composed(t, int8_dw, residual):
    """K11-B in its launch order: the rows padded with zero rows to whole
    groups of vitax's (`mlp_int4_dw_group`) under int8_dw, as the wrapper
    pads them, and dx cut back to the rows given."""
    x2, do2 = t["x"].reshape(-1, D), t["do"].reshape(-1, D)
    group = ck.mlp_int4_dw_group(x2.shape[0])
    if int8_dw:
        t = dict(t, x=ck._pad_rows(x2, group), do=ck._pad_rows(do2, group))
    dx, *grads = compose.mlp_int8_bwd_composed(t, EPS, int8_dw, group,
                                               residual, int4=True)
    return (dx.reshape(-1, D)[:x2.shape[0]].reshape(MLP_SHAPE + (D,)),
            *grads)


@pytest.mark.parametrize("int8_dw,residual", MLP_CASES)
def test_k11b_launch_order_equals_its_twin(int8_dw, residual):
    t = _torch(_mlp_arrays(61))
    out = k11b_composed(t, int8_dw, residual)
    twin = ck.fused_ln_mlp_int4_bwd_ref(*(t[k] for k in MLP), t["do"], EPS,
                                        int8_dw=int8_dw, residual=residual)
    if int8_dw:  # 60 rows in two groups of 32, the last with 4 pad rows
        assert ck.mlp_int4_dw_group(60) == 32
    for name, o, r in zip(MLP_NAMES, out, twin):
        assert o.dtype == r.dtype and o.shape == r.shape, name
        assert torch.equal(o, r), name


@pytest.mark.parametrize("int8_dw,residual", MLP_CASES)
def test_k11b_launch_order_matches_vitax(int8_dw, residual):
    arrays = _mlp_arrays(62)
    j = _jax(arrays)
    n = MLP_SHAPE[0] * MLP_SHAPE[1]
    npad = pk._ln_mlp_pad(n, int8=True)

    def pad(a):
        return jnp.pad(a.reshape(n, D), ((0, npad - n), (0, 0)))

    refs = pk._ln_mlp_bwd_int4_call(pad(j["x"]), j["gamma"], j["beta"],
                                    j["w1"], j["b1"], j["w2"], pad(j["do"]),
                                    EPS, residual, int8_dw=int8_dw)
    refs = (refs[0][:n], *refs[1:])
    out = k11b_composed(_torch(arrays), int8_dw, residual)
    for name, o, r in zip(MLP_NAMES, out, refs):
        _close(o, jnp.asarray(r, jnp.float32), f"{name} vs vitax")


@pytest.mark.parametrize("int8_dw", [False, True])
def test_rb_launch_order_matches_its_twin(int8_dw):
    t = _torch(_rect_arrays(63))
    outs, dk, dv = compose.rect_int8_bwd_composed(t, SEQ, H, HD, EPS, int8_dw,
                                                  int4=True)
    # the key pass's masked keys, and xc's pad rows, whose dO is nonzero
    assert not dk[:, :, SEQ:].any() and not dv[:, :, SEQ:].any()
    assert dk[:, :, :SEQ].any() and t["do"][:, CAP:].any()
    twin = (ck.fused_ln_qkvo_attention_rect_int4_dw_bwd_ref if int8_dw
            else ck.fused_ln_qkvo_attention_rect_int4_bwd_ref)(
        *(t[k] for k in RECT), t["do"], EPS, SEQ, H, HD)
    for name, o, r in zip(RECT_NAMES, outs, twin):
        assert o.dtype == r.dtype and o.shape == r.shape, name
        if name == "dbo":  # what K13's core does not reach
            assert torch.equal(o, r), name
        else:
            _close(o, r.float().numpy(), name)


@pytest.mark.parametrize("int8_dw", [False, True])
def test_rb_launch_order_matches_vitax(int8_dw):
    arrays = _rect_arrays(64)
    j = _jax(arrays)
    # int8, int8_grad, int8_dw, int4, int4_grad
    refs = pk._fused_ln_qkvo_rect_bwd(EPS, SEQ, H, HD, True, True, int8_dw,
                                      True, True, tuple(j[k] for k in RECT),
                                      j["do"])
    outs, _, _ = compose.rect_int8_bwd_composed(_torch(arrays), SEQ, H, HD,
                                                EPS, int8_dw, int4=True)
    for name, o, r in zip(RECT_NAMES, outs, refs):
        _close(o, jnp.asarray(r, jnp.float32), f"{name} vs vitax")


# the launches of the MLP backward's Hopper body at either grid
_MLP_BWD = ("launch_quant_weight_rows<L>(", "launch_quant_weight_cols_t<L>(",
            "launch_layer_norm_quant<true, false, L>(",
            "launch_quant_rows<L>(", "sm90::gemm_s8_gelu_pair(",
            "sm90::gemm_tn(", "sm90::gemm_s8<sm90::kEpiS8F32>(",
            "launch_colsum(", "launch_layer_norm_bwd<", "launch_dw_int8_operands(",
            "sm90::gemm_s8_groups(", "launch_dw_cols_operands(",
            "sm90::gemm_s8_groups_rc(")


@pytest.mark.parametrize("entry", ["vitax_ln_mlp_int8_bwd",
                                   "vitax_ln_mlp_int4_bwd"])
def test_mlp_bwd_sources_launch_the_hopper_pieces_only(entry):
    """K4's entry point and K11-B's call the Hopper body templated on the
    grid's limit alone, which launches quant.cuh's and layernorm.cuh's row
    passes, gemm_sm90.cuh's dual product, s8 products and kTN, dw_int8.cuh's
    packs (of the row-scale folds, and of both operands' columns), the
    group folds and the column sums that this file composes; no gemm.cuh
    product and no a1 in device memory."""
    compose.check_hopper_body("ln_mlp_int8_bwd.cu", "ln_mlp_quant_bwd_sm90",
                              entry, _MLP_BWD)
