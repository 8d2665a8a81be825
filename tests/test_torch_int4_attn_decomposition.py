"""The A4W4 attention half (K11-C and K11-D; G-F and G-B with kv_heads <
heads) composed from plain versions in the order its Hopper entry points
launch them on the card (csrc/ln_qkvo_attention_int8.cu and
ln_qkvo_attention_int8_bwd.cu at L = 7: K3's sequences on the int4 grid),
on CPU tensors:

- the forward: the weights' column codes at L = 7, the LN-quant prologue,
  qkv on `gemm_sm90_s8_ref("s8_bf16")` + bias, K13's core with the fp32
  out on the packed rows (in its GQA geometry where kv_heads < heads), the
  attn's int4 row codes, the out-projection on `s8_bf16` + bias;
- the backward with int8_dw off and on: K3's launch order with every
  quantizer of the recompute and the dx-path at L = 7, K13's three passes
  for the core grads, and under int8_dw both operands of each weight grad
  packed per column over each group (padded to the 128-code K tile) and
  folded by `s8_group_rc` with two scale vectors.

The compositions are held against the twins (`ck.*_int4*_ref`): the
forward's qkv and the backward's dWo and dbo to the bit (what K13's core
does not reach), the rest within 2e-2 (‖Δ‖/‖ref‖, the int4 card checks'
measure); and, with kv_heads < heads, against vitax's
`fused_ln_qkvo_attention(int4=True)` and `_fused_ln_qkvo_bwd` with
int8_grad and int4_grad in interpret mode, within 2e-2 (MHA's twins are
held to vitax in test_torch_int4.py). vitax runs eagerly here, as
test_torch_int4.py runs it: under `jax.jit` XLA folds `amax / 7.0` in
vitax's host weight quantizers into amax·(1/7), a scale up to one ulp
off that moves weight codes a step at ties, so jitted vitax's forward
lies 7.7e-2 to 8.2e-2 (‖Δ‖/‖ref‖) from these compositions and its
backward up to 1.1e-1 (dx), while eager vitax lies within 3.1e-3
(tests/int4_jit_gap.py prints them). The last vitax test shows that in the
forward those two quantizers are the whole of the difference.
`s8_group_rc`'s twin is held to the bit against an int64 numpy sum folded
in vitax's order (pallas_kernels.py:3036-3040: f32(acc)·sat·sdoc, groups
in order).

Tiny widths: D 128, spq 16 with seq_len 10, bf16, b8 (int8_dw groups of
whole images, 64 rows in 128-row tiles); groupings 4 query heads of 32
over 2 kv heads, 3 heads of 64 over 1, and 2 heads of 64 (MHA).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tests import torch_int8_compose as compose  # noqa: E402
from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402
from vitax_torch.ops.quant import int_mm, quant_cols_host4  # noqa: E402

D, SPQ, SEQ, EPS, BATCH = 128, 16, 10, 1e-5, 8
BF = torch.bfloat16
TOL = 2e-2
QKVO = ("x", "gamma", "beta", "wqkv", "bqkv", "wo")
NAMES = ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwo", "dbo")
# (heads, kv_heads, head_dim): groups of two query heads, one group of
# three, and MHA
GQA = [(4, 2, 32), (3, 1, 64)]
GROUPINGS = GQA + [(2, 2, 64)]
_MATS = ("x", "do", "wqkv", "wo")


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _arrays(seed, h, hkv, hd):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    width = (h + 2 * hkv) * hd
    return dict(x=n(BATCH, SPQ, D) * 1.5 + 0.3, do=n(BATCH, SPQ, D),
                gamma=1 + n(D, scale=0.1), beta=n(D, scale=0.1),
                wqkv=n(D, width, scale=D ** -0.5), bqkv=n(width, scale=0.1),
                wo=n(h * hd, D, scale=(h * hd) ** -0.5), bo=n(D, scale=0.1))


def _torch(arrays):
    return {k: torch.from_numpy(v).to(BF if k in _MATS else torch.float32)
            for k, v in arrays.items()}


def _jax(arrays):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in _MATS else jnp.float32)
            for k, v in arrays.items()}


def _close(out, ref, what):
    """‖out − ref‖/‖ref‖ <= TOL, the int4 card checks' measure
    (chip_smoke.py's INT4_REL): a code moved one int4 step on a .5 tie moves
    its element by 1/7 of its row's largest value, past any per-element
    band."""
    ref = np.asarray(ref, np.float32)
    out = out.float().numpy().reshape(ref.shape)
    err = float(np.linalg.norm(out - ref) / max(np.linalg.norm(ref), 1e-30))
    assert err <= TOL, f"{what}: ‖Δ‖/‖ref‖ {err:.3e} > {TOL}"


def int4_fwd_composed(t, h, hkv, hd):
    """K11-C's (G-F's) forward in its launch order: (out, qkv)."""
    return compose.k3_fwd_composed(t, SEQ, h, hd, EPS, hkv, int4=True)


def int4_bwd_composed(t, h, hkv, hd, int8_dw):
    """K11-D's (G-B's) backward in its launch order: ((dx, dγ, dβ, dWqkv,
    dbqkv, dWo, dbo), dqkv)."""
    return compose.qkvo_int8_bwd_composed(t, SEQ, h, hd, EPS, int8_dw,
                                          ck.qkvo_dw_group(BATCH, SPQ), hkv,
                                          int4=True)


@pytest.mark.parametrize("h,hkv,hd", GROUPINGS)
def test_forward_launch_order_matches_its_twin(h, hkv, hd):
    t = _torch(_arrays(51, h, hkv, hd))
    out, qkv = int4_fwd_composed(t, h, hkv, hd)
    twin = ck.fused_ln_qkvo_attention_int4_ref(
        *(t[k] for k in QKVO), t["bo"], EPS, SEQ, h, hd, hkv)
    assert out.dtype == BF and out.shape == twin.shape
    _close(out, twin.float().numpy(), "out vs its twin")
    # qkv as the twin forms it, from the int4 codes: the bits
    w8, sw = quant_cols_host4(t["wqkv"])
    xq, sx = compose.ln_quant(t["x"].reshape(-1, D), t["gamma"], t["beta"],
                              EPS, int4=True)
    assert int(xq.abs().max()) <= 7
    assert torch.equal(qkv, ck._dequant(int_mm(xq, w8), sx, sw,
                                        t["bqkv"]).to(BF))


@pytest.mark.parametrize("h,hkv,hd", GQA)
def test_forward_launch_order_matches_vitax(h, hkv, hd):
    arrays = _arrays(52, h, hkv, hd)
    j = _jax(arrays)
    ref = pk.fused_ln_qkvo_attention(*(j[k] for k in QKVO + ("bo",)), EPS,
                                     SEQ, h, hd, int8=True, int4=True,
                                     kv_heads=hkv)
    out, _ = int4_fwd_composed(_torch(arrays), h, hkv, hd)
    _close(out, jnp.asarray(ref, jnp.float32), "out vs vitax")


@pytest.mark.parametrize("int8_dw", [False, True])
@pytest.mark.parametrize("h,hkv,hd", GROUPINGS)
def test_backward_launch_order_equals_the_twins(h, hkv, hd, int8_dw):
    t = _torch(_arrays(53, h, hkv, hd))
    out, dqkv = int4_bwd_composed(t, h, hkv, hd, int8_dw)
    twin = (ck.fused_ln_qkvo_attention_int4_dw_bwd_ref if int8_dw
            else ck.fused_ln_qkvo_attention_int4_bwd_ref)(
        *(t[k] for k in QKVO), t["do"], EPS, SEQ, h, hd, hkv)
    for name, o, r in zip(NAMES, out, twin):
        assert o.dtype == r.dtype and o.shape == r.shape, name
        if name in ("dwo", "dbo"):  # what the core grads do not reach
            assert torch.equal(o, r), name
        else:
            _close(o, r.float().numpy(), name)
    # the key pass writes dk and dv as 0 on the key rows past seq_len
    kv = dqkv.view(BATCH, SPQ, -1)[:, :, h * hd:]
    assert kv.shape[-1] == 2 * hkv * hd
    assert kv[:, SEQ:].abs().max().item() == 0
    assert kv[:, :SEQ].abs().max().item() > 0


@pytest.mark.parametrize("int8_dw", [False, True])
@pytest.mark.parametrize("h,hkv,hd", GQA)
def test_backward_launch_order_matches_vitax(h, hkv, hd, int8_dw):
    arrays = _arrays(54, h, hkv, hd)
    j = _jax(arrays)
    # int8, int8_grad, int8_dw, int4, int4_grad, kv_heads
    refs = pk._fused_ln_qkvo_bwd(EPS, SEQ, h, hd, True, True, int8_dw, True,
                                 True, hkv, tuple(j[k] for k in QKVO),
                                 j["do"])
    out, _ = int4_bwd_composed(_torch(arrays), h, hkv, hd, int8_dw)
    for name, o, r in zip(NAMES, out, refs):
        _close(o, jnp.asarray(r, jnp.float32), f"{name} vs vitax")


def test_vitax_under_jit_moves_only_its_weight_codes(monkeypatch):
    """Jitted vitax is, to the bit, eager vitax with its two host weight
    quantizers (_quant_cols_host4, _quant_rows_host4) jitted: nothing but
    their scales' amax·(1/7) separates the vitax forward the tests above
    hold the compositions to from the one a jitted step runs."""
    h, hkv, hd = GQA[1]
    j = _jax(_arrays(52, h, hkv, hd))
    args = tuple(j[k] for k in QKVO + ("bo",))

    def forward(*a):
        return pk.fused_ln_qkvo_attention(*a, EPS, SEQ, h, hd, int8=True,
                                          int4=True, kv_heads=hkv)

    jitted = jax.jit(forward)(*args)
    for name in ("_quant_cols_host4", "_quant_rows_host4"):
        monkeypatch.setattr(pk, name, jax.jit(getattr(pk, name)))
    assert bool(jnp.array_equal(forward(*args), jitted))


def test_two_scale_group_fold_is_vitax_order_to_the_bit():
    """`s8_group_rc`'s twin (gemm_sm90.cuh's kEpiS8GroupRC, gemm.cuh's
    kS8GroupF32RC) is, to the bit, an exact int64 product of each group's
    codes folded as vitax folds dwo_part: F += (f32(acc)·sa[z])·sb[z] in
    fp32, groups in order; the pad rows of a group add nothing; and the
    wrapper on CPU tensors is the twin."""
    m, n, gp = 40, 24, 256
    inputs = ck.gemm_sm90_s8_inputs("s8_group_rc", m, n, 3 * gp, gp, seed=7,
                                    device="cpu")
    out = ck.gemm_sm90_s8_ref("s8_group_rc", **inputs)
    a, b = inputs["a"].numpy(), inputs["b"].numpy()
    sa, sb = inputs["sr"].numpy(), inputs["sc"].numpy()
    ref = np.zeros((m, n), np.float32)
    for z in range(3):
        cols = slice(z * gp, (z + 1) * gp)
        acc = a[:, cols].astype(np.int64) @ b[:, cols].astype(np.int64).T
        part = acc.astype(np.float32) * sa[z][:, None] * sb[z][None, :]
        ref = ref + part
    assert ref.dtype == np.float32 and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    assert torch.equal(ck.gemm_sm90_s8("s8_group_rc", **inputs), out)
    # the same codes without their pad rows (25/32 of each group's rows
    # are codes): the same bits
    rows = gp * 25 // 32
    keep = torch.cat([torch.arange(z * gp, z * gp + rows) for z in range(3)])
    cut = dict(inputs, a=inputs["a"][:, keep].contiguous(),
               b=inputs["b"][:, keep].contiguous(), group=rows)
    assert torch.equal(ck.gemm_sm90_s8_ref("s8_group_rc", **cut), out)
