"""K7's int8 backward (kv_heads < heads) composed from plain versions in the
order its Hopper entry point launches them on the card
(csrc/ln_qkvo_attention_int8_bwd.cu, K3's sequence at the packed GQA width
(H + 2·Hkv)·Hd), on CPU tensors: the weights' codes, the LN-quant
recompute, qkv on `gemm_sm90_s8_ref("s8_bf16")` + bias, the core on the
packed rows (query head h reads k, v of group h·Hkv/H; its forward as the
twin's, its grads as K13's three passes run them in the GQA geometry: the
key pass's dK and dV one fp32 sum over a group's query heads, scaled and
cast once), do's codes, dattn (`s8_bf16`), dWo (`gemm_sm90_ref("tn_f32")`,
or under int8_dw the group fold on 128-row tiles), dbo, dqkv's codes, dxn
(`s8_f32`), dW, dbqkv and the LN tail, with int8_dw off and on.

The composition is held against the twins
(`fused_ln_qkvo_attention_int8_gqa{,_dw}_bwd_ref`): dWo and dbo to the bit
(the core grads do not reach them), the rest within the bf16 tolerance
2e-2; and against vitax's `_fused_ln_qkvo_bwd` with `kv_heads` under
`jax.jit` in interpret mode, within 2e-2. dk and dv are exactly 0 on the
key rows past seq_len.

Tiny widths: D 128, spq 16 with seq_len 10, bf16, b8 (int8_dw groups of 4
images, 64 rows in 128-row tiles); two groupings, 4 query heads of 32 over
2 kv heads and 3 heads of 64 over 1.
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

D, SPQ, SEQ, EPS, BATCH = 128, 16, 10, 1e-5, 8
BF = torch.bfloat16
TOL = 2e-2
QKVO = ("x", "gamma", "beta", "wqkv", "bqkv", "wo")
NAMES = ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwo", "dbo")
# (heads, kv_heads, head_dim): groups of two query heads, and one group of
# three
GROUPINGS = [(4, 2, 32), (3, 1, 64)]
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
                wo=n(h * hd, D, scale=(h * hd) ** -0.5))


def _torch(arrays):
    return {k: torch.from_numpy(v).to(BF if k in _MATS else torch.float32)
            for k, v in arrays.items()}


def k7_bwd_composed(t, h, hkv, hd, int8_dw, group):
    """K7's int8 backward in its launch order: ((dx, dγ, dβ, dWqkv, dbqkv,
    dWo, dbo), dqkv)."""
    return compose.qkvo_int8_bwd_composed(t, SEQ, h, hd, EPS, int8_dw, group,
                                          hkv)


def _close(out, ref, what):
    ref = np.asarray(ref, np.float32)
    out = out.float().numpy().reshape(ref.shape)
    bound = TOL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= bound, f"{what}: max error {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("int8_dw", [False, True])
@pytest.mark.parametrize("h,hkv,hd", GROUPINGS)
def test_launch_order_equals_the_twins(h, hkv, hd, int8_dw):
    t = _torch(_arrays(41, h, hkv, hd))
    group = ck.qkvo_dw_group(BATCH, SPQ)
    out, dqkv = k7_bwd_composed(t, h, hkv, hd, int8_dw, group)
    twin = (ck.fused_ln_qkvo_attention_int8_gqa_dw_bwd_ref if int8_dw
            else ck.fused_ln_qkvo_attention_int8_gqa_bwd_ref)(
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
@pytest.mark.parametrize("h,hkv,hd", GROUPINGS)
def test_launch_order_matches_vitax_under_jit(h, hkv, hd, int8_dw):
    arrays = _arrays(43, h, hkv, hd)
    j = {k: jnp.asarray(v, jnp.bfloat16 if k in _MATS else jnp.float32)
         for k, v in arrays.items()}
    fn = jax.jit(functools.partial(pk._fused_ln_qkvo_bwd, EPS, SEQ, h, hd,
                                   True, True, int8_dw, False, False, hkv))
    refs = fn(tuple(j[k] for k in QKVO), j["do"])
    out, _ = k7_bwd_composed(_torch(arrays), h, hkv, hd, int8_dw,
                             ck.qkvo_dw_group(BATCH, SPQ))
    for name, o, r in zip(NAMES, out, refs):
        _close(o, jnp.asarray(r, jnp.float32), f"{name} vs vitax")


def test_mha_core_grads_keep_their_arithmetic():
    """`kv_heads` equal to the heads (or None) leaves the core grads of the
    square geometry as they are, to the bit (K3's decomposition reads
    them)."""
    g = torch.Generator().manual_seed(5)
    q, k, v, d_o = (torch.randn((2, 3, SPQ, 32), generator=g).to(BF)
                    for _ in range(4))
    o = compose.k13_core_f32(q, k, v, SEQ).to(BF)
    plain = compose.k13_core_grads(q, k, v, o, d_o, SEQ)
    for a, b in zip(plain, compose.k13_core_grads(q, k, v, o, d_o, SEQ,
                                                  kv_heads=3)):
        assert torch.equal(a, b)
