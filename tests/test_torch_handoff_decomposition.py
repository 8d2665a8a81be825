"""K5's two halves (the int8 block handoff) composed from plain versions in
the order their Hopper entry points launch them on the card
(csrc/ln_qkvo_attention_int8_ho.cu, csrc/ln_mlp_int8_ho.cu), on CPU
tensors:

- the attention half: the weights' column codes, with the first block's
  pack the LN-quant of x (`pack_rows`), qkv on `gemm_sm90_s8_ref("s8_bf16")`
  + bias, K13's forward core on the packed rows with the fp32 out (keys
  masked at seq_len, the pad query rows computed; p = exp2(s·scale·log2e −
  m)·(1/l) rounded to bf16 once, p·v in fp32), the attn's row codes, the
  out-projection on `s8_residual_f32` (x added in fp32, rounded once), then
  the LN2-quant of the bf16 r1 (`pack_rows`);
- the MLP half: the weights' column codes, fc1 on `s8_gelu_q_f32`, its row
  codes, fc2 on `s8_residual_f32` (r1 added in fp32), then the next block's
  LN1-quant of the bf16 r2.

The compositions are held against the twins (the plain versions the card
holds the kernels against): the MLP half's r2, xqn and sxn, and the
attention half's qkv, to the bit (exact integer products, the same
dequantizing order, the same pack); the attention half's r1 within the
bf16 tolerance 2e-2 (K13's p comes from the row statistics in exp2, the
twin's from its softmax). Then against vitax's `_qkvo_ho_fwd_call` and
`_mlp_ho_fwd_call` under `jax.jit` in interpret mode, within the int8
tiers' CPU band 2e-2 (test_torch_int8.py's). Both with the first block's
pack and from a given one.

Tiny widths: D 128, 2 heads of 64, M 256, spq 16 with seq_len 10, bf16.
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402
from vitax_torch.ops.common import matmul_f32  # noqa: E402
from vitax_torch.ops.quant import int_mm, quant_cols_host, quant_rows  # noqa: E402

D, H, HD, M, SPQ, SEQ, EPS = 128, 2, 64, 256, 16, 10, 1e-5
BF = torch.bfloat16
TOL = 2e-2
LANES = pk._HO_SCALE_LANES
_MATS = ("x", "wqkv", "wo", "w1", "w2")


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _arrays(seed, batch):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(x=n(batch, SPQ, D) * 1.5 + 0.3, g1=1 + n(D, scale=0.1),
                be1=n(D, scale=0.1), g2=1 + n(D, scale=0.1),
                be2=n(D, scale=0.1), gn=1 + n(D, scale=0.1),
                ben=n(D, scale=0.1), wqkv=n(D, 3 * H * HD, scale=D ** -0.5),
                bqkv=n(3 * H * HD, scale=0.1),
                wo=n(H * HD, D, scale=(H * HD) ** -0.5), bo=n(D, scale=0.1),
                w1=n(D, M, scale=D ** -0.5), b1=n(M, scale=0.1),
                w2=n(M, D, scale=M ** -0.5), b2=n(D, scale=0.1))


def _torch(arrays):
    return {k: torch.from_numpy(v).to(BF if k in _MATS else torch.float32)
            for k, v in arrays.items()}


def _jax(arrays):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in _MATS else jnp.float32)
            for k, v in arrays.items()}


def _k13_core_f32(qkv, b):
    """K13's forward core (kRowsFwdF32) on the packed qkv rows [b·SPQ,
    3·H·HD]: per head, m of s·scale·log2e over the keys < SEQ, 1/l of
    Σ exp2(s·c − m), p = exp2(s·c − m)·(1/l), 0 on the keys >= SEQ, rounded
    to bf16 once; the fp32 head outputs p·v side by side, [b·SPQ, H·HD]."""
    q, k, v = (ck._split_heads(qkv.view(b, SPQ, -1)[..., i * H * HD:
                                                    (i + 1) * H * HD], H)
               for i in range(3))
    s = matmul_f32(q, k.transpose(-1, -2)) * (math.log2(math.e)
                                              / math.sqrt(HD))
    s[..., SEQ:] = -math.inf
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp2(s - m)
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))
    return ck._heads_to_rows(matmul_f32(p.to(BF), v))


def attn_half_composed(t, xq=None, sx=None):
    """K5's attention half in its launch order (xq None: the first block,
    packed here): (r1 [b, SPQ, D], xq2, sx2, qkv, the xq and sx it used)."""
    b = t["x"].shape[0]
    x2 = t["x"].reshape(-1, D)
    w8, sw = quant_cols_host(t["wqkv"])  # stored [W, D]: its transpose
    wo8, swo = quant_cols_host(t["wo"])
    if xq is None:
        xq, sx = ck.pack_rows(x2, t["g1"], t["be1"], EPS)
    qkv = ck.gemm_sm90_s8_ref("s8_bf16", xq, w8.t().contiguous(), sx, sw,
                              t["bqkv"])
    aq, sa = quant_rows(_k13_core_f32(qkv, b))
    r1 = ck.gemm_sm90_s8_ref("s8_residual_f32", aq, wo8.t().contiguous(), sa,
                             swo, t["bo"], residual=x2)
    xq2, sx2 = ck.pack_rows(r1, t["g2"], t["be2"], EPS)
    return r1.view(t["x"].shape), xq2, sx2, qkv, xq, sx


def mlp_half_composed(t, r1, xq, sx):
    """K5's MLP half in its launch order: (r2 [rows, D], xqn, sxn)."""
    w1q, s1 = quant_cols_host(t["w1"])  # stored [M, D]: its transpose
    w2q, s2 = quant_cols_host(t["w2"])
    g = ck.gemm_sm90_s8_ref("s8_gelu_q_f32", xq, w1q.t().contiguous(), sx, s1,
                            t["b1"])
    h1q, sh = quant_rows(g)
    r2 = ck.gemm_sm90_s8_ref("s8_residual_f32", h1q, w2q.t().contiguous(), sh,
                             s2, t["b2"], residual=r1.reshape(-1, D))
    xqn, sxn = ck.pack_rows(r2, t["gn"], t["ben"], EPS)
    return r2, xqn, sxn


def _attn_args(t, xq, sx):
    return (t["x"], xq, sx, t["g1"], t["be1"], t["g2"], t["be2"], t["wqkv"],
            t["bqkv"], t["wo"], t["bo"], EPS, SEQ, H, HD)


def _mlp_args(t, r1, xq, sx):
    return (r1, xq, sx, t["gn"], t["ben"], t["w1"], t["b1"], t["w2"],
            t["b2"], EPS)


def _close(out, ref, what):
    ref = np.asarray(ref, np.float32)
    out = out.float().numpy().reshape(ref.shape)
    bound = TOL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= bound, f"{what}: max error {err:.3e} > {bound:.3e}"


def _given_pack(t):
    """A later block's packed LN1 input: the pack of x, as the previous
    block's MLP epilogue writes it."""
    return ck.pack_rows(t["x"], t["g1"], t["be1"], EPS)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("first", [True, False])
def test_attention_half_launch_order_matches_its_twin(batch, first):
    t = _torch(_arrays(51, batch))  # the pad rows hold garbage
    xq, sx = (None, None) if first else _given_pack(t)
    r1, xq2, sx2, qkv, xq_used, sx_used = attn_half_composed(t, xq, sx)
    st = {}
    r1_t, xq2_t, sx2_t = ck.fused_ln_qkvo_attention_int8_ho_ref(
        *_attn_args(t, xq, sx), scratch=st)
    assert r1.dtype == BF and r1.shape == r1_t.shape
    _close(r1, r1_t.float().numpy(), "K5 attention r1 vs its twin")
    # the first block's pack is the twin's, to the bit
    assert all(map(torch.equal, (xq_used, sx_used), st["xq"]))
    # qkv as the twin forms it (pallas_kernels.py:3686-3689): the bits
    w8, sw = quant_cols_host(t["wqkv"])
    assert torch.equal(qkv, ck._dequant(int_mm(xq_used, w8),
                                        sx_used.reshape(-1, 1), sw,
                                        t["bqkv"]).to(BF))
    # LN2 packs the bf16 r1: from the twin's r1 the same pass gives its bits
    assert all(map(torch.equal, ck.pack_rows(r1_t, t["g2"], t["be2"], EPS),
                   (xq2_t, sx2_t)))
    assert xq2.shape == xq2_t.shape and sx2.shape == sx2_t.shape


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("first", [True, False])
def test_mlp_half_launch_order_equals_its_twin(batch, first):
    """From the same packed input (the attention twin's r1, xq2, sx2, with
    its input packed by the first block or given), the MLP half's r2, xqn
    and sxn are the twin's bits, its h1q codes too."""
    t = _torch(_arrays(52, batch))
    xq, sx = (None, None) if first else _given_pack(t)
    r1, xq2, sx2 = ck.fused_ln_qkvo_attention_int8_ho_ref(
        *_attn_args(t, xq, sx))
    r2, xqn, sxn = mlp_half_composed(t, r1, xq2, sx2)
    r2_t, xqn_t, sxn_t = ck.fused_ln_mlp_int8_ho_ref(
        *_mlp_args(t, r1, xq2, sx2))
    assert r2.dtype == BF
    assert torch.equal(r2.view(r2_t.shape), r2_t)
    assert torch.equal(xqn, xqn_t) and torch.equal(sxn, sxn_t)


def _vitax_pack(jx, j):
    return pk.pack_stream(jx, j["g1"], j["be1"], EPS)


def _lanes(s, b):
    """The port's one scale a row as vitax's broadcast scale lanes."""
    return jnp.broadcast_to(jnp.asarray(s.numpy()).reshape(b, SPQ, 1),
                            (b, SPQ, LANES))


@pytest.mark.parametrize("first", [True, False])
def test_attention_half_launch_order_matches_vitax_under_jit(first):
    arrays = _arrays(53, 3)
    j, t = _jax(arrays), _torch(arrays)
    b = 3
    if first:  # each side packs x itself
        xq_j, sx_j = _vitax_pack(j["x"], j)
        xq, sx = None, None
    else:  # both take the port's pack
        xq, sx = _given_pack(t)
        xq_j = jnp.asarray(xq.numpy()).reshape(b, SPQ, D)
        sx_j = _lanes(sx, b)
    fn = jax.jit(lambda *a: pk._qkvo_ho_fwd_call(*a, EPS, SEQ, H, HD))
    r1_j, _, sx2_j = fn(j["x"], xq_j, sx_j, j["g2"], j["be2"], j["wqkv"],
                        j["bqkv"], j["wo"], j["bo"])
    r1, _, sx2, *_ = attn_half_composed(t, xq, sx)
    # vitax's pad rows attend as the port's do; every row is held
    _close(r1, jnp.asarray(r1_j, jnp.float32), "K5 attention r1 vs vitax")
    _close(sx2, jnp.asarray(sx2_j, jnp.float32)[..., 0],
           "K5 attention sx2 vs vitax")


@pytest.mark.parametrize("first", [True, False])
def test_mlp_half_launch_order_matches_vitax_under_jit(first):
    """Both MLP halves on the same packed input: the composed attention
    half's (r1, xq2, sx2)."""
    arrays = _arrays(54, 3)
    j, t = _jax(arrays), _torch(arrays)
    b = 3
    xq, sx = (None, None) if first else _given_pack(t)
    r1, xq2, sx2, *_ = attn_half_composed(t, xq, sx)
    fn = jax.jit(lambda *a: pk._mlp_ho_fwd_call(*a, EPS))
    r2_j, _, sxn_j = fn(
        jnp.asarray(r1.float().numpy(), jnp.bfloat16).reshape(-1, D),
        jnp.asarray(xq2.numpy()),
        _lanes(sx2, b).reshape(-1, LANES), j["gn"], j["ben"], j["w1"],
        j["b1"], j["w2"], j["b2"])
    r2, _, sxn = mlp_half_composed(t, r1, xq2, sx2)
    _close(r2, jnp.asarray(r2_j, jnp.float32), "K5 MLP r2 vs vitax")
    _close(sxn, jnp.asarray(sxn_j, jnp.float32)[:, 0], "K5 MLP sxn vs vitax")


def test_gemm_sm90_s8_residual_f32_takes_its_twin_on_cpu_tensors():
    """The wrapper of the handoff's kind takes its twin on CPU tensors; the
    twin is the handoff's arithmetic (pallas_kernels.py:3721-3722): the
    residual added to the dequantized product + bias in fp32, rounded to
    bf16 once (where `s8_residual` rounds the product to bf16 first)."""
    inputs = ck.gemm_sm90_s8_inputs("s8_residual_f32", 24, 40, 64, True,
                                    seed=3, device="cpu")
    out = ck.gemm_sm90_s8("s8_residual_f32", **inputs)
    y = ck._dequant(int_mm(inputs["a"], inputs["b"].t()),
                    inputs["sr"].reshape(-1, 1), inputs["sc"],
                    inputs["bias"])
    ref = (inputs["residual"].float() + y).to(BF)
    assert out.shape == (24, 40) and out.dtype == BF
    assert torch.equal(out, ref)
    assert not torch.equal(out, ck.gemm_sm90_s8("s8_residual", **inputs))


@pytest.mark.parametrize("source,launches", [
    ("ln_qkvo_attention_int8_ho.cu",
     ("sm90::gemm_s8<sm90::kEpiS8Bf16>",
      "sm90::gemm_s8<sm90::kEpiS8ResidualF32>",
      "launch_core_rows<vitax::k13::kRowsFwdF32>", "launch_quant_rows(",
      "launch_layer_norm_quant<false>(")),
    ("ln_mlp_int8_ho.cu",
     ("sm90::gemm_s8<sm90::kEpiS8GeluQF32>",
      "sm90::gemm_s8<sm90::kEpiS8ResidualF32>", "launch_quant_rows(",
      "launch_layer_norm_quant<false>("))])
def test_k5_sources_launch_the_hopper_pieces_only(source, launches):
    """Each K5 source launches gemm_sm90.cuh's s8 products, K13's core
    (the attention half) and the quant.cuh and layernorm.cuh row passes
    that this file composes; neither reaches the first design's whole-row
    core or gemm.cuh's mma.sync s8 product."""
    from vitax_torch.kernels import build
    src = (build.CSRC / source).read_text()
    for call in launches:
        assert call in src, call
    for first_design in ('#include "attention.cuh"', "launch_attention_core",
                         "launch_gemm_s8"):
        assert first_design not in src, first_design
