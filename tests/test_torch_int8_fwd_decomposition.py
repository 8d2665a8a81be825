"""K3's and K4's int8 forwards composed from plain versions in the order
their Hopper entry points launch them on the card
(csrc/ln_qkvo_attention_int8.cu with kv_heads == heads, csrc/ln_mlp_int8.cu
at L = 127), on CPU tensors:

- K3: the weights' column codes, the LN-quant prologue, qkv on
  `gemm_sm90_s8_ref("s8_bf16")` + bias, K13's forward core on the packed
  rows with the fp32 out (keys masked at seq_len, the pad query rows
  computed; p = exp2(s·scale·log2e − m)·(1/l) rounded to bf16 once, p·v in
  fp32 and never rounded), the attn's row codes, then the out-projection
  on `s8_bf16` + bias;
- K4: the weights' column codes, the LN-quant prologue, fc1 on
  `s8_gelu_q_f32` (gelu_q(dq + b1) in fp32), its row codes, then fc2 on
  `s8_residual` (x + bf16(dq + b2)) or, without the residual, `s8_bf16`.

The compositions are held against the fused twins (the plain versions the
card holds the kernels against): K4's in both branches, and K3's qkv, to
the bit (exact integer products, the same dequantizing order); K3's out
within the bf16 tolerance 2e-2 (ulp 2^-8: K13's p comes from the row
statistics in exp2, the twin's from its softmax, so a few attn codes move
one step). Then both against vitax's `fused_ln_qkvo_attention(int8=True)`
and `fused_ln_mlp(int8=True)` under `jax.jit` in interpret mode, within the
int8 tiers' CPU band 2e-2 (test_torch_int8.py's).

Tiny widths: D 128, 2 heads of 64, M 256, spq 16 with seq_len 10, bf16.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tests import torch_int8_compose as compose  # noqa: E402
from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402
from vitax_torch.ops.quant import int_mm, quant_cols_host, quant_rows  # noqa: E402

D, H, HD, M, SPQ, SEQ, EPS = 128, 2, 64, 256, 16, 10, 1e-5
BF = torch.bfloat16
TOL = 2e-2
QKVO = ("x", "gamma", "beta", "wqkv", "bqkv", "wo", "bo")
MLP = ("x", "gamma", "beta", "w1", "b1", "w2", "b2")
_MATS = ("x", "wqkv", "wo", "w1", "w2")


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _arrays(seed, batch, rows=SPQ):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(x=n(batch, rows, D) * 1.5 + 0.3, gamma=1 + n(D, scale=0.1),
                beta=n(D, scale=0.1), wqkv=n(D, 3 * H * HD, scale=D ** -0.5),
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


def _ln_quant(x2, gamma, beta):
    """The LN-quant prologue: the codes and scales of the fp32 LN output."""
    return compose.ln_quant(x2, gamma, beta, EPS)


def k3_fwd_composed(t):
    """K3's forward in its launch order: (out, qkv)."""
    return compose.k3_fwd_composed(t, SEQ, H, HD, EPS)


def k4_fwd_composed(t, residual):
    """K4's forward in its launch order."""
    x2 = t["x"].reshape(-1, D)
    w1q, s1 = quant_cols_host(t["w1"])  # stored [M, D]: its transpose
    w2q, s2 = quant_cols_host(t["w2"])
    xq, sx = _ln_quant(x2, t["gamma"], t["beta"])
    g = ck.gemm_sm90_s8_ref("s8_gelu_q_f32", xq, w1q.t().contiguous(), sx, s1,
                            t["b1"])
    h1q, sh = quant_rows(g)
    if residual:
        out = ck.gemm_sm90_s8_ref("s8_residual", h1q, w2q.t().contiguous(),
                                  sh, s2, t["b2"], residual=x2)
    else:
        out = ck.gemm_sm90_s8_ref("s8_bf16", h1q, w2q.t().contiguous(), sh,
                                  s2, t["b2"])
    return out.view(t["x"].shape)


def _close(out, ref, what):
    ref = np.asarray(ref, np.float32)
    out = out.float().numpy().reshape(ref.shape)
    bound = TOL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= bound, f"{what}: max error {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("batch", [1, 3])
def test_k3_launch_order_matches_its_twin(batch):
    t = _torch(_arrays(41, batch))  # the pad rows hold garbage
    out, qkv = k3_fwd_composed(t)
    twin = ck.fused_ln_qkvo_attention_int8_ref(*(t[k] for k in QKVO), EPS,
                                               SEQ, H, HD)
    assert out.dtype == BF and out.shape == twin.shape
    _close(out, twin.float().numpy(), "K3 out vs its twin")
    # qkv as the twin forms it (pallas_kernels.py:2707-2710): the bits
    w8, sw = quant_cols_host(t["wqkv"])
    xq, sx = _ln_quant(t["x"].reshape(-1, D), t["gamma"], t["beta"])
    assert torch.equal(qkv, ck._dequant(int_mm(xq, w8), sx, sw,
                                        t["bqkv"]).to(BF))


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("batch,rows", [(1, SPQ), (3, SPQ), (3, SEQ)])
def test_k4_launch_order_equals_its_twin(batch, rows, residual):
    t = _torch(_arrays(42, batch, rows))
    out = k4_fwd_composed(t, residual)
    twin = ck.fused_ln_mlp_int8_ref(*(t[k] for k in MLP), EPS,
                                    residual=residual)
    assert out.dtype == BF and out.shape == twin.shape
    assert torch.equal(out, twin)


def test_k3_launch_order_matches_vitax_under_jit():
    arrays = _arrays(43, 3)
    j, t = _jax(arrays), _torch(arrays)
    fn = jax.jit(lambda *a: pk.fused_ln_qkvo_attention(*a, EPS, SEQ, H, HD,
                                                       int8=True))
    ref = fn(*(j[k] for k in QKVO))
    out, _ = k3_fwd_composed(t)
    # vitax's pad rows attend as the port's do; every row is held
    _close(out, jnp.asarray(ref, jnp.float32), "K3 vs vitax")


@pytest.mark.parametrize("residual", [True, False])
def test_k4_launch_order_matches_vitax_under_jit(residual):
    arrays = _arrays(44, 3, SEQ)
    j, t = _jax(arrays), _torch(arrays)
    fn = jax.jit(lambda *a: pk.fused_ln_mlp(*a, EPS, residual=residual,
                                            int8=True))
    ref = fn(*(j[k] for k in MLP))
    _close(k4_fwd_composed(t, residual), jnp.asarray(ref, jnp.float32),
           "K4 vs vitax")


@pytest.mark.parametrize("kind", ["s8_gelu_q_f32", "s8_residual"])
def test_gemm_sm90_s8_new_kinds_take_their_twin_on_cpu_tensors(kind):
    """The wrapper of the two new kinds takes their twin on CPU tensors;
    the twin is gemm.cuh's kS8GeluQF32 / kS8Residual arithmetic: gelu_q of
    the dequantized product + bias in fp32, and the residual add of two
    bf16 values rounded once."""
    inputs = ck.gemm_sm90_s8_inputs(kind, 24, 40, 64, True, seed=3,
                                    device="cpu")
    out = ck.gemm_sm90_s8(kind, **inputs)
    y = ck._dequant(int_mm(inputs["a"], inputs["b"].t()),
                    inputs["sr"].reshape(-1, 1), inputs["sc"],
                    inputs["bias"])
    if kind == "s8_residual":
        ref = (inputs["residual"].float() + y.to(BF).float()).to(BF)
    else:
        ref = ck.gelu_q(y)
    assert out.shape == (24, 40) and out.dtype == ref.dtype
    assert torch.equal(out, ref)


@pytest.mark.parametrize("residual", [True, False])
def test_k4_twin_from_given_codes_takes_them(residual):
    """`fused_ln_mlp_int8_from_codes_ref`, the card checks' bit-for-bit
    yardstick of K4 fed the kernel's own LN codes: given the twin's codes it
    is the twin, to the bit, scratch included; given a code one step off it
    follows that code."""
    t = _torch(_arrays(45, 3, SEQ))
    args = [t[k] for k in MLP]
    st, sc = {}, {}
    twin = ck.fused_ln_mlp_int8_ref(*args, EPS, residual=residual,
                                    scratch=st)
    xq, sx = st["xq"]
    out = ck.fused_ln_mlp_int8_from_codes_ref(
        t["x"], xq, sx, *args[3:], residual=residual, scratch=sc)
    assert torch.equal(out, twin)
    assert st.keys() == sc.keys()
    for key in st:
        assert all(map(torch.equal, st[key], sc[key])), key
    moved = xq.clone()
    moved[0] += torch.where(moved[0] < 127, 1, -1).to(torch.int8)
    off = ck.fused_ln_mlp_int8_from_codes_ref(
        t["x"], moved, sx, *args[3:], residual=residual)
    assert not torch.equal(off[0, 0], twin[0, 0])
    assert torch.equal(off[1:], twin[1:])
