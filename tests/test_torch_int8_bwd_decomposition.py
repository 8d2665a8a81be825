"""K3's and K4's int8 backwards composed from plain versions in the order
their Hopper entry points launch them on the card
(csrc/ln_qkvo_attention_int8_bwd.cu with kv_heads == heads,
csrc/ln_mlp_int8_bwd.cu), on CPU tensors:

- K3: the weights' codes, the LN-quant recompute, qkv on
  `gemm_sm90_s8_ref("s8_bf16")` + bias, the core on the packed rows (its
  forward as the twin's; its grads as K13's three passes run them: the
  row pass's m, 1/l and dd from the bf16 head outputs, p =
  exp2(s·scale·log2e − m)·(1/l) in the key and query passes), do's codes,
  dattn (`s8_bf16`), dWo (`gemm_sm90_ref("tn_f32")`, or under int8_dw
  dw_int8.cuh's operand packs, each group's rows zero-padded to the
  128-code K tile, and `s8_group`), dbo, dqkv's codes, dxn (`s8_f32`), dW,
  dbqkv and the LN tail;
- K4: the weights' codes, the LN-quant recompute from the bf16 xn, do's
  codes, the dual product (`s8_gelu_pair`: h1, dh1, dh1_32), db2, db1,
  dh1_32's codes, dW2 and dW1 (`tn_f32`, or the group fold), dxn
  (`s8_f32`) and the LN tail, with and without the residual.

The compositions are held against the fused twins (the plain versions the
card holds the kernels against): to the bit where the design keeps the
twin's arithmetic (every K4 output; K3's dWo and dbo), and within the bf16
tolerance 2e-2 (ulp 2^-8: the same rounding points, but p is recomputed
from the row statistics instead of the softmax's fp32 row) for what K3's
core grads reach. Then against vitax's Pallas VJPs (`_fused_ln_qkvo_bwd`,
`_ln_mlp_bwd_int8_call`) under `jax.jit` in interpret mode, within the
int8 tiers' CPU band (test_torch_int8.py: 2e-2 in bf16, weight grads
included), K4's int8_dw at vitax's group.

Tiny widths: D 128, 2 heads of 64, M 256, spq 16 with seq_len 10, bf16;
K3 at b8 (int8_dw groups of 4 images, 64 rows in 128-row tiles), K4 on 10
images (160 rows: the port's int8_dw groups 128 and 32).
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

D, H, HD, M, SPQ, SEQ, EPS = 128, 2, 64, 256, 16, 10, 1e-5
BF = torch.bfloat16
TOL = 2e-2
K3_BATCH, K4_BATCH = 8, 10
QKVO = ("x", "gamma", "beta", "wqkv", "bqkv", "wo")
MLP = ("x", "gamma", "beta", "w1", "b1", "w2")
NAMES = {"k3": ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwo", "dbo"),
         "k4": ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")}
# (kernel, int8_dw, residual): both int8_dw branches, K4's two residual ones
CASES = [("k3", False, True), ("k3", True, True), ("k4", False, True),
         ("k4", True, True), ("k4", False, False), ("k4", True, False)]


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _arrays(seed, batch):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(x=n(batch, SPQ, D) * 1.5 + 0.3, do=n(batch, SPQ, D),
                gamma=1 + n(D, scale=0.1), beta=n(D, scale=0.1),
                wqkv=n(D, 3 * H * HD, scale=D ** -0.5),
                bqkv=n(3 * H * HD, scale=0.1),
                wo=n(H * HD, D, scale=(H * HD) ** -0.5),
                w1=n(D, M, scale=D ** -0.5), b1=n(M, scale=0.1),
                w2=n(M, D, scale=M ** -0.5))


_MATS = ("x", "do", "wqkv", "wo", "w1", "w2")


def _torch(arrays):
    return {k: torch.from_numpy(v).to(BF if k in _MATS else torch.float32)
            for k, v in arrays.items()}


def _jax(arrays):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in _MATS else jnp.float32)
            for k, v in arrays.items()}


def k3_bwd_composed(t, int8_dw, group):
    """K3's backward in its launch order: (dx, dγ, dβ, dWqkv, dbqkv, dWo,
    dbo)."""
    return compose.qkvo_int8_bwd_composed(t, SEQ, H, HD, EPS, int8_dw,
                                          group)[0]


def k4_bwd_composed(t, int8_dw, group, residual):
    """K4's backward in its launch order: (dx, dγ, dβ, dW1, db1, dW2,
    db2)."""
    return compose.mlp_int8_bwd_composed(t, EPS, int8_dw, group, residual)


def _close(out, ref, what):
    ref = np.asarray(ref, np.float32)
    out = out.float().numpy().reshape(ref.shape)
    bound = TOL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= bound, f"{what}: max error {err:.3e} > {bound:.3e}"


def _vitax_mlp_group(n):
    """vitax's int8_dw group of K4's backward over n rows (one grid step's
    row chunk of its padded rows)."""
    rows = pk._ln_mlp_rows(pk._ln_mlp_pad(n, int8=True), int8=True)
    return rows // pk._bwd_chunks(rows)


@pytest.mark.parametrize("kernel,int8_dw,residual", CASES)
def test_launch_order_equals_the_twins(kernel, int8_dw, residual):
    if kernel == "k3":
        t = _torch(_arrays(31, K3_BATCH))
        args = (*(t[k] for k in QKVO), t["do"], EPS, SEQ, H, HD)
        group = ck.qkvo_dw_group(K3_BATCH, SPQ)
        out = k3_bwd_composed(t, int8_dw, group)
        twin = ck.fused_ln_qkvo_attention_int8_bwd_ref(
            *args, int8_dw=int8_dw, group=group)
        exact = ("dwo", "dbo")  # what K3's core grads do not reach
    else:
        t = _torch(_arrays(32, K4_BATCH))
        args = (*(t[k] for k in MLP), t["do"], EPS)
        out = k4_bwd_composed(t, int8_dw, ck.MLP_DW_GROUP, residual)
        twin = ck.fused_ln_mlp_int8_bwd_ref(*args, int8_dw=int8_dw,
                                            residual=residual)
        exact = NAMES["k4"]
    for name, o, r in zip(NAMES[kernel], out, twin):
        assert o.dtype == r.dtype and o.shape == r.shape, name
        if name in exact:
            assert torch.equal(o, r), name
        else:
            _close(o, r.float().numpy(), name)


@pytest.mark.parametrize("kernel,int8_dw,residual", CASES)
def test_launch_order_matches_vitax_under_jit(kernel, int8_dw, residual):
    if kernel == "k3":
        arrays = _arrays(33, K3_BATCH)
        j, t = _jax(arrays), _torch(arrays)
        fn = jax.jit(functools.partial(pk._fused_ln_qkvo_bwd, EPS, SEQ, H,
                                       HD, True, True, int8_dw, False, False,
                                       None))
        refs = fn(tuple(j[k] for k in QKVO), j["do"])
        out = k3_bwd_composed(t, int8_dw, ck.qkvo_dw_group(K3_BATCH, SPQ))
    else:
        arrays = _arrays(34, K4_BATCH)
        j, t = _jax(arrays), _torch(arrays)
        n = K4_BATCH * SPQ
        npad = pk._ln_mlp_pad(n, int8=True)

        def pad(a):
            return jnp.pad(a.reshape(n, D), ((0, npad - n), (0, 0)))

        fn = jax.jit(functools.partial(pk._ln_mlp_bwd_int8_call, eps=EPS,
                                       residual=residual, int8_dw=int8_dw))
        refs = fn(pad(j["x"]), j["gamma"], j["beta"], j["w1"], j["b1"],
                  j["w2"], do2=pad(j["do"]))
        refs = (refs[0][:n], *refs[1:])
        out = k4_bwd_composed(t, int8_dw, _vitax_mlp_group(n), residual)
    for name, o, r in zip(NAMES[kernel], out, refs):
        _close(o, jnp.asarray(r, jnp.float32), f"{name} vs vitax")
