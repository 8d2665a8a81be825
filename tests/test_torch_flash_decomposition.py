"""K6's Hopper design composed from plain versions on CPU tensors, held
against vitax's K6 (`_flash_head_fwd` and `fused_ln_qkvo_attention_flash`,
pallas_kernels.py:3391-3622) on the same numpy inputs, vitax's side under
`jax.jit` with its Pallas kernels in interpret mode.

(a) The online core's plain version (`ck.flash_online_core_ref`: 64-key
    tiles, p = exp2(s·c − m_new) rounded to the compute dtype unnormalised,
    the fp32 output rescaled by α and multiplied by 1/l at the end) against
    `_flash_head_fwd`, whose key chunks are spq / _flash_chunks(spq) wide:
    the output within the dtype's band, the row statistics (the row max
    and the sum of exp, which no tiling moves) at fp32 precision. Ragged
    (spq 40, seq_len 37), a whole key tile past seq_len (spq 136, seq_len
    100: keys 128..135 lie in no tile the core walks), and ViT-H/14's spq
    264, at head_dim 64 and 80.
(b) The core backward as the card runs it (the online row pass's m, 1/l
    and dd = Σ fp32(dO)·out from the fp32 out, then K13's key and query
    passes: p = exp2(s·c − m)·(1/l), ds = (p (dO vᵀ − dd)) in the compute
    dtype, dq, dk, dv cast once) against the core grads of vitax's
    `fused_ln_qkvo_attention_flash` VJP. Those are inside its kernel, so
    they are read back from its dWqkv = xnᵀ·dqkv: with fewer rows than
    columns xn has full row rank and dqkv is the least-squares solution
    (fp32 sums of exact products, so the read-back is vitax's dqkv to
    about 1e-6 of its scale).
(c) K6's forward and backward in the order their C entry points launch
    them (csrc/ln_qkvo_attention_flash.cu, _bwd.cu): LN,
    `gemm_sm90_ref("nn_bias")` (qkv), the online core, `gemm_sm90_ref(
    "nn_bias")` (out); for the backward the qkv recompute, `nt_store`
    (dattn), the online row pass and K13's passes, `tn_f32` (dWo), the
    column sum (dbo), `nt_f32` (dxn), `tn_f32` (dWqkv), the column sum
    (dbqkv) and the LN tail; against the fused twins (vitax's chunks) and
    against vitax's kernel and its VJP, in bf16 as on the card.

Tolerances, max|port − vitax| <= tol · max(1, max|vitax|): fp32 1e-5 for
outputs (1e-4 for the read-back grads: the least-squares solve multiplies
the fp32 rounding of dWqkv by xn's condition number, under 10 here); bf16
2e-2 (ulp 2^-8: the same rounding points, but p is rounded against the
running max of other key ranges, and sums run in another order).
"""

import functools
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402
from vitax_torch.ops.common import matmul_f32  # noqa: E402
from vitax_torch.ops.layernorm import layer_norm_ref  # noqa: E402

EPS = 1e-5
BF = torch.bfloat16
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _close(out, ref, tol, what=""):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= bound, (what, err, bound)


# ------------------------------------------------------------------- (a)

CORE_CASES = [(40, 37, 64), (40, 37, 80), (136, 100, 64), (136, 100, 80),
              (264, 257, 80)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spq,seq,hd", CORE_CASES)
def test_online_core_matches_vitax_flash_head(spq, seq, hd, dtype):
    heads = 2
    hhd = heads * hd
    qkv = (np.random.default_rng(spq + hd).standard_normal((spq, 3 * hhd))
           * 1.5).astype(np.float32)
    n_kv = pk._flash_chunks(spq)

    @jax.jit
    def vitax_heads(a):
        return [pk._flash_head_fwd(a[:, o:o + hd], a, o, hhd, hd, spq,
                                   1.0 / math.sqrt(hd), seq, n_kv,
                                   want_stats=True)
                for o in range(0, hhd, hd)]

    refs = vitax_heads(jnp.asarray(qkv, getattr(jnp, dtype)))
    t = torch.from_numpy(qkv).to(getattr(torch, dtype))[None]
    q, k, v = (ck._split_heads(c, heads) for c in t.chunk(3, dim=-1))
    out, m, inv = ck.flash_online_core_ref(q, k, v, seq)
    assert out.dtype == m.dtype == inv.dtype == torch.float32
    for h, (o_j, m_j, l_j) in enumerate(refs):
        _close(out[0, h], o_j, TOL[dtype], f"out head {h}")
        np.testing.assert_allclose(m[0, h].numpy(),
                                   np.asarray(m_j) * math.log2(math.e),
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(inv[0, h].numpy(), 1.0 / np.asarray(l_j),
                                   rtol=1e-5)


def test_online_core_wrapper_rows_and_statistics():
    """`flash_online_core` on CPU tensors (its plain version) in the card
    entry point's layout: the bf16 head outputs side by side in rows, and
    the row pass's statistics [B, H, 3, seq_pad]: m·scale·log2e, 1/l and
    dd = Σ fp32(dO)·out from the fp32 out (vitax's :3479), 0 past spq."""
    spq, seq, hd, heads = 40, 37, 80, 2
    hhd = heads * hd
    rng = np.random.default_rng(11)
    qkv = (rng.standard_normal((spq, 3 * hhd)) * 1.5).astype(np.float32)
    dattn = rng.standard_normal((spq, hhd)).astype(np.float32)
    j_qkv = jnp.asarray(qkv, jnp.bfloat16)
    refs = jax.jit(lambda a: [
        pk._flash_head_fwd(a[:, o:o + hd], a, o, hhd, hd, spq,
                           1.0 / math.sqrt(hd), seq, pk._flash_chunks(spq),
                           want_stats=True)
        for o in range(0, hhd, hd)])(j_qkv)
    attn, st = ck.flash_online_core(torch.from_numpy(qkv).to(BF)[None], seq,
                                    heads, hd,
                                    dattn=torch.from_numpy(dattn).to(BF)[None])
    assert attn.dtype == BF and attn.shape == (1, spq, hhd)
    assert st.dtype == torch.float32 and st.shape == (1, heads, 3, 64)
    assert not st[..., spq:].any()
    d_o = np.asarray(jnp.asarray(dattn, jnp.bfloat16), np.float32)
    for h, (o_j, m_j, l_j) in enumerate(refs):
        o_j = np.asarray(o_j)
        _close(attn[0, :, h * hd:(h + 1) * hd].float(), o_j, TOL["bfloat16"])
        np.testing.assert_allclose(st[0, h, 0, :spq].numpy(),
                                   np.asarray(m_j)[:, 0] * math.log2(math.e),
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(st[0, h, 1, :spq].numpy(),
                                   1.0 / np.asarray(l_j)[:, 0], rtol=1e-5)
        dd = (d_o[:, h * hd:(h + 1) * hd] * o_j).sum(axis=-1)
        _close(st[0, h, 2, :spq], dd, TOL["bfloat16"])


def test_online_core_rounds_p_unnormalised():
    """bf16 p is rounded before its division by l: the plain core's output
    is not the normalise-first core's (K13's rounding), and each key tile's
    p is rounded against its own running max."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy((rng.standard_normal((1, 2, 136, 64)) * 1.5)
                                .astype(np.float32)).to(BF) for _ in range(3))
    out, _, _ = ck.flash_online_core_ref(q, k, v, 130)
    p, normalised = ck._softmax_pv(q, k, v, 130)
    assert not torch.equal(out, normalised)
    _close(out, normalised, TOL["bfloat16"])


# ------------------------------------------------------------------- (b)

# (batch, spq, seq_len, D, heads, head_dim); batch·spq < D, so that xn has
# full row rank
BWD_CASES = [(1, 40, 37, 128, 2, 64), (1, 136, 100, 256, 2, 80)]


def _qkvo(case, seed):
    """(x, γ, β, Wqkv, bqkv, Wo, bo) and do as fp32 numpy arrays."""
    b, spq, _, d, h, hd = case
    rng = np.random.default_rng(seed)

    def n(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    hhd = h * hd
    args = (n(b, spq, d), 1 + n(d, scale=0.1), n(d, scale=0.1),
            n(d, 3 * hhd, scale=2 * d ** -0.5), n(3 * hhd, scale=0.1),
            n(hhd, d, scale=hhd ** -0.5), n(d, scale=0.1))
    return args, n(b, spq, d)


def _typed(args, dtype, lib):
    """The compute-dtype operands (x, Wqkv, Wo, do) in `dtype`, the rest
    fp32."""
    mats = (0, 3, 5, 7)
    if lib == "jax":
        dt = getattr(jnp, dtype)
        return [jnp.asarray(a, dt if i in mats else jnp.float32)
                for i, a in enumerate(args)]
    dt = getattr(torch, dtype)
    return [torch.from_numpy(a).to(dt if i in mats else torch.float32)
            for i, a in enumerate(args)]


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _vitax_flash(args, do, seq, h, hd):
    """vitax's K6 forward and the 7 grads of its VJP."""
    out, vjp = jax.vjp(
        lambda *a: pk.fused_ln_qkvo_attention_flash(*a, EPS, seq, h, hd),
        *args)
    return out, vjp(do)


def core_bwd_decomposed(q, k, v, d_o, seq):
    """K6's core backward as the card runs it: the online row pass (the
    fp32 out, m, 1/l; dd = Σ fp32(dO)·out), then K13's key and query passes
    on those statistics: p = exp2(s·c − m)·(1/l), 0 on the keys >= seq,
    ds = (p (dO·vᵀ − dd)) in the compute dtype, dq = ((ds·k)·scale),
    dk = ((dsᵀ·q)·scale), dv = bf16(p)ᵀ·dO, each cast once. q, k, v, d_o
    [B, H, rows, Hd]; returns (out, dq, dk, dv), out in fp32."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    out, m, inv = ck.flash_online_core_ref(q, k, v, seq)
    dd = (d_o.float() * out).sum(dim=-1, keepdim=True)
    s = matmul_f32(q, k.transpose(-1, -2))
    p = torch.exp2(s * (scale * math.log2(math.e)) - m) * inv
    p[..., seq:] = 0.0
    ds = (p * (matmul_f32(d_o, v.transpose(-1, -2)) - dd)).to(dt)
    dq = (matmul_f32(ds, k) * scale).to(dt)
    dk = (matmul_f32(ds.transpose(-1, -2), q) * scale).to(dt)
    dv = matmul_f32(p.to(dt).transpose(-1, -2), d_o).to(dt)
    return out, dq, dk, dv


def _core_operands(t, case):
    """xn [n, D], qkv [n, 3·hhd] and q, k, v [B, H, spq, Hd] at the
    kernels' rounding points, in the compute dtype of t."""
    b, spq, _, d, h, _ = case
    xn = layer_norm_ref(t[0], t[1], t[2], EPS).reshape(-1, d)
    qkv = (matmul_f32(xn, t[3]) + t[4]).to(xn.dtype)
    q, k, v = (ck._split_heads(c.view(b, spq, -1), h)
               for c in qkv.chunk(3, dim=-1))
    return xn, qkv, q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BWD_CASES)
def test_core_backward_decomposition_matches_vitax(case, dtype):
    b, spq, seq, d, h, hd = case
    args, do = _qkvo(case, seed=spq)
    _, refs = _vitax_flash(_typed(args, dtype, "jax")[:7],
                           _typed(args + (do,), dtype, "jax")[7], seq, h, hd)
    t = _typed(args + (do,), dtype, "torch")
    xn, _, q, k, v = _core_operands(t, case)
    dattn = matmul_f32(t[7].reshape(-1, d), t[5].t()).to(xn.dtype)
    d_o = ck._split_heads(dattn.view(b, spq, -1), h)
    _, dq, dk, dv = core_bwd_decomposed(q, k, v, d_o, seq)
    dqkv = torch.cat([ck._heads_to_rows(g) for g in (dq, dk, dv)], dim=1)
    # vitax's dqkv, read back from its dWqkv = xnᵀ·dqkv
    ref, *_ = np.linalg.lstsq(xn.double().numpy().T,
                              np.asarray(refs[3], np.float64), rcond=None)
    _close(dqkv.float(), ref, GRAD_TOL[dtype], "dqkv")
    assert not dk[..., seq:, :].any() and not dv[..., seq:, :].any()


# ------------------------------------------------------------------- (c)

def k6_fwd_composed(t, seq, h):
    """K6's forward in its launch order (ln_qkvo_attention_flash.cu)."""
    x = t[0]
    b, spq, d = x.shape
    xn = layer_norm_ref(x, t[1], t[2], EPS).reshape(-1, d)
    qkv = ck.gemm_sm90_ref("nn_bias", xn, t[3], t[4])
    q, k, v = (ck._split_heads(c.view(b, spq, -1), h)
               for c in qkv.chunk(3, dim=-1))
    out, _, _ = ck.flash_online_core_ref(q, k, v, seq)
    attn = ck._heads_to_rows(out.to(BF))
    return ck.gemm_sm90_ref("nn_bias", attn, t[5], t[6]).view(x.shape)


def k6_bwd_composed(t, do, seq, h):
    """K6's backward in its launch order (ln_qkvo_attention_flash_bwd.cu):
    (dx, dγ, dβ, dWqkv, dbqkv, dWo, dbo)."""
    x, gamma, beta, wqkv, bqkv, wo = t[:6]
    b, spq, d = x.shape
    dob = do.reshape(-1, d)
    xhat, rstd = ck._ln_stats(x.reshape(-1, d).float(), EPS)
    xn = layer_norm_ref(x, gamma, beta, EPS).reshape(-1, d)
    qkv = ck.gemm_sm90_ref("nn_bias", xn, wqkv, bqkv)
    dattn = ck.gemm_sm90_ref("nt_store", dob, wo)
    q, k, v = (ck._split_heads(c.view(b, spq, -1), h)
               for c in qkv.chunk(3, dim=-1))
    out, dq, dk, dv = core_bwd_decomposed(
        q, k, v, ck._split_heads(dattn.view(b, spq, -1), h), seq)
    attn = ck._heads_to_rows(out.to(BF))
    dwo = ck.gemm_sm90_ref("tn_f32", attn, dob)
    dbo = dob.float().sum(dim=0)
    dqkv = torch.cat([ck._heads_to_rows(g) for g in (dq, dk, dv)], dim=1)
    dxn = ck.gemm_sm90_ref("nt_f32", dqkv, wqkv)
    dwqkv = ck.gemm_sm90_ref("tn_f32", xn, dqkv)
    dbqkv = dqkv.float().sum(dim=0)
    dx, dg, dbe = ck._ln_bwd_tail(dxn, xhat, rstd, gamma)
    return dx.to(BF).view(x.shape), dg, dbe, dwqkv, dbqkv, dwo, dbo


@pytest.mark.parametrize("case", [(2, 24, 21, 128, 4, 32),
                                  (1, 136, 100, 256, 2, 80)])
def test_k6_composed_matches_twins_and_vitax(case):
    b, spq, seq, d, h, hd = case
    args, do = _qkvo(case, seed=3 * spq)
    t = _typed(args + (do,), "bfloat16", "torch")
    ref_out, refs = _vitax_flash(_typed(args, "bfloat16", "jax")[:7],
                                 _typed(args + (do,), "bfloat16", "jax")[7],
                                 seq, h, hd)
    out = k6_fwd_composed(t, seq, h)
    assert out.dtype == BF and out.shape == (b, spq, d)
    _close(out.float(), ck.fused_ln_qkvo_attention_flash_ref(
        *t[:7], EPS, seq, h, hd).float(), TOL["bfloat16"], "out vs twin")
    _close(out.float(), np.asarray(ref_out, np.float32), TOL["bfloat16"],
           "out vs vitax")
    grads = k6_bwd_composed(t, t[7], seq, h)
    twins = ck.fused_ln_qkvo_attention_flash_bwd_ref(*t[:6], t[7], EPS, seq,
                                                     h, hd)
    names = ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwo", "dbo")
    for name, g, twin, ref in zip(names, grads, twins, refs):
        assert g.dtype == twin.dtype and g.shape == twin.shape, name
        _close(g.float(), twin.float(), GRAD_TOL["bfloat16"], f"{name} twin")
        _close(g.float(), np.asarray(ref, np.float32), GRAD_TOL["bfloat16"],
               f"{name} vitax")
