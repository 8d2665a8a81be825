"""The plain twins of the Hopper kernels (vitax_torch/ops/cuda_kernels.py)
against vitax's Pallas kernels run in interpret mode. The Hopper kernels
themselves are held against these twins on the card by
tests/test_torch_cuda_kernels.py (no jax there) and chip_smoke.py.

Small shapes that pass both packages' gates: D 128, H 2 (head_dim 64),
M 256, spq 16 with seq_len 10 (the padded stream), batch 1 and 3; LN also
at D 768 and 1280 on 513 and 1100 rows (past vitax's 512-row blocks).
Tolerances: fp32 1e-4; bf16 2e-2 (ulp 2^-8, same rounding points, sums in
another order).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402

D, H, HD, M, SPQ, SEQ, EPS = 128, 2, 64, 256, 16, 10, 1e-5
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _weights(seed):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(gamma=1 + n(D, scale=0.1), beta=n(D, scale=0.1),
                wqkv=n(D, 3 * H * HD, scale=D ** -0.5),
                bqkv=n(3 * H * HD, scale=0.1),
                wo=n(H * HD, D, scale=(H * HD) ** -0.5), bo=n(D, scale=0.1),
                w1=n(D, M, scale=D ** -0.5), b1=n(M, scale=0.1),
                w2=n(M, D, scale=M ** -0.5), b2=n(D, scale=0.1))


# matrices and activations go in the compute dtype, vectors stay fp32
_MATS = ("x", "wqkv", "wo", "w1", "w2")


def _both(arrays, dtype):
    j = {k: jnp.asarray(v, getattr(jnp, dtype) if k in _MATS else jnp.float32)
         for k, v in arrays.items()}
    t = {k: torch.from_numpy(v).to(getattr(torch, dtype) if k in _MATS
                                   else torch.float32)
         for k, v in arrays.items()}
    return j, t


def _close(j, t, dtype):
    np.testing.assert_allclose(np.asarray(j.astype(jnp.float32)),
                               t.float().numpy(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def _x(batch, rows, seed):
    rng = np.random.default_rng(100 + seed)
    return (rng.standard_normal((batch, rows, D)) * 1.5 + 0.3).astype(
        np.float32)


def _ln_wide(batch, rows, d, seed):
    """x [batch, rows, d] and fp32 γ, β [d] at a ViT width."""
    rng = np.random.default_rng(300 + seed)
    n = rng.standard_normal
    return dict(x=(n((batch, rows, d)) * 1.5 + 0.3).astype(np.float32),
                gamma=(1 + 0.1 * n(d)).astype(np.float32),
                beta=(0.1 * n(d)).astype(np.float32))


# ViT-B's and ViT-H's widths on row counts that cross vitax's 512-row LN
# blocks (_LN_BLOCK_ROWS), the last one ragged; vitax runs under jax.jit
LN_WIDE = [pytest.param(1, 513, 768, id="513x768"),
           pytest.param(2, 550, 1280, id="1100x1280")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,rows,d", [pytest.param(1, SPQ, D, id="1"),
                                          pytest.param(3, SPQ, D, id="3"),
                                          *LN_WIDE])
def test_layer_norm_ref_matches_pallas(dtype, batch, rows, d):
    if d == D:
        arr = dict(_weights(0), x=_x(batch, rows, 0))
        ln = pk.layer_norm
    else:
        arr = _ln_wide(batch, rows, d, 0)
        ln = jax.jit(pk.layer_norm, static_argnums=3)
    j, t = _both(arr, dtype)
    ref = ln(j["x"], j["gamma"], j["beta"], EPS)
    _close(ref, ck.layer_norm_ref(t["x"], t["gamma"], t["beta"], EPS), dtype)
    _close(ref, ck.layer_norm(t["x"], t["gamma"], t["beta"], EPS), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3])
def test_fused_ln_qkvo_attention_ref_matches_pallas(dtype, batch):
    arr = dict(_weights(1), x=_x(batch, SPQ, 1))  # pad rows hold garbage
    j, t = _both(arr, dtype)
    args = ("x", "gamma", "beta", "wqkv", "bqkv", "wo", "bo")
    ref = pk.fused_ln_qkvo_attention(*(j[k] for k in args), EPS, SEQ, H, HD)
    out = ck.fused_ln_qkvo_attention_ref(*(t[k] for k in args), EPS, SEQ, H,
                                         HD)
    assert out.shape == (batch, SPQ, D) and out.dtype == t["x"].dtype
    _close(ref, out, dtype)
    _close(ref, ck.fused_ln_qkvo_attention(*(t[k] for k in args), EPS, SEQ,
                                           H, HD), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,rows", [(1, SPQ), (3, SPQ), (3, SEQ)])
def test_fused_ln_mlp_ref_matches_pallas(dtype, batch, rows):
    arr = dict(_weights(2), x=_x(batch, rows, 2))
    j, t = _both(arr, dtype)
    args = ("x", "gamma", "beta", "w1", "b1", "w2", "b2")
    ref = pk.fused_ln_mlp(*(j[k] for k in args), EPS)
    out = ck.fused_ln_mlp_ref(*(t[k] for k in args), EPS)
    assert out.shape == (batch, rows, D) and out.dtype == t["x"].dtype
    _close(ref, out, dtype)
    _close(ref, ck.fused_ln_mlp(*(t[k] for k in args), EPS), dtype)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    ck.reset_launch_counts()
    _, t = _both(dict(_weights(3), x=_x(2, SPQ, 3)), "float32")
    ck.layer_norm(t["x"], t["gamma"], t["beta"], EPS)
    ck.fused_ln_mlp(t["x"], t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"],
                    t["b2"], EPS)
    ck.fused_ln_qkvo_attention(t["x"], t["gamma"], t["beta"], t["wqkv"],
                               t["bqkv"], t["wo"], t["bo"], EPS, SEQ, H, HD)
    ck.layer_norm_bwd(t["x"], t["gamma"], t["x"], EPS)
    ck.fused_ln_mlp_bwd(t["x"], t["gamma"], t["beta"], t["w1"], t["b1"],
                        t["w2"], t["x"], EPS)
    ck.fused_ln_qkvo_attention_bwd(t["x"], t["gamma"], t["beta"], t["wqkv"],
                                   t["bqkv"], t["wo"], t["x"], EPS, SEQ, H,
                                   HD)
    mlp = (t["x"], t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"])
    qkvo = (t["x"], t["gamma"], t["beta"], t["wqkv"], t["bqkv"], t["wo"])
    ck.fused_ln_mlp_int8(*mlp, t["b2"], EPS)
    ck.fused_ln_mlp_int8_bwd(*mlp, t["x"], EPS)
    ck.fused_ln_qkvo_attention_int8(*qkvo, t["bo"], EPS, SEQ, H, HD)
    ck.fused_ln_qkvo_attention_int8_bwd(*qkvo, t["x"], EPS, SEQ, H, HD)
    ck.fused_ln_mlp_int8_dw_bwd(*mlp, t["x"], EPS)
    ck.fused_ln_qkvo_attention_int8_dw_bwd(*qkvo, t["x"], EPS, SEQ, H, HD)
    ln = (t["gamma"], t["beta"])
    r1, xq, sx = ck.fused_ln_qkvo_attention_int8_ho(
        t["x"], None, None, *ln, *ln, t["wqkv"], t["bqkv"], t["wo"], t["bo"],
        EPS, SEQ, H, HD)
    ck.fused_ln_mlp_int8_ho(r1, xq, sx, *ln, t["w1"], t["b1"], t["w2"],
                            t["b2"], EPS)
    xc = t["x"][:, :8].contiguous()
    for rect in (ck.fused_ln_qkvo_attention_rect,
                 ck.fused_ln_qkvo_attention_rect_int8):
        rect(xc, t["x"], t["gamma"], t["beta"], t["wqkv"], t["bqkv"],
             t["wo"], t["bo"], EPS, SEQ, H, HD)
        ck.fused_ln_qkvo_attention_rect_bwd(xc, t["x"], t["gamma"], t["beta"],
                                            t["wqkv"], t["bqkv"], t["wo"], xc,
                                            EPS, SEQ, H, HD)
    for bwd in (ck.fused_ln_qkvo_attention_rect_int8_bwd,
                ck.fused_ln_qkvo_attention_rect_int8_dw_bwd):
        bwd(xc, t["x"], t["gamma"], t["beta"], t["wqkv"], t["bqkv"], t["wo"],
            xc, EPS, SEQ, H, HD)
    g = _gqa_weights(3, 2, 1, HD)
    gqa = (t["x"], t["gamma"], t["beta"], torch.from_numpy(g["wqkv"]),
           torch.from_numpy(g["bqkv"]), t["wo"])
    ck.fused_ln_qkvo_attention(*gqa, t["bo"], EPS, SEQ, 2, HD, kv_heads=1)
    ck.fused_ln_qkvo_attention_bwd(*gqa, t["x"], EPS, SEQ, 2, HD, kv_heads=1)
    ck.fused_ln_qkvo_attention_flash(*qkvo, t["bo"], EPS, SEQ, H, HD)
    ck.fused_ln_qkvo_attention_flash_bwd(*qkvo, t["x"], EPS, SEQ, H, HD)
    ck.fused_ln_mlp_bwd_wide(*mlp, t["x"], EPS)
    ck.fused_ln_qkvo_attention_int8(*gqa, t["bo"], EPS, SEQ, 2, HD,
                                    kv_heads=1)
    ck.fused_ln_qkvo_attention_int8_bwd(*gqa, t["x"], EPS, SEQ, 2, HD,
                                        kv_heads=1)
    ck.fused_ln_qkvo_attention_int8_dw_bwd(*gqa, t["x"], EPS, SEQ, 2, HD,
                                           kv_heads=1)
    q = t["x"].view(t["x"].shape[0], SPQ, 2, -1).transpose(1, 2)
    out = ck.flash_attention_bhsd(q, q, q)
    ck.flash_attention(q, q, q)
    ck.flash_attention_bwd(q, q, q, out, q)
    _, h1, gp = ck.fused_ln_mlp_save(*mlp, t["b2"], EPS)
    ck.fused_ln_mlp_bwd_fast(*mlp[:4], t["w2"], h1, gp, t["x"], EPS)
    _, *codes = ck.fused_ln_mlp_int8_save(*mlp, t["b2"], EPS)
    ck.fused_ln_mlp_int8_save_bwd(*mlp[:4], t["w2"], *codes, t["x"], EPS)
    ck.fused_ln_mlp_int8_save_dw_bwd(*mlp[:4], t["w2"], *codes, t["x"], EPS)
    ck.fused_ln_mlp_int4(*mlp, t["b2"], EPS)
    ck.fused_ln_mlp_int4_bwd(*mlp, t["x"], EPS)
    ck.fused_ln_mlp_int4_dw_bwd(*mlp, t["x"], EPS)
    ck.fused_ln_qkvo_attention_int4(*qkvo, t["bo"], EPS, SEQ, H, HD)
    ck.fused_ln_qkvo_attention_int4_bwd(*qkvo, t["x"], EPS, SEQ, H, HD)
    ck.fused_ln_qkvo_attention_int4_dw_bwd(*qkvo, t["x"], EPS, SEQ, H, HD)
    rect = (xc, t["x"], t["gamma"], t["beta"], t["wqkv"], t["bqkv"], t["wo"])
    ck.fused_ln_qkvo_attention_rect_int4(*rect, t["bo"], EPS, SEQ, H, HD)
    ck.fused_ln_qkvo_attention_rect_int4_bwd(*rect, xc, EPS, SEQ, H, HD)
    ck.fused_ln_qkvo_attention_rect_int4_dw_bwd(*rect, xc, EPS, SEQ, H, HD)
    ck.fused_ln_qkvo_attention_int4(*gqa, t["bo"], EPS, SEQ, 2, HD,
                                    kv_heads=1)
    ck.fused_ln_qkvo_attention_int4_bwd(*gqa, t["x"], EPS, SEQ, 2, HD,
                                        kv_heads=1)
    ck.fused_ln_qkvo_attention_int4_dw_bwd(*gqa, t["x"], EPS, SEQ, 2, HD,
                                           kv_heads=1)
    ck.fused_qkv_attention(t["x"], t["wqkv"], t["bqkv"], SEQ, H, HD)
    ck.fused_qkv_attention_bwd(t["x"], t["wqkv"], t["bqkv"],
                               t["x"][..., :H * HD], SEQ, H, HD)
    ck.fused_qkvo_attention(t["x"], t["wqkv"], t["bqkv"], t["wo"], t["bo"],
                            SEQ, H, HD)
    ck.fused_qkvo_attention_bwd(t["x"], t["wqkv"], t["bqkv"], t["wo"],
                                t["x"], SEQ, H, HD)
    ck.fused_ln_mlp(*mlp, t["b2"], EPS, residual=False)
    ck.fused_ln_mlp_bwd(*mlp, t["x"], EPS, residual=False)
    for fwd in (ck.fused_ln_mlp_int8, ck.fused_ln_mlp_int4):
        fwd(*mlp, t["b2"], EPS, residual=False)
    for bwd in (ck.fused_ln_mlp_int8_bwd, ck.fused_ln_mlp_int8_dw_bwd,
                ck.fused_ln_mlp_int4_bwd, ck.fused_ln_mlp_int4_dw_bwd,
                ck.fused_ln_mlp_bwd_wide):
        bwd(*mlp, t["x"], EPS, residual=False)
    _, h1, gp = ck.fused_ln_mlp_save(*mlp, t["b2"], EPS, residual=False)
    ck.fused_ln_mlp_bwd_fast(*mlp[:4], t["w2"], h1, gp, t["x"], EPS,
                             residual=False)
    _, *codes = ck.fused_ln_mlp_int8_save(*mlp, t["b2"], EPS, residual=False)
    for bwd in (ck.fused_ln_mlp_int8_save_bwd,
                ck.fused_ln_mlp_int8_save_dw_bwd):
        bwd(*mlp[:4], t["w2"], *codes, t["x"], EPS, residual=False)
    assert ck.launch_counts() == {"layer_norm": 0,
                                  "fused_ln_qkvo_attention": 0,
                                  "fused_ln_mlp": 0, "layer_norm_bwd": 0,
                                  "fused_ln_qkvo_attention_bwd": 0,
                                  "fused_ln_mlp_bwd": 0,
                                  "fused_ln_qkvo_attention_int8": 0,
                                  "fused_ln_mlp_int8": 0,
                                  "fused_ln_qkvo_attention_int8_bwd": 0,
                                  "fused_ln_mlp_int8_bwd": 0,
                                  "fused_ln_qkvo_attention_int8_ho": 0,
                                  "fused_ln_mlp_int8_ho": 0,
                                  "fused_ln_qkvo_attention_int8_dw_bwd": 0,
                                  "fused_ln_mlp_int8_dw_bwd": 0,
                                  "fused_ln_qkvo_attention_gqa": 0,
                                  "fused_ln_qkvo_attention_rect": 0,
                                  "fused_ln_qkvo_attention_rect_int8": 0,
                                  "fused_ln_qkvo_attention_rect_bwd": 0,
                                  "fused_ln_qkvo_attention_rect_int8_bwd": 0,
                                  "fused_ln_qkvo_attention_rect_int8_dw_bwd":
                                  0, "fused_ln_qkvo_attention_gqa_bwd": 0,
                                  "fused_ln_qkvo_attention_flash": 0,
                                  "fused_ln_qkvo_attention_flash_bwd": 0,
                                  "fused_ln_mlp_bwd_wide": 0,
                                  "flash_attention": 0,
                                  "flash_attention_bwd": 0,
                                  "fused_ln_qkvo_attention_int8_gqa": 0,
                                  "fused_ln_qkvo_attention_int8_gqa_bwd": 0,
                                  "fused_ln_qkvo_attention_int8_gqa_dw_bwd":
                                  0, "fused_ln_mlp_save": 0,
                                  "fused_ln_mlp_bwd_fast": 0,
                                  "fused_ln_mlp_int8_save": 0,
                                  "fused_ln_mlp_int8_save_bwd": 0,
                                  "fused_ln_mlp_int8_save_dw_bwd": 0,
                                  "fused_ln_mlp_int4": 0,
                                  "fused_ln_mlp_int4_bwd": 0,
                                  "fused_ln_mlp_int4_dw_bwd": 0,
                                  "fused_ln_qkvo_attention_int4": 0,
                                  "fused_ln_qkvo_attention_int4_bwd": 0,
                                  "fused_ln_qkvo_attention_int4_dw_bwd": 0,
                                  "fused_ln_qkvo_attention_rect_int4": 0,
                                  "fused_ln_qkvo_attention_rect_int4_bwd": 0,
                                  "fused_ln_qkvo_attention_rect_int4_dw_bwd":
                                  0, "fused_ln_qkvo_attention_int4_gqa": 0,
                                  "fused_ln_qkvo_attention_int4_gqa_bwd": 0,
                                  "fused_ln_qkvo_attention_int4_gqa_dw_bwd":
                                  0, "fused_qkv_attention": 0,
                                  "fused_qkv_attention_bwd": 0,
                                  "fused_qkvo_attention": 0,
                                  "fused_qkvo_attention_bwd": 0,
                                  "fused_ln_mlp_partial": 0,
                                  "fused_ln_mlp_partial_bwd": 0,
                                  "fused_ln_mlp_int8_partial": 0,
                                  "fused_ln_mlp_int8_partial_bwd": 0,
                                  "fused_ln_mlp_int8_partial_dw_bwd": 0,
                                  "fused_ln_mlp_int4_partial": 0,
                                  "fused_ln_mlp_int4_partial_bwd": 0,
                                  "fused_ln_mlp_int4_partial_dw_bwd": 0,
                                  "fused_ln_mlp_save_partial": 0,
                                  "fused_ln_mlp_bwd_fast_partial": 0,
                                  "fused_ln_mlp_int8_save_partial": 0,
                                  "fused_ln_mlp_int8_save_partial_bwd": 0,
                                  "fused_ln_mlp_int8_save_partial_dw_bwd": 0,
                                  "fused_ln_mlp_bwd_wide_partial": 0}


def test_hopper_gates():
    def x(b, s, d):
        return torch.empty((b, s, d), device="meta")

    def w(*shape):
        return torch.empty(shape, device="meta")

    # ViT-B/16 at 224 (spq 200) and 384 (spq 584), and the test config
    assert ck.qkv_attention_supported(x(8, 197, 768), w(768, 2304), 12)
    assert ck.qkv_attention_supported(x(8, 577, 768), w(768, 2304), 12)
    assert ck.qkv_attention_supported(x(3, SEQ, D), w(D, 3 * H * HD), H)
    # the first design's whole-row core: scores + K/V past 227 KB of shared
    # memory; head_dim 80 (ViT-H/14). K13's core, which K1's family gates
    # on, takes both; S past 1024, a head dim off its instances, does not
    assert not ck._core_fits(x(1, 1024, 768), w(768, 2304), 12)
    assert not ck._core_fits(x(1, 257, 1280), w(1280, 3840), 16)
    assert ck.qkv_attention_supported(x(1, 1024, 768), w(768, 2304), 12)
    assert ck.qkv_attention_supported(x(1, 257, 1280), w(1280, 3840), 16)
    assert not ck.qkv_attention_supported(x(1, 1025, 768), w(768, 2304), 12)
    assert not ck.qkv_attention_supported(x(1, 197, 480), w(480, 1440), 12)
    assert ck.attention_smem_bytes(584, 64) <= ck.SMEM_LIMIT
    assert ck.ln_mlp_supported(x(8, 200, 768), w(768, 3072), w(3072, 768))
    assert not ck.ln_mlp_supported(x(8, 200, 768), w(768, 3000), w(3000, 768))
    assert not ck.ln_mlp_supported(x(8, 200, 768), w(768, 3072), w(768, 3072))
    assert ck.layernorm_supported(x(8, 197, 768))
    assert not ck.layernorm_supported(x(8, 197, 770))


# ------------------------------------------------------------- K7, K8

def _gqa_weights(seed, heads, kv_heads, head_dim):
    """wqkv [D, (H + 2·Hkv)·Hd] packed [q | k | v], its bias, wo."""
    rng = np.random.default_rng(seed)
    width = (heads + 2 * kv_heads) * head_dim
    hhd = heads * head_dim
    return dict(wqkv=(rng.standard_normal((D, width)) * D ** -0.5).astype(
                    np.float32),
                bqkv=(rng.standard_normal(width) * 0.1).astype(np.float32),
                wo=(rng.standard_normal((hhd, D)) * hhd ** -0.5).astype(
                    np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,kv_heads,head_dim", [(2, 1, 64), (4, 2, 32),
                                                     (4, 1, 32)])
def test_gqa_ref_matches_pallas(dtype, heads, kv_heads, head_dim):
    """K1's twin with kv_heads (K7's) against vitax's K1 with kv_heads: the
    packed [q | k | v] layout, query head h on kv group h·Hkv/H."""
    w = _weights(4)
    arr = dict(w, x=_x(3, SPQ, 4), **_gqa_weights(4, heads, kv_heads,
                                                   head_dim))
    j, t = _both(arr, dtype)
    args = ("x", "gamma", "beta", "wqkv", "bqkv", "wo", "bo")
    ref = pk.fused_ln_qkvo_attention(*(j[k] for k in args), EPS, SEQ, heads,
                                     head_dim, kv_heads=kv_heads)
    out = ck.fused_ln_qkvo_attention_ref(*(t[k] for k in args), EPS, SEQ,
                                         heads, head_dim, kv_heads)
    assert out.shape == t["x"].shape
    _close(ref, out, dtype)
    for f in (ck.fused_ln_qkvo_attention_gqa, ck.fused_ln_qkvo_attention_gqa_ref):
        torch.testing.assert_close(
            f(*(t[k] for k in args), EPS, SEQ, heads, head_dim, kv_heads),
            out, rtol=0, atol=0)
    torch.testing.assert_close(
        ck.fused_ln_qkvo_attention(*(t[k] for k in args), EPS, SEQ, heads,
                                   head_dim, kv_heads=kv_heads),
        out, rtol=0, atol=0)


def test_gqa_gate_rejects_uneven_kv_groups():
    """heads % kv_heads != 0 leaves query heads without an even kv group;
    vitax's gate accepts it (pallas_kernels.py:2189-2193), the port's
    rejects it."""
    x = torch.empty((2, SEQ, D), device="meta")
    ok, uneven = torch.empty((D, 8 * 32), device="meta"), \
        torch.empty((D, 10 * 32), device="meta")
    assert ck.qkv_attention_supported(x, ok, 4, 2)
    assert not ck.qkv_attention_supported(x, uneven, 4, 3)
    assert pk.qkv_attention_supported(jnp.zeros((2, SEQ, D)),
                                      jnp.zeros((D, 10 * 32)), 4, 3)
    # the MHA width is not a GQA width on K7's core (read as GQA it is Hd
    # 48, which K13's instances take and the whole-row core does not; the
    # wrappers also hold the width to their head_dim), and the reverse
    assert not ck._core_fits(x, torch.empty((D, 3 * 128), device="meta"), 4,
                             2)
    assert not ck.qkv_attention_supported(x, ok, 4)
    # K7's backward core takes the head width of the packed GQA layout
    assert ck._core_fits(x, ok, 4, 2, backward=True)
    assert not ck._core_fits(x, uneven, 4, 3, backward=True)
    assert ck._core_fits(x, torch.empty((D, 3 * 128), device="meta"), 4,
                         backward=True)
    # under autograd K7 runs its backward (K1's with kv_heads)
    tq = _both(dict(_weights(5), x=_x(1, SPQ, 5)), "float32")[1]
    xg = tq["x"].requires_grad_()
    y = ck.fused_ln_qkvo_attention_gqa(xg, tq["gamma"], tq["beta"],
                                       torch.zeros(D, 256), torch.zeros(256),
                                       tq["wo"], tq["bo"], EPS, SEQ, 2, HD, 1)
    assert type(y.grad_fn).__name__ == "FusedLnQkvoAttentionFnBackward"
    y.sum().backward()
    assert xg.grad.shape == xg.shape and torch.isfinite(xg.grad).all()


def _rect_inputs(batch, cap, seed):
    """x [B, spq, D] and xc: `cap` rows of each image (a random choice of
    its tokens, in random order) zero-padded to cpq = round_up(cap, 8), as
    compact_routed_block hands them to the kernel; and the row indices."""
    rng = np.random.default_rng(seed)
    x = _x(batch, SPQ, seed)
    idx = np.stack([rng.permutation(SEQ)[:cap] for _ in range(batch)])
    cpq = (cap + 7) // 8 * 8
    xc = np.zeros((batch, cpq, D), np.float32)
    xc[:, :cap] = np.take_along_axis(x, idx[..., None], axis=1)
    return x, xc, idx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,cap", [(1, 6), (3, 9)])
def test_fused_ln_qkvo_attention_rect_ref_matches_pallas(dtype, batch, cap):
    """K8's twin against vitax's rect kernel (seq_len 10 < spq 16, cpq 8 or
    16 with zero pad rows); its rows equal K1's twin's on the same tokens
    bit for bit."""
    x, xc, idx = _rect_inputs(batch, cap, 6)
    arr = dict(_weights(6), x=x)
    j, t = _both(arr, dtype)
    jxc, txc = jnp.asarray(xc, j["x"].dtype), torch.from_numpy(xc).to(
        t["x"].dtype)
    args = ("gamma", "beta", "wqkv", "bqkv", "wo", "bo")
    ref = pk.fused_ln_qkvo_attention_rect(jxc, j["x"], *(j[k] for k in args),
                                          EPS, SEQ, H, HD)
    out = ck.fused_ln_qkvo_attention_rect_ref(txc, t["x"],
                                              *(t[k] for k in args), EPS,
                                              SEQ, H, HD)
    assert out.shape == txc.shape and out.dtype == txc.dtype
    assert torch.isfinite(out).all()  # the zero pad rows too
    _close(ref[:, :cap], out[:, :cap], dtype)
    torch.testing.assert_close(
        ck.fused_ln_qkvo_attention_rect(txc, t["x"], *(t[k] for k in args),
                                        EPS, SEQ, H, HD), out, rtol=0, atol=0)
    square = ck.fused_ln_qkvo_attention_ref(t["x"], *(t[k] for k in args),
                                            EPS, SEQ, H, HD)
    gathered = torch.gather(square, 1, torch.from_numpy(idx)[..., None]
                            .expand(-1, -1, D))
    torch.testing.assert_close(out[:, :cap], gathered, rtol=0, atol=0)
    # under autograd K8 runs its backward kernel (here its twin)
    xg = txc.float().requires_grad_()
    y = ck.fused_ln_qkvo_attention_rect(xg, t["x"].float(),
                                        *(t[k].float() for k in args),
                                        EPS, SEQ, H, HD)
    assert type(y.grad_fn).__name__ == "FusedLnQkvoAttentionRectFnBackward"
    y.sum().backward()
    assert xg.grad.shape == xg.shape and torch.isfinite(xg.grad).all()


# ------------------------------------------------------- K7, K8 backward
# max|port - pallas| <= tol * max(1, max|pallas|) per output: fp32 1e-4 for
# dx and the vector grads, 1e-3 for the weight grads (sums over all rows);
# bf16 2e-2 (vitax casts the weight grads to the bf16 weights' dtype, the
# port's twins keep fp32, the Function casts)
BWD_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 2e-2)}
RECT_GRADS = ("dxc", "dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwo", "dbo")


def _check_grads(refs, outs, dtype, names, weights=("dwqkv", "dwo")):
    small, wide = BWD_TOL[dtype]
    assert len(refs) == len(outs) == len(names)
    for name, r, o in zip(names, refs, outs):
        r = np.asarray(jnp.asarray(r).astype(jnp.float32))
        o = o.float().numpy()
        assert o.shape == r.shape, name
        bound = (wide if name in weights else small) * max(
            1.0, float(np.abs(r).max()))
        err = float(np.abs(o - r).max())
        assert err <= bound, f"{name}: max error {err:.3e} > {bound:.3e}"


def rect_bwd_inputs(batch, spq, seq, cap, seed):
    """x [B, spq, D] (seq_len real rows), xc: `cap` of them gathered in
    random order and zero-padded to cpq = round_up(cap, 8), and do [B, cpq,
    D] zero on the pad rows (the caller's row cut), numpy fp32."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((batch, spq, D)) * 1.5 + 0.3).astype(np.float32)
    idx = np.stack([rng.permutation(seq)[:cap] for _ in range(batch)])
    cpq = (cap + 7) // 8 * 8
    xc = np.zeros((batch, cpq, D), np.float32)
    xc[:, :cap] = np.take_along_axis(x, idx[..., None], axis=1)
    do = rng.standard_normal((batch, cpq, D)).astype(np.float32)
    do[:, cap:] = 0
    return x, xc, do, idx


# (batch, spq, seq_len, cap): ragged seq_len 13 in spq 16 with cap 7 (cpq 8),
# at b 2 and 4 (vitax's grid tile 2 and 4), and cpq 16 < spq 24 at b 1
RECT_BWD_CASES = [(2, 16, 13, 7), (4, 16, 13, 7), (1, 24, 17, 11)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,spq,seq,cap", RECT_BWD_CASES)
def test_fused_ln_qkvo_attention_rect_bwd_ref_matches_pallas(dtype, batch,
                                                             spq, seq, cap):
    """K8's backward twin against vitax's rect VJP (bf16 tier) on every
    output; the wrapper on CPU tensors is the twin."""
    x, xc, do, _ = rect_bwd_inputs(batch, spq, seq, cap, 20 + batch)
    j, t = _both(dict(_weights(7), x=x, xc=xc, do=do), dtype)
    jm = lambda k: j[k].astype(j["x"].dtype)  # noqa: E731
    tm = lambda k: t[k].to(t["x"].dtype)  # noqa: E731
    keys = ("gamma", "beta", "wqkv", "bqkv", "wo")
    ref = pk._fused_ln_qkvo_rect_bwd(
        EPS, seq, H, HD, False, False, False, False, False,
        (jm("xc"), j["x"], *(j[k] for k in keys)), jm("do"))
    args = (tm("xc"), t["x"], *(t[k] for k in keys), tm("do"), EPS, seq, H,
            HD)
    out = ck.fused_ln_qkvo_attention_rect_bwd_ref(*args)
    assert out[0].dtype == out[1].dtype == t["x"].dtype
    assert all(o.dtype == torch.float32 for o in out[2:])
    _check_grads(ref, out, dtype, RECT_GRADS)
    for a, b in zip(out, ck.fused_ln_qkvo_attention_rect_bwd(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_rect_bwd_pad_rows_add_nothing():
    """xc's pad rows (zero cotangent) and x's pad rows past seq_len (masked
    keys) add exactly nothing to the weight and bias grads: filling them
    with other values leaves those grads unchanged."""
    x, xc, do, _ = rect_bwd_inputs(2, 16, 13, 7, 31)
    _, t = _both(dict(_weights(8), x=x, xc=xc, do=do), "float32")
    keys = ("gamma", "beta", "wqkv", "bqkv", "wo")
    base = ck.fused_ln_qkvo_attention_rect_bwd_ref(
        t["xc"], t["x"], *(t[k] for k in keys), t["do"], EPS, 13, H, HD)
    xc2, x2 = t["xc"].clone(), t["x"].clone()
    xc2[:, 7:] = 3.0
    x2[:, 13:] = -2.0
    other = ck.fused_ln_qkvo_attention_rect_bwd_ref(
        xc2, x2, *(t[k] for k in keys), t["do"], EPS, 13, H, HD)
    for name, a, b in zip(RECT_GRADS[4:], base[4:], other[4:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    assert torch.equal(other[0][:, 7:], torch.zeros_like(other[0][:, 7:]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,kv_heads", [(4, 2), (4, 1)])
@pytest.mark.parametrize("batch,seq_len", [(1, SEQ), (3, 13)])
def test_gqa_bwd_ref_matches_pallas(dtype, heads, kv_heads, batch, seq_len):
    """K7's backward twin (K1's with kv_heads) against vitax's VJP with
    kv_heads: dK and dV of a kv group one fp32 sum over its query heads;
    every output, dWqkv and dbqkv on the packed GQA width."""
    hd = 32
    rng = np.random.default_rng(40 + heads + kv_heads)
    arr = dict(_weights(9), x=_x(batch, SPQ, 9),
               do=rng.standard_normal((batch, SPQ, D)).astype(np.float32),
               **_gqa_weights(9, heads, kv_heads, hd))
    j, t = _both(arr, dtype)
    jdo, tdo = j["do"].astype(j["x"].dtype), t["do"].to(t["x"].dtype)
    keys = ("x", "gamma", "beta", "wqkv", "bqkv", "wo")
    ref = pk._fused_ln_qkvo_bwd(EPS, seq_len, heads, hd, False, False, False,
                                False, False, kv_heads,
                                tuple(j[k] for k in keys), jdo)
    args = (*(t[k] for k in keys), tdo, EPS, seq_len, heads, hd)
    out = ck.fused_ln_qkvo_attention_gqa_bwd_ref(*args, kv_heads)
    assert out[3].shape == (D, (heads + 2 * kv_heads) * hd)
    _check_grads(ref, out, dtype, ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv",
                                   "dwo", "dbo"))
    for a, b in zip(out, ck.fused_ln_qkvo_attention_bwd(*args,
                                                        kv_heads=kv_heads)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_gqa_function_matches_autograd_through_the_twin():
    """K7 under autograd (its Function, whose backward is K7's backward
    twin here) against autograd through K1's forward twin with kv_heads,
    fp32 within 1e-4 of each grad's scale."""
    heads, kv_heads, hd = 4, 2, 32
    arr = dict(_weights(10), x=_x(3, SPQ, 10),
               **_gqa_weights(10, heads, kv_heads, hd))
    _, t = _both(arr, "float32")
    keys = ("x", "gamma", "beta", "wqkv", "bqkv", "wo", "bo")
    a = [t[k].clone().requires_grad_() for k in keys]
    b = [t[k].clone().requires_grad_() for k in keys]
    ya = ck.fused_ln_qkvo_attention_gqa(*a, EPS, SEQ, heads, hd, kv_heads)
    yb = ck.fused_ln_qkvo_attention_ref(*b, EPS, SEQ, heads, hd, kv_heads)
    torch.testing.assert_close(ya, yb, rtol=0, atol=0)
    do = torch.from_numpy(np.random.default_rng(11).standard_normal(
        tuple(ya.shape)).astype(np.float32))
    ya.backward(do)
    yb.backward(do)
    for k, ta, tb in zip(keys, a, b):
        bound = 1e-4 * max(1.0, tb.grad.abs().max().item())
        assert (ta.grad - tb.grad).abs().max().item() <= bound, k
