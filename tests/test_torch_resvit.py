"""vitax_torch's Res-ViT (models/resvit.py, resvit_compact.py, resvit_utils.py
and ResViTConfig) against vitax's on the same weights and images.

vitax's parameters (perturbed with numpy noise, the routers' final layers
redrawn, biases from ±0.3, so routing is not all-keep) go through `params_from_jax`;
both packages run the same images in eval mode. The fused path on vitax's
side runs its Pallas kernels in interpret mode; on the port's side CPU
tensors take the kernels' plain twins (K1, K7, K8, K2 and their int8 tiers).
Small config: D 128, 2 heads of 64 (GQA: 1 kv head), MLP 256, image 32 at
patch 8 (17 tokens, spq 24), 5 layers, routers from layer 1.
Tolerances: fp32 1e-4 (compaction's rect path 1e-5), bf16 2e-2; routing
maps and keep bits exactly. The int8 tier at 2e-2 in fp32 too: the two
packages take the LN sums in another order, so a value on a .5 tie
quantizes one step apart (tests/test_torch_int8.py counts them), and one
moved code moves its image's logits by up to ~1e-2 (1.0e-2 measured here).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from vitax.core import config as jconf  # noqa: E402
from vitax.models import resvit as jr  # noqa: E402
from vitax.models import resvit_compact as jrc  # noqa: E402
from vitax.models import resvit_utils as jru  # noqa: E402
from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax_torch.core import config as tconf  # noqa: E402
from vitax_torch.core.prng import set_seed  # noqa: E402
from vitax_torch.models import resvit as tr  # noqa: E402
from vitax_torch.models import resvit_compact as trc  # noqa: E402
from vitax_torch.models import resvit_utils as tru  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
INT8_TOL = 2e-2
SMALL = dict(dim=128, mlp_dim=256, n_layers=5, n_heads=2, n_kv_heads=2,
             lora_rank=4, dynamic_start_layer=1, dynamic_router_hdim=32,
             dynamic_reserve_initials=2, low_rank_dim=8, block_size=2,
             use_lora=True, use_reslr=True, image_size=(32, 32),
             patch_size=(8, 8), num_classes=7, dropout=0.0)
FUSED = dict(fused_qkv=True, fused_qkvo=True, fused_mlp=True,
             use_pallas=True)
PLAIN = dict(use_pallas=False)
# --no-fused-qkv with the kernels on: the LN kernel and K13 (twins here)
K13 = dict(use_pallas=True)
PATHS = {"plain": PLAIN, "fused": FUSED, "k13": K13}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _cfgs(dtype="float32", **kw):
    kw = {**SMALL, **kw}
    j = jconf.ResViTConfig(**kw, dtype=getattr(jnp, dtype),
                           param_dtype=jnp.float32)
    t = tconf.ResViTConfig(**kw, dtype=getattr(torch, dtype),
                           param_dtype=torch.float32)
    return j, t


def _weights(jc, seed=0):
    p = jax.tree.map(np.asarray, jr.init_params(jax.random.PRNGKey(seed), jc))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        p)
    for lp in p["layers"]:
        if "router" in lp:
            out3 = lp["router"]["out3"]
            out3["bias"] = rng.uniform(-0.3, 0.3, out3["bias"].shape).astype(
                np.float32)
            out3["kernel"] = (0.5 * rng.standard_normal(
                out3["kernel"].shape)).astype(np.float32)
    return p


def _images(batch=3, seed=1):
    return np.random.default_rng(seed).uniform(
        -1, 1, (batch, 32, 32, 3)).astype(np.float32)


def _run_both(jc, tc, w, img, j_apply=None, t_apply=None):
    j_apply = j_apply or (lambda p, x, c: jr.apply(p, x, c, train=False))
    t_apply = t_apply or (lambda p, x, c: tr.apply(p, x, c))
    ref, jaux = j_apply(jax.tree.map(jnp.asarray, w),
                        jnp.asarray(img, jc.dtype), jc)
    with torch.inference_mode():
        out, taux = t_apply(tr.params_from_jax(w),
                            torch.from_numpy(img).to(tc.dtype), tc)
    return np.asarray(ref, np.float32), jaux, out.float().numpy(), taux


def _assert_routing_equal(jaux, taux):
    assert set(jaux["routing_maps"]) == set(taux["routing_maps"])
    for k, m in jaux["routing_maps"].items():
        np.testing.assert_array_equal(np.asarray(m),
                                      taux["routing_maps"][k].numpy())
    np.testing.assert_array_equal(np.asarray(jaux["acts"]),
                                  taux["acts"].numpy())


# ---------------------------------------------------------------- config

def _norm(v):
    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    if isinstance(v, type):
        return np.dtype(v).name
    return v


def _fields(cfg):
    return {f.name: _norm(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", sorted(jconf.ARCH_PRESETS))
def test_resvit_config_presets_equal_field_by_field(arch):
    for image_size, ncls, kw in ((224, 100, {}), (384, 10, dict(n_kv_heads=4,
                                                               block_size=4))):
        a = jconf.resvit_arch_config(arch, image_size, ncls, **kw)
        b = tconf.resvit_arch_config(arch, image_size, ncls, **kw)
        assert _fields(a) == _fields(b)
        for prop in ("grid", "num_patches", "seq_len", "head_dim"):
            assert getattr(a, prop) == getattr(b, prop)
    assert _fields(jconf.ResViTConfig()) == _fields(tconf.ResViTConfig())
    assert _fields(jconf.ResViTConfig().replace(block_size=4)) == _fields(
        tconf.ResViTConfig().replace(block_size=4))
    with pytest.raises(ValueError):
        tconf.resvit_arch_config("b8")
    with pytest.raises(ValueError):
        tconf.ResViTConfig(token_keep=1.5)


@pytest.mark.parametrize("block_size", [1, 2, 4])
def test_resvit_utils_tables_equal(block_size):
    assert tru.lra_path_ids(block_size) == jru.lra_path_ids(block_size)
    assert tru.path_id_weights(block_size) == jru.path_id_weights(block_size)
    assert tru.SUPPORTED_BLOCK_SIZES == jru.SUPPORTED_BLOCK_SIZES
    with pytest.raises(ValueError):
        tru.lra_path_ids(3)


# ---------------------------------------------------------------- params

@pytest.mark.parametrize("kw", [{}, dict(use_lora=False, block_size=4),
                                dict(n_kv_heads=1, use_reslr=False)])
def test_init_and_params_from_jax_keep_vitaxs_layout(kw):
    jc, tc = _cfgs(**kw)
    jp = jax.tree.map(np.asarray, jr.init_params(jax.random.PRNGKey(0), jc))
    tp = tr.init_params(set_seed(0), tc)
    j_leaves, j_def = jax.tree_util.tree_flatten_with_path(jp)
    t_from = tr.params_from_jax(jp)
    t_leaves = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), t_from))[0]
    own = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tp))[0]
    assert [p for p, _ in j_leaves] == [p for p, _ in t_leaves] \
        == [p for p, _ in own]
    for (_, a), (_, b), (_, c) in zip(j_leaves, t_leaves, own):
        np.testing.assert_array_equal(a, b)  # the round trip is exact
        assert a.shape == c.shape and c.dtype == np.float32
    for lid, role in enumerate(tr.layer_roles(tc)):
        if role.get("is_block_head"):
            np.testing.assert_array_equal(
                tp["layers"][lid]["router"]["out3"]["bias"].numpy(),
                np.tile([0.0, 5.0], tc.block_size))
    # vitax's pre-stacked scan layout loads, into the list layout
    stacked = tr.params_from_jax(jax.tree.map(np.asarray,
                                              jr.stack_params(jp, jc)))
    s_leaves = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), stacked))[0]
    assert [p for p, _ in s_leaves] == [p for p, _ in j_leaves]
    for (_, a), (_, b) in zip(j_leaves, s_leaves):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- router

@pytest.mark.parametrize("block_size", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_forward_eval_matches_vitax(block_size, dtype):
    jc, tc = _cfgs(dtype, block_size=block_size)
    w = _weights(jc, seed=block_size)
    lp = w["layers"][1]["router"]
    x = np.random.default_rng(5).standard_normal((3, 17, 128)).astype(
        np.float32)
    hard, pid, ent, soft = jr.router_forward(
        jnp.asarray(x, jc.dtype), jax.tree.map(jnp.asarray, lp), jc,
        train=False, rng=None)
    with torch.inference_mode():
        out = tr.router_forward(torch.from_numpy(x).to(tc.dtype),
                                tr.params_from_jax(lp), tc)
    th, tpid, tent, tsoft, trows = (t.numpy() for t in out)
    np.testing.assert_array_equal(np.asarray(hard), th)
    np.testing.assert_array_equal(np.asarray(pid), tpid)
    assert tpid.dtype == np.int32
    tol = 1e-5 if dtype == "float32" else TOL[dtype]
    np.testing.assert_allclose(tent, np.asarray(ent), rtol=tol, atol=tol)
    np.testing.assert_allclose(tsoft, np.asarray(soft), rtol=tol, atol=tol)
    # each row's share of the entropy sum: their mean is the entropy
    np.testing.assert_allclose(trows.mean(), tent, rtol=1e-5, atol=1e-6)
    # training mode needs its Gumbel noise (tests/test_torch_resvit_train.py
    # holds it against vitax's)
    with pytest.raises(ValueError, match="Gumbel"):
        tr.router_forward(torch.from_numpy(x), tr.params_from_jax(lp), tc,
                          train=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_approximators_matches_vitax(dtype):
    jc, tc = _cfgs(dtype, block_size=4)
    w = _weights(jc)
    ap = w["layers"][1]["approximators"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 17, 128)).astype(np.float32)
    pid = rng.integers(0, 16, (2, 17)).astype(np.int32)
    ids = [1, 2, 5, 9, 14]
    ref = jr.apply_approximators(jnp.asarray(x, jc.dtype),
                                 jax.tree.map(jnp.asarray, ap),
                                 jnp.asarray(pid), ids)
    out = tr.apply_approximators(torch.from_numpy(x).to(tc.dtype),
                                 tr.params_from_jax(ap),
                                 torch.from_numpy(pid), ids)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


# ---------------------------------------------------------------- apply

APPLY_CASES = [
    # (dtype, path, overrides)
    ("float32", "plain", {}),
    ("bfloat16", "plain", {}),
    ("float32", "plain", dict(use_lora=False)),
    ("float32", "plain", dict(use_reslr=False)),
    ("float32", "plain", dict(use_lora=False, block_size=1)),
    ("float32", "plain", dict(n_kv_heads=1)),
    ("float32", "fused", {}),
    ("bfloat16", "fused", {}),
    ("float32", "fused", dict(use_lora=False, use_reslr=False)),
    ("bfloat16", "fused", dict(block_size=4)),
    ("float32", "fused", dict(n_kv_heads=1)),
    ("bfloat16", "fused", dict(n_kv_heads=1, use_lora=False)),
    ("float32", "k13", {}),
    ("bfloat16", "k13", {}),
    ("float32", "k13", dict(n_kv_heads=1)),
]


@pytest.mark.parametrize("dtype,path,kw", APPLY_CASES)
def test_apply_eval_matches_vitax(dtype, path, kw):
    jc, tc = _cfgs(dtype, **PATHS[path], **kw)
    w = _weights(jc)
    ref, jaux, out, taux = _run_both(jc, tc, w, _images())
    assert out.shape == (3, 7)
    np.testing.assert_allclose(out, ref, rtol=TOL[dtype], atol=TOL[dtype])
    _assert_routing_equal(jaux, taux)
    np.testing.assert_allclose(float(taux["r_entropy"]),
                               float(jaux["r_entropy"]), rtol=1e-3)
    if tc.use_reslr:
        assert 0 < taux["acts"][:, 2:].mean() < 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity", [None, 0.625])
def test_int8_apply_matches_vitax(dtype, capacity):
    """The W8A8 tier (K3 on the plain layer, K8 int8 on the compacted rows,
    K4 for every MLP half), dense and compacted."""
    jc, tc = _cfgs(dtype, **FUSED, int8_attn=True, int8_mlp=True,
                   compact_capacity=capacity)
    w = _weights(jc)
    ref, jaux, out, taux = _run_both(jc, tc, w, _images())
    np.testing.assert_allclose(out, ref, rtol=INT8_TOL, atol=INT8_TOL)
    _assert_routing_equal(jaux, taux)


def test_apply_rejects_what_is_not_ported():
    jc, tc = _cfgs()
    w = tr.params_from_jax(_weights(jc))
    x = torch.from_numpy(_images(1))
    # training draws its randomness from a generator or takes it injected
    with pytest.raises(ValueError, match="generator or the noise"):
        tr.apply(w, x, tc, train=True)
    # fused_qkv without fused_qkvo runs K10 (its twin here) in every layer,
    # as vitax's `attention` (tests/test_torch_resvit_k10.py holds the rest)
    k10 = dict(fused_qkv=True, fused_qkvo=False)
    ref, jaux, out, taux = _run_both(
        dataclasses.replace(jc, **k10), tc.replace(**k10), _weights(jc),
        _images(1), j_apply=lambda p, x, c: jax.jit(
            lambda p_, x_: jr.apply(p_, x_, c, train=False))(p, x))
    np.testing.assert_allclose(out, ref, rtol=TOL["float32"],
                               atol=TOL["float32"])
    _assert_routing_equal(jaux, taux)
    # vitax's stacked layout runs the loop (its scan has the loop's math),
    # but not with compaction, as vitax's apply
    stacked = tr.stack_params(w, tc)
    with torch.inference_mode():
        torch.testing.assert_close(tr.apply(stacked, x, tc)[0],
                                   tr.apply(w, x, tc)[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="unrolled loop"):
        tr.apply(stacked, x, tc.replace(compact_capacity=0.5))
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        tr.apply(w, x, tc.replace(remat=True))


def test_apply_nchw_is_apply():
    jc, tc = _cfgs()
    w = tr.params_from_jax(_weights(jc))
    x = torch.from_numpy(_images(2))
    with torch.inference_mode():
        a, _ = tr.apply(w, x, tc)
        b, _ = tr.apply_nchw(w, x.permute(0, 3, 1, 2), tc)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_embed_slices_a_longer_position_table():
    """The reference's length-mismatch slice: a position table longer than
    the sequence adds its first N+1 rows (vitax's embed :658)."""
    jc, tc = _cfgs()
    w = _weights(jc)
    w["pos_embedding"] = np.random.default_rng(2).standard_normal(
        (1, 30, 128)).astype(np.float32)
    img = _images(2)
    ref = jr.embed(jax.tree.map(jnp.asarray, w), jnp.asarray(img), jc)
    out = tr.embed(tr.params_from_jax(w), torch.from_numpy(img), tc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------- compaction

@pytest.mark.parametrize("path", ["plain", "fused"])
def test_capacity_covering_the_actives_equals_dense_bit_for_bit(path):
    """Per-row math on gathered rows: with every active token inside the
    capacity (and the reserved ones first), the compacted forward is the
    dense one, bit for bit (fp32 and the plain twins on the CPU)."""
    _, tc = _cfgs(**PATHS[path])
    jc, _ = _cfgs()
    w = tr.params_from_jax(_weights(jc))
    x = torch.from_numpy(_images())
    with torch.inference_mode():
        dense, daux = tr.apply(w, x, tc)
        comp, caux = tr.apply(w, x, tc.replace(compact_capacity=1.0))
    torch.testing.assert_close(comp, dense, rtol=0, atol=0)
    torch.testing.assert_close(caux["acts"], daux["acts"], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["plain", "fused", "k13"])
@pytest.mark.parametrize("capacity,overflow",
                         [(0.625, True), (0.3, True), (0.3, False)])
def test_compact_apply_matches_vitax(dtype, path, capacity, overflow):
    """Capacity below the actives: overflow demotion (or identity) as
    vitax's, through its rect path on the fused side."""
    jc, tc = _cfgs(dtype, **PATHS[path],
                   compact_capacity=capacity,
                   compact_demote_overflow=overflow)
    w = _weights(jc)
    ref, jaux, out, taux = _run_both(jc, tc, w, _images())
    np.testing.assert_allclose(out, ref, rtol=TOL[dtype], atol=TOL[dtype])
    _assert_routing_equal(jaux, taux)


def test_overflow_demotion_matches_vitax(monkeypatch):
    """All-active routing at capacity 9 of 17: the overflow tokens take the
    approximator path in both packages (vitax's demotion semantics)."""
    jc, tc = _cfgs(block_size=1, dynamic_reserve_initials=1)
    w = _weights(jc)
    n = 17

    def j_router(x, p, cfg, *, train, rng):
        b = x.shape[0]
        keep = jnp.ones((b, n, 1), jnp.float32)
        hard = jnp.stack([1.0 - keep, keep], axis=-1)
        return hard, jnp.ones((b, n), jnp.int32), jnp.zeros(()), hard

    def t_router(x, p, cfg, train=False, gumbel=None):
        b = x.shape[0]
        keep = torch.ones((b, n, 1))
        hard = torch.stack([1.0 - keep, keep], dim=-1)
        return hard, torch.ones((b, n), dtype=torch.int32), \
            torch.zeros(()), hard, torch.zeros((b,))

    monkeypatch.setattr(jr, "router_forward", j_router)
    monkeypatch.setattr(tr, "router_forward", t_router)
    for c in (0.5, 1.0):
        ref, _, out, _ = _run_both(jc.replace(compact_capacity=c),
                                   tc.replace(compact_capacity=c), w,
                                   _images(2))
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    # the demoted forward differs from full capacity's
    half, _, _, _ = _run_both(jc.replace(compact_capacity=0.5),
                              tc.replace(compact_capacity=0.5), w, _images(2))
    full, _, _, _ = _run_both(jc, tc, w, _images(2))
    assert np.abs(half - full).max() > 1e-3


@pytest.mark.parametrize("kw", [{}, dict(use_lora=False)])
def test_rect_block_matches_vitaxs_rect_path(kw):
    """compact_routed_block through the rect half (K8's twin against vitax's
    K8 in interpret mode), fp32 1e-5, with an active set larger than the
    capacity and the confidence ranking."""
    jc, tc = _cfgs(**FUSED, **kw)
    w = _weights(jc)
    lp = w["layers"][2]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 17, 128)).astype(np.float32)
    active = rng.uniform(size=(3, 17)) < 0.7
    score = rng.uniform(size=(3, 17)).astype(np.float32)
    ref = jr.compact_routed_block(jnp.asarray(x), jax.tree.map(jnp.asarray,
                                                               lp), jc,
                                  jnp.asarray(active), 9,
                                  score=jnp.asarray(score))
    with torch.inference_mode():
        calls = []
        rect = tr._fused_attention_half_rect

        def spy(*a):
            out = rect(*a)
            calls.append(out is not None)
            return out
        tr._fused_attention_half_rect = spy
        try:
            out = tr.compact_routed_block(
                torch.from_numpy(x), tr.params_from_jax(lp), tc,
                torch.from_numpy(active), 9, torch.from_numpy(score))
        finally:
            tr._fused_attention_half_rect = rect
    assert calls == [True]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity", [0.4, 0.75])
@pytest.mark.parametrize("path", ["plain", "k13"])
def test_apply_compact_matches_vitax(dtype, capacity, path):
    """The reference-shaped legacy path (`--legacy-compact`, and
    `resvit_eval_cli --no-fused-qkv --compact-capacity`, whose plain layers
    take K13 with the kernels on)."""
    jc, tc = _cfgs(dtype, **PATHS[path])
    w = _weights(jc)
    ref, jaux, out, taux = _run_both(
        jc, tc, w, _images(),
        lambda p, x, c: jrc.apply_compact(p, x, c, capacity=capacity),
        lambda p, x, c: trc.apply_compact(p, x, c, capacity=capacity))
    np.testing.assert_allclose(out, ref, rtol=TOL[dtype], atol=TOL[dtype])
    _assert_routing_equal(jaux, taux)
    assert taux["capacity"] == jaux["capacity"]
    with pytest.raises(ValueError):
        trc.apply_compact(tr.params_from_jax(w), torch.zeros(1, 32, 32, 3),
                          tc.replace(use_reslr=False))
