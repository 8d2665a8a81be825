"""vitax_torch's Res-ViT training forward (models/resvit.py's train mode:
the Gumbel router, the teacher, the distill loss, compaction and token
dropping under autograd) against vitax's on the same weights, images,
Gumbel noise and kept tokens; tests/test_torch_resvit_train_steps.py holds
the train steps on the same setup.

vitax draws its train-time randomness from its step key: the kept tokens of
`token_keep` from a split of it, each block head's Gumbel noise from
fold_in(key, layer id). The tests draw the same numbers with jax.random and
hand them to the port (`noise=`), whose own draws come from a
torch.Generator. vitax's fused path runs its Pallas kernels (forward and
custom-VJP backward) in interpret mode; the port's CPU tensors take the
kernels' plain twins (K1, K7, K8 and their backwards, K2) under its autograd
Functions. Small config: tests/test_torch_resvit.py's (D 128, 2 heads of 64,
5 layers, block size 2, image 32 at patch 8: 17 tokens).
Tolerances, as max|port - vitax| <= tol * max(1, max|vitax|): fp32 1e-4 for
logits, losses and soft probabilities, 1e-3 for grads (sums over every row
and layer); bf16 2e-2; keep bits, path ids and routing maps exactly. After
AdamW steps the parameters within 2e-5 absolute at lr 1e-3 (an update is
lr·m/(√v + eps), whose sign follows the grad's, so a grad near 0 that the
two packages round apart moves its element by up to ~lr; the tests' grads
sit well away from 0); frozen leaves bit for bit.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from vitax.core import config as jconf  # noqa: E402
from vitax.models import resvit as jr  # noqa: E402
from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax.train import resvit_steps as jsteps  # noqa: E402
from vitax_torch.core import config as tconf  # noqa: E402
from vitax_torch.models import resvit as tr  # noqa: E402
from vitax_torch.train import resvit_steps as tsteps  # noqa: E402
from vitax_torch.train.optim import tree_leaves  # noqa: E402

TOL = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 2e-2)}
SMALL = dict(dim=128, mlp_dim=256, n_layers=5, n_heads=2, n_kv_heads=2,
             lora_rank=4, dynamic_start_layer=1, dynamic_router_hdim=32,
             dynamic_reserve_initials=2, low_rank_dim=8, block_size=2,
             use_lora=True, use_reslr=True, image_size=(32, 32),
             patch_size=(8, 8), num_classes=7, dropout=0.0,
             dynamic_active_target=0.4)
FUSED = dict(fused_qkv=True, fused_qkvo=True, fused_mlp=True,
             use_pallas=True)
PLAIN = dict(use_pallas=False)
# --no-fused-qkv with the kernels on: the LN kernel and K13 (twins here)
K13 = dict(use_pallas=True)
PATHS = {"plain": PLAIN, "fused": FUSED, "k13": K13}
LAMBDAS = dict(classification=1.0, active=10.0, distill=1.0)
INT8_GRAD = dict(int8_attn=True, int8_attn_grad=True, int8_mlp=True,
                 int8_mlp_grad=True)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


@pytest.fixture(autouse=True)
def vitax_path_ids_from_the_keep_bits(monkeypatch):
    """vitax packs its training path ids from the straight-through sum
    (one_hot + y_soft) - y_soft, whose kept bit is 1 - 2^-24 where 1 + y
    rounded down, and then truncates that bit away (ROADMAP Queue 3): which
    bits it loses depends on the last bit of y_soft, which two softmax
    implementations do not share. The port packs the keep bits themselves;
    vitax's side of these tests is repaired the same way, so they hold the
    port to vitax's routing and not to that fault."""
    orig = jr.router_forward

    def router_forward(x, p, cfg, *, train, rng):
        hard, _, entropy, soft = orig(x, p, cfg, train=train, rng=rng)
        keep = jnp.round(jax.lax.stop_gradient(hard[..., 1]))
        w = jnp.asarray(jr.path_id_weights(cfg.block_size), jnp.float32)
        ids = jnp.einsum("bnk,k->bn", keep, w).astype(jnp.int32)
        return hard, ids, entropy, soft

    monkeypatch.setattr(jr, "router_forward", router_forward)


def _cfgs(dtype="float32", **kw):
    kw = {**SMALL, **kw}
    j = jconf.ResViTConfig(**kw, dtype=getattr(jnp, dtype),
                           param_dtype=jnp.float32)
    t = tconf.ResViTConfig(**kw, dtype=getattr(torch, dtype),
                           param_dtype=torch.float32)
    return j, t


def _weights(jc, seed=0):
    """vitax's init, perturbed, with the routers' last layers redrawn so that
    routing is not all-keep (test_torch_resvit.py's)."""
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


def _batch(batch=4, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (batch, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 7, batch).astype(np.int32))


def vitax_noise(key, cfg, batch):
    """The randomness vitax's `apply(train=True, rng=key)` draws, as numpy:
    {"token_idx": the kept positions of drop_tokens (pins first), "gumbel":
    {block head's layer id: [B, N, bs, 2]}}."""
    n_tok = cfg.num_patches + 1
    noise = {}
    if cfg.token_keep < 1.0:
        key, tok = jax.random.split(key)
        n_pinned = max(1, min(max(1, cfg.dynamic_reserve_initials), n_tok))
        n = n_tok - n_pinned
        k = max(1, min(n, int(round(cfg.token_keep * n))))
        u = jax.random.uniform(tok, (batch, n))
        idx = jnp.sort(jnp.argsort(u, axis=1)[:, :k], axis=1) + n_pinned
        pins = jnp.broadcast_to(jnp.arange(n_pinned)[None], (batch, n_pinned))
        noise["token_idx"] = np.asarray(jnp.concatenate([pins, idx], 1))
        n_tok = n_pinned + k
    noise["gumbel"] = {
        lid: np.asarray(jax.random.gumbel(jax.random.fold_in(key, lid),
                                          (batch, n_tok, cfg.block_size, 2),
                                          jnp.float32))
        for lid, role in enumerate(jr.layer_roles(cfg))
        if role.get("is_block_head")}
    return noise


def _torch_noise(noise):
    out = {"gumbel": {k: torch.tensor(v) for k, v in noise["gumbel"].items()}}
    if "token_idx" in noise:
        out["token_idx"] = torch.tensor(noise["token_idx"])
    return out


def _close(ref, out, tol, what):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    out = out.detach().float().numpy() if torch.is_tensor(out) else \
        np.asarray(out, np.float32)
    assert out.shape == ref.shape, what
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max()) if ref.size else 0.0
    assert err <= bound, f"{what}: max error {err:.3e} > {bound:.3e}"


def _paths(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _trainable_paths(jc, jp):
    mask = jr.trainable_mask(jp, jc)
    return {jax.tree_util.keystr(p) for p, m in _paths(mask) if m}


def _as_numpy(tree):
    return jax.tree.map(lambda t: t.detach().float().numpy(), tree)


# ---------------------------------------------------------------- router

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_size", [2, 4])
def test_router_forward_train_matches_vitax(dtype, block_size):
    """Gumbel straight-through with vitax's noise for fold_in(key, lid):
    hard, soft, path ids and entropy; and the grads of the soft and
    straight-through outputs (vs x and every router leaf)."""
    jc, tc = _cfgs(dtype, block_size=block_size)
    w = _weights(jc, seed=block_size)
    lp = w["layers"][1]["router"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 17, 128)).astype(np.float32)
    r_soft = rng.standard_normal((3, 17, block_size, 2)).astype(np.float32)
    r_hard = rng.standard_normal((3, 17, block_size, 2)).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(3), 1)
    gumbel = jax.random.gumbel(key, (3, 17, block_size, 2), jnp.float32)

    def j_fn(x, p):
        hard, pid, ent, soft = jr.router_forward(x, p, jc, train=True,
                                                 rng=key)
        return (jnp.sum(soft * r_soft) + jnp.sum(hard * r_hard),
                (hard, pid, ent, soft))

    (_, (hard, pid, ent, soft)), (jgx, jgp) = jax.value_and_grad(
        j_fn, argnums=(0, 1), has_aux=True)(
            jnp.asarray(x, jc.dtype), jax.tree.map(jnp.asarray, lp))
    tx = torch.from_numpy(x).to(tc.dtype).requires_grad_()
    tp = tr.params_from_jax(lp)
    for t in tree_leaves(tp):
        t.requires_grad_()
    th, tpid, tent, tsoft, trows = tr.router_forward(
        tx, tp, tc, train=True, gumbel=torch.tensor(np.asarray(gumbel)))
    ((tsoft * torch.from_numpy(r_soft)).sum()
     + (th * torch.from_numpy(r_hard)).sum()).backward()
    small, wide = TOL[dtype]
    np.testing.assert_array_equal(th.detach().numpy().round(),
                                  np.asarray(hard).round())
    _close(hard, th, small, "hard")
    np.testing.assert_array_equal(tpid.numpy(), np.asarray(pid))
    _close(soft, tsoft, small, "soft")
    _close(ent, tent, small, "entropy")
    torch.testing.assert_close(trows.mean(), tent, rtol=1e-5, atol=1e-6)
    _close(jgx, tx.grad, wide, "dx")
    for (path, g), t in zip(_paths(jgp), tree_leaves(tp)):
        _close(g, t.grad, wide, jax.tree_util.keystr(path))
    with pytest.raises(ValueError, match="Gumbel"):
        tr.router_forward(tx, tp, tc, train=True)


# ---------------------------------------------------------------- apply

# (dtype, path, overrides): dense and compacted on the plain and fused
# paths; the other routes (overflow, token drop, GQA, --no-fused-qkv,
# --save-acts) are tests/test_torch_resvit_train_apply.py's cases of the
# same check, a file of their own so that two workers share the cases
APPLY_CASES = [
    ("float32", "plain", {}),
    ("float32", "plain", dict(compact_capacity=0.625)),
    ("float32", "fused", {}),
    ("bfloat16", "fused", {}),
    ("float32", "fused", dict(compact_capacity=0.625)),
]


def _loss_parts(logits, labels, aux, cfg, xp):
    """λc·c + λa·a + λd·d in either package (xp: jnp or torch)."""
    if xp is jnp:
        c = jsteps.cross_entropy(logits, labels)
        a = jr.active_loss(aux["soft_probs"], cfg.dynamic_active_target,
                           cfg.dynamic_reserve_initials)
    else:
        c = tsteps.cross_entropy(logits, labels)
        a = tr.active_loss(aux["soft_probs"], cfg.dynamic_active_target,
                           cfg.dynamic_reserve_initials)
    return LAMBDAS["classification"] * c + LAMBDAS["active"] * a \
        + LAMBDAS["distill"] * aux["d_loss"]


@pytest.mark.parametrize("dtype,path,kw", APPLY_CASES)
def test_apply_train_matches_vitax(dtype, path, kw):
    """apply(train=True) with vitax's noise and kept tokens injected: the
    logits, the distill loss, the keep bits, the soft probabilities and the
    grads of the 3-term loss for every trainable leaf."""
    check_apply_train(dtype, path, kw)


def check_apply_train(dtype, path, kw):
    """`test_apply_train_matches_vitax`'s check of one case."""
    jc, tc = _cfgs(dtype, **PATHS[path], **kw)
    w = _weights(jc)
    img, labels = _batch()
    key = jax.random.PRNGKey(11)
    noise = vitax_noise(key, jc, 4)

    def j_loss(p):
        logits, aux = jr.apply(p, jnp.asarray(img, jc.dtype), jc, train=True,
                               rng=key)
        return _loss_parts(logits, jnp.asarray(labels), aux, jc, jnp), \
            (logits, aux)

    jp = jax.tree.map(jnp.asarray, w)
    (_, (jlogits, jaux)), jgrads = jax.value_and_grad(j_loss, has_aux=True)(
        jp)
    tp = tr.params_from_jax(w)
    mask = tree_leaves(tr.trainable_mask(tp, tc))
    for t, m in zip(tree_leaves(tp), mask):
        t.requires_grad_(m)
    logits, aux = tr.apply(tp, torch.from_numpy(img).to(tc.dtype), tc,
                           train=True, noise=_torch_noise(noise))
    _loss_parts(logits, torch.from_numpy(labels), aux, tc, torch).backward()
    small, wide = TOL[dtype]
    _close(jlogits, logits, small, "logits")
    _close(jaux["d_loss"], aux["d_loss"], small, "d_loss")
    assert float(aux["d_loss"].detach()) > 0
    np.testing.assert_array_equal(np.asarray(jaux["acts"]).round(),
                                  aux["acts"].detach().numpy().round())
    _close(jaux["acts"], aux["acts"], small, "acts")
    _close(jaux["soft_probs"], aux["soft_probs"], small, "soft_probs")
    for k, m in jaux["routing_maps"].items():
        _close(m, aux["routing_maps"][k], small, f"routing map {k}")
    trainable = _trainable_paths(jc, w)
    n = 0
    for (path, g), t in zip(_paths(jgrads), tree_leaves(tp)):
        name = jax.tree_util.keystr(path)
        if name in trainable:
            _close(g, t.grad, wide, name)
            n += 1
        else:
            assert t.grad is None, name
    assert n == len(trainable) > 0


def test_teacher_keeps_no_graph_and_distill_grad_reaches_the_student():
    """The teacher runs without autograd (vitax stops its gradient at the
    cls it reads): the distill loss alone gives grads to the student's
    trainable leaves, and a dense-routed block's distill term is 0."""
    jc, tc = _cfgs(**PLAIN)
    tp = tr.params_from_jax(_weights(jc))
    for t, m in zip(tree_leaves(tp), tree_leaves(tr.trainable_mask(tp, tc))):
        t.requires_grad_(m)
    img, _ = _batch()
    noise = _torch_noise(vitax_noise(jax.random.PRNGKey(2), jc, 4))
    _, aux = tr.apply(tp, torch.from_numpy(img), tc, train=True, noise=noise)
    aux["d_loss"].backward()
    lora = tp["layers"][2]["attention"]["lora_q"]["b"]["kernel"]
    assert lora.grad is not None and lora.grad.abs().max() > 0
    # all-keep noise: every routed token runs its blocks, so the student
    # equals the teacher and the distill loss is exactly 0
    keep = {k: torch.tensor([0.0, 1e4]).expand_as(v)
            for k, v in noise["gumbel"].items()}
    with torch.no_grad():
        _, aux = tr.apply(tp, torch.from_numpy(img), tc, train=True,
                          noise={"gumbel": keep})
    assert float(aux["d_loss"]) == 0.0


def test_train_mode_draws_from_the_generator():
    jc, tc = _cfgs(**PLAIN, token_keep=0.5)
    tp = tr.params_from_jax(_weights(jc))
    img = torch.from_numpy(_batch()[0])
    with torch.no_grad():
        a = tr.apply(tp, img, tc, train=True,
                     gen=torch.Generator().manual_seed(4))
        b = tr.apply(tp, img, tc, train=True,
                     gen=torch.Generator().manual_seed(4))
        c = tr.apply(tp, img, tc, train=True,
                     gen=torch.Generator().manual_seed(5))
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    assert not torch.equal(a[1]["acts"], c[1]["acts"])
    assert a[1]["acts"].shape[1] == 2 + 8  # 2 pinned + round(0.5 · 15)
    with pytest.raises(ValueError, match="generator"):
        tr.apply(tp, img, tc, train=True)
