"""The port's training slice against vitax's: the optimizer's LR and momentum
tables, the loss and accuracy functions, and three whole train steps of
`make_train_step` on the same numpy weights and batches (vitax's fused path
with its Pallas kernels in interpret mode; the port's fused path, whose
autograd Functions take the kernels' plain twins on CPU). The small config
of tests/test_torch_vit.py (image 48, patch 16: seq 10 → spq 16) engages the
padded stream. Tolerances: losses fp32 1e-4, params fp32 1e-3, grads fp32
1e-3·max(1, max|g|); everything 2e-2 in bf16.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from vitax.core.config import arch_config as j_arch  # noqa: E402
from vitax.models import vit as jvit  # noqa: E402
from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax.train import adamw as j_adamw  # noqa: E402
from vitax.train import (create_train_state as j_state,  # noqa: E402
                         cross_entropy as j_ce, make_eval_step as j_eval,
                         make_train_step as j_step, onecycle_lr as j_lr,
                         onecycle_momentum as j_mom, sgd_momentum as j_sgd,
                         topk_accuracy as j_topk)
from vitax.train import schedules as j_sched  # noqa: E402
from vitax_torch.core.config import arch_config as t_arch  # noqa: E402
from vitax_torch.models import vit as tvit  # noqa: E402
from vitax_torch.train import adamw as t_adamw  # noqa: E402
from vitax_torch.train import (create_train_state as t_state,  # noqa: E402
                               cross_entropy as t_ce, make_eval_step as t_eval,
                               make_train_step as t_step, param_leaves,
                               sgd_momentum as t_sgd, step_scheduler,
                               topk_accuracy as t_topk)
from vitax_torch.train import schedules as t_sched  # noqa: E402

SMALL = dict(emb_dim=128, mlp_dim=256, num_heads=2, num_layers=2)
LR, TOTAL, WARMUP, WD = 0.03, 10, 2, 1e-4


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _cfgs(dtype, fused=True, **kw):
    kw = dict(fused_qkv=fused, fused_mlp=fused, use_pallas=fused, **kw)
    jc = j_arch("tiny", 48, 10).replace(dtype=getattr(jnp, dtype), **SMALL,
                                         **kw)
    tc = t_arch("tiny", 48, 10).replace(dtype=getattr(torch, dtype), **SMALL,
                                         **kw)
    return jc, tc


@pytest.fixture(scope="module")
def weights():
    jc, _ = _cfgs("float32")
    p = jax.tree.map(np.asarray, jvit.init_params(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        p)


def _batches(n, batch=3):
    rng = np.random.default_rng(7)
    return [(rng.uniform(-1, 1, (batch, 48, 48, 3)).astype(np.float32),
             rng.integers(0, 10, batch).astype(np.int32)) for _ in range(n)]


def _vitax_layout(tree):
    """The port's parameter tree as numpy arrays in vitax's layout (layer
    leaves stacked)."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return t.detach().float().numpy()

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    layers = [conv(lp) for lp in tree["layers"]]
    out["layers"] = jax.tree.map(lambda *a: np.stack(a), *layers)
    return out


def _assert_trees_close(ref, out, tol, scaled):
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    out_leaves = dict(jax.tree_util.tree_flatten_with_path(out)[0])
    assert len(ref_leaves) == len(out_leaves)
    for path, r in ref_leaves:
        r = np.asarray(r, np.float32)
        o = out_leaves[path]
        if scaled:
            bound = tol * max(1.0, float(np.abs(r).max()))
            err = float(np.abs(o - r).max())
            assert err <= bound, (jax.tree_util.keystr(path), err, bound)
        else:
            np.testing.assert_allclose(o, r, rtol=tol, atol=tol,
                                       err_msg=jax.tree_util.keystr(path))


def test_sgd_onecycle_tables_match_vitax_schedules():
    p = {"w": torch.zeros(3)}
    opt, sched = t_sgd(p, 0.1, 50, 0.2)
    lr, mom = j_lr(0.1, 50, 0.2), j_mom(50, 0.2)
    for step in range(55):  # past total_steps: vitax holds min_lr
        group = opt.param_groups[0]
        assert abs(group["lr"] - float(lr(step))) <= 1e-6 * 0.1, step
        assert abs(group["momentum"] - float(mom(step))) <= 1e-6, step
        opt.step()
        step_scheduler(sched)


@pytest.mark.parametrize("warmup,total", [(1, 10), (12, 10)])
def test_onecycle_warmup_outside_torchs_domain_raises(warmup, total):
    """torch's OneCycleLR divides by zero with a 1-step warmup and rejects a
    warmup longer than the run, where vitax's closed form clamps; the port
    says so instead of failing inside torch."""
    with pytest.raises(ValueError, match="warmup"):
        t_sgd({"w": torch.zeros(2)}, 0.1, total, warmup / total)
    assert 0.0 <= float(j_lr(0.1, total, warmup / total)(0)) <= 0.1


def test_adamw_with_clip_matches_vitax():
    """AdamW + warmup-cosine LR + global-norm clip 1.0, 8 steps on a
    quadratic: the parameters track vitax's (fp32)."""
    w0 = np.random.default_rng(0).standard_normal((4, 3)).astype(np.float32)
    target = np.ones((4, 3), np.float32)
    lr = t_sched.cosine_with_warmup_lr(0.05, 2, 8)
    tx = j_adamw(j_sched.cosine_with_warmup_lr(0.05, 2, 8), weight_decay=0.05,
                 clip_grad_norm=1.0)
    jp = {"w": jnp.asarray(w0)}
    st = tx.init(jp)
    tp = {"w": torch.tensor(w0, requires_grad=True)}
    opt, sched = t_adamw(tp, lr, 0.05, weight_decay=0.05)
    for _ in range(8):
        g = jax.grad(lambda p: (3 * (p["w"] - target) ** 2).sum())(jp)
        upd, st = tx.update(g, st, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, upd)
        opt.zero_grad()
        (3 * (tp["w"] - torch.from_numpy(target)) ** 2).sum().backward()
        torch.nn.utils.clip_grad_norm_(param_leaves(tp), 1.0)
        opt.step()
        step_scheduler(sched)
    np.testing.assert_allclose(tp["w"].detach().numpy(), np.asarray(jp["w"]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,args", [
    ("onecycle_lr", (0.03, 40, 0.25)), ("onecycle_momentum", (40, 0.25)),
    ("cosine_with_warmup_lr", (1e-3, 5, 40)),
    ("cosine_annealing_lr", (1e-3, 40))])
def test_schedules_match_vitax(name, args):
    ref, out = getattr(j_sched, name)(*args), getattr(t_sched, name)(*args)
    for step in range(45):
        assert abs(out(step) - float(ref(step))) <= 1e-6 * max(
            1.0, abs(float(ref(step)))), (name, step)


def test_token_keep_switch_epoch_matches_vitax():
    for sched, keep, epochs in [(None, 1.0, 3), (0.5, 0.5, 4), (0.9, 0.5, 10),
                                (1.0, 0.5, 2)]:
        assert t_sched.token_keep_switch_epoch(sched, keep, epochs) == \
            j_sched.token_keep_switch_epoch(sched, keep, epochs)
    for bad in [(1.5, 0.5, 4), (0.5, 1.0, 4), (0.5, 0.5, 1)]:
        with pytest.raises(ValueError):
            t_sched.token_keep_switch_epoch(*bad)


def test_cross_entropy_and_topk_match_vitax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((16, 10)).astype(np.float32) * 3
    labels = rng.integers(0, 10, 16).astype(np.int32)
    ref_ce = float(j_ce(jnp.asarray(logits), jnp.asarray(labels)))
    out_ce = float(t_ce(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert abs(out_ce - ref_ce) <= 1e-5 * max(1.0, abs(ref_ce))
    ref = j_topk(jnp.asarray(logits), jnp.asarray(labels))
    out = t_topk(torch.from_numpy(logits), torch.from_numpy(labels))
    assert set(out) == set(ref) == {"acc1", "acc5"}
    for k in ref:
        assert float(out[k]) == pytest.approx(float(ref[k]), abs=1e-7)


def _run_both(weights, dtype, steps=3, **cfg_kw):
    """`steps` train steps of both packages from the same weights; returns
    (vitax losses, port losses, vitax step-1 grads, port step-1 grads,
    vitax params, port params), trees in vitax's layout."""
    jc, tc = _cfgs(dtype, **cfg_kw)
    batches = _batches(steps)
    pct = WARMUP / TOTAL
    tx = j_sgd(j_lr(LR, TOTAL, pct), momentum_schedule=j_mom(TOTAL, pct),
               weight_decay=WD)
    jp = jax.tree.map(jnp.asarray, weights)
    img0, lab0 = batches[0]
    rng = jax.random.PRNGKey(1)

    def loss_fn(p):
        logits = jvit.apply(p, jnp.asarray(img0, jc.dtype), jc, train=True,
                            rng=jax.random.fold_in(rng, 0))
        return j_ce(logits, jnp.asarray(lab0))

    j_grads = jax.tree.map(np.asarray, jax.grad(loss_fn)(jp))
    state = j_state(jp, tx, rng)
    step = j_step(jc, tx, donate=False)
    j_losses = []
    for img, lab in batches:
        state, m = step(state, jnp.asarray(img, jc.dtype), jnp.asarray(lab))
        j_losses.append(float(m["loss"]))
    j_params = jax.tree.map(np.asarray, state.params)

    params = tvit.params_from_jax(weights)
    opt, sched = t_sgd(params, LR, TOTAL, pct, weight_decay=WD)
    tstate = t_state(params, opt, sched, torch.Generator().manual_seed(1))
    tstep = t_step(tc, opt, sched)
    t_losses, t_grads = [], None
    for img, lab in batches:
        tstate, m = tstep(tstate, torch.from_numpy(img).to(tc.dtype),
                          torch.from_numpy(lab))
        t_losses.append(float(m["loss"]))
        if t_grads is None:
            grads = jax.tree.map(lambda p: p.grad, tstate.params)
            t_grads = _vitax_layout(grads)
    assert tstate.step == steps
    return (j_losses, t_losses, j_grads, t_grads, j_params,
            _vitax_layout(tstate.params))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_train_steps_match_vitax(weights, dtype):
    jl, tl, jg, tg, jp, tp = _run_both(weights, dtype)
    tol = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 2e-2)}[dtype]
    np.testing.assert_allclose(tl, jl, rtol=tol[0], atol=tol[0])
    _assert_trees_close(jg, tg, tol[1], scaled=True)
    _assert_trees_close(jp, tp, tol[1], scaled=False)


def test_three_train_steps_with_token_drop_match_vitax(weights, monkeypatch):
    """token_keep 0.5: 9 patch tokens keep round(4.5) = 4 plus cls; both
    packages get the same kept indices, for all three steps."""
    rng = np.random.default_rng(3)
    idx = np.stack([np.concatenate([[0], np.sort(rng.choice(9, 4, False)) + 1])
                    for _ in range(3)]).astype(np.int32)
    t_drop = tvit.drop_tokens

    def j_inject(x, rng_, keep_ratio, n_pinned=1):
        assert keep_ratio == 0.5 and x.shape[1] == 10
        return jnp.take_along_axis(x, jnp.asarray(idx)[:, :, None], axis=1)

    def t_inject(x, gen, keep_ratio, n_pinned=1, idx_=None, mesh=None):
        return t_drop(x, gen, keep_ratio, n_pinned, idx=torch.from_numpy(idx))

    monkeypatch.setattr(jvit, "drop_tokens", j_inject)
    monkeypatch.setattr(tvit, "drop_tokens", t_inject)
    jl, tl, jg, tg, jp, tp = _run_both(weights, "float32", token_keep=0.5)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    _assert_trees_close(jg, tg, 1e-3, scaled=True)
    _assert_trees_close(jp, tp, 1e-3, scaled=False)
    # dropped tokens get no gradient through the gather: position embedding
    # rows of tokens no image kept stay at zero grad
    kept = set(idx.ravel().tolist())
    pos = tg["pos_embedding"][0]
    for i in range(10):
        assert (np.abs(pos[i]).max() > 0) == (i in kept)


def test_plain_path_train_steps_match_vitax_xla_path(weights):
    jl, tl, jg, tg, jp, tp = _run_both(weights, "float32", fused=False)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    _assert_trees_close(jg, tg, 1e-3, scaled=True)
    _assert_trees_close(jp, tp, 1e-3, scaled=False)


def test_pad_rows_of_the_padded_stream_get_finite_zero_grads(weights):
    """The cotangent of the pad rows is 0 at the head and stays 0 back
    through both fused halves; LN over an all-zero pad row is finite."""
    _, tc = _cfgs("float32")
    params = tvit.params_from_jax(weights)
    for p in param_leaves(params):
        p.requires_grad_(True)
    img = torch.from_numpy(_batches(1)[0][0])
    x = tvit.embed(params, img, tc).detach().requires_grad_()
    assert tvit._padded_stream_len(x, params, tc, False) == 16
    xp = torch.nn.functional.pad(x, (0, 0, 0, 6)).detach().requires_grad_()
    h = xp
    for lp in params["layers"]:
        h = tvit._block(h, lp, tc, None, True, seq_len=10)
    h = tvit.layer_norm(h, params["encoder_norm"]["scale"],
                        params["encoder_norm"]["bias"], tvit.LN_EPS,
                        use_kernels=True)
    h[:, 0].square().sum().backward()
    assert torch.isfinite(xp.grad).all()
    assert torch.all(xp.grad[:, 10:] == 0)
    assert xp.grad[:, :10].abs().max() > 0
    for p in param_leaves(params):
        assert p.grad is None or torch.isfinite(p.grad).all()


def test_eval_step_matches_vitax(weights):
    jc, tc = _cfgs("float32")
    img, lab = _batches(1, batch=4)[0]
    ref = j_eval(jc)(jax.tree.map(jnp.asarray, weights), jnp.asarray(img),
                     jnp.asarray(lab))
    out = t_eval(tc)(tvit.params_from_jax(weights), torch.from_numpy(img),
                     torch.from_numpy(lab))
    for k in ("loss", "acc1", "acc5"):
        assert float(out[k]) == pytest.approx(float(ref[k]), abs=1e-4)


def test_drop_tokens_keeps_cls_and_a_sorted_subset():
    x = torch.arange(2 * 10 * 4, dtype=torch.float32).reshape(2, 10, 4)
    gen = torch.Generator().manual_seed(0)
    y = tvit.drop_tokens(x, gen, 0.5)
    assert y.shape == (2, 5, 4)
    pos = (y[:, :, 0] / 4 - torch.arange(2)[:, None] * 10).long()
    assert torch.all(pos[:, 0] == 0)
    assert torch.all(pos[:, 1:].diff(dim=1) > 0)
    assert tvit.drop_tokens(x, gen, 1.0) is x
    # another draw from the same generator keeps another subset
    assert not torch.equal(tvit.drop_tokens(x, gen, 0.5), y)


def test_dropout_and_reinit_classifier():
    x = torch.ones(4000)
    gen = torch.Generator().manual_seed(0)
    assert tvit._dropout(x, 0.5, gen, True) is x
    assert tvit._dropout(x, 0.0, gen, False) is x
    y = tvit._dropout(x, 0.25, gen, False)
    assert set(torch.unique(y).tolist()) <= {0.0, float(torch.tensor(1 / 0.75))}
    assert 0.2 < (y == 0).float().mean().item() < 0.3
    _, tc = _cfgs("float32")
    params = tvit.init_params(torch.Generator().manual_seed(0), tc)
    new = tvit.reinit_classifier(params, torch.Generator().manual_seed(1), 7)
    assert new["classifier"]["kernel"].shape == (128, 7)
    assert torch.all(new["classifier"]["bias"] == 0)
    assert new["layers"] is params["layers"]


def test_remat_raises_until_ported(weights):
    _, tc = _cfgs("float32")
    with pytest.raises(NotImplementedError, match="remat"):
        tvit.apply(tvit.params_from_jax(weights),
                   torch.from_numpy(_batches(1)[0][0]),
                   tc.replace(remat="selective"))
