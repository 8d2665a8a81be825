"""vitax_torch's Res-ViT training steps against vitax's: three
`make_train_step` + `make_adamw_for` steps (the LoRA mask, the router's lr
scale as a parameter group, clip 1.0), the stacked scan layout and the
trainable mask, and the eval metrics of a padded batch. The setup, the
injected randomness and the tolerances are tests/test_torch_resvit_train.py's
(whose helpers and fixtures this file takes).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_resvit_train import (  # noqa: E402,F401
    FUSED, LAMBDAS, PATHS, PLAIN, _as_numpy, _batch, _cfgs, _close, _paths,
    _torch_noise, _trainable_paths, _weights, interpret_mode,
    vitax_noise, vitax_path_ids_from_the_keep_bits)
from vitax.models import resvit as jr  # noqa: E402
from vitax.train import resvit_steps as jsteps  # noqa: E402
from vitax.train import schedules as jsched  # noqa: E402
from vitax_torch.models import resvit as tr  # noqa: E402
from vitax_torch.train import resvit_steps as tsteps  # noqa: E402
from vitax_torch.train import schedules as tsched  # noqa: E402
from vitax_torch.train.optim import tree_leaves  # noqa: E402


# ------------------------------------------------- stacked layout, mask

def test_stacked_layout_round_trip_and_vitax_tree_loads():
    jc, tc = _cfgs()
    w = _weights(jc)
    tp = tr.params_from_jax(w)
    stacked = tr.stack_params(tp, tc)
    j_stacked = jax.tree.map(np.asarray, jr.stack_params(w, jc))
    assert tr.is_stacked(stacked) and not tr.is_stacked(tp)
    # the port's stacked tree is vitax's, leaf for leaf
    for (pa, a), (pb, b) in zip(_paths(j_stacked), _paths(_as_numpy(stacked))):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    # the round trip, and vitax's stacked tree through params_from_jax
    for other in (tr.unstack_params(stacked),
                  tr.params_from_jax(j_stacked)):
        for (pa, a), (pb, b) in zip(_paths(_as_numpy(tp)),
                                    _paths(_as_numpy(other))):
            assert pa == pb
            np.testing.assert_array_equal(a, b)
    assert tr.trainable_mask(stacked, tc) == jr.trainable_mask(j_stacked, jc)


def test_stacked_params_run_the_loop():
    """vitax's scan apply has the loop's math: a stacked tree gives the list
    layout's logits and grads (reaching the stacked leaves); with
    compact_capacity it raises, as vitax's apply does."""
    jc, tc = _cfgs(**PLAIN)
    w = _weights(jc)
    img, _ = _batch()
    noise = _torch_noise(vitax_noise(jax.random.PRNGKey(6), jc, 4))
    tp = tr.params_from_jax(w)
    stacked = tr.stack_params(tr.params_from_jax(w), tc)
    outs = []
    for params in (tp, stacked):
        for t in tree_leaves(params):
            t.requires_grad_()
        logits, aux = tr.apply(params, torch.from_numpy(img), tc, train=True,
                               noise=noise)
        (logits.sum() + aux["d_loss"]).backward()
        outs.append((logits, params))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    def grad(t):
        return torch.zeros_like(t) if t.grad is None else t.grad

    g_list = tr.stack_params(jax.tree.map(grad, tp, is_leaf=torch.is_tensor),
                             tc)
    for a, b in zip(tree_leaves(g_list), tree_leaves(stacked)):
        torch.testing.assert_close(a, grad(b), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="unrolled loop"):
        tr.apply(stacked, torch.from_numpy(img),
                 tc.replace(compact_capacity=0.5))


@pytest.mark.parametrize("kw", [{}, dict(use_lora=False)])
def test_trainable_mask_equals_vitaxs(kw):
    jc, tc = _cfgs(**kw)
    w = _weights(jc)
    mask = tr.trainable_mask(tr.params_from_jax(w), tc)
    assert mask == jr.trainable_mask(w, jc)
    if not kw:
        assert mask["layers"][0]["attention"]["wq"]["kernel"] is False
        assert mask["layers"][1]["router"]["out1"]["kernel"] is True
        assert mask["layers"][1]["router"]["in_norm"]["scale"] is False


# ---------------------------------------------------------------- steps

# "k13": --no-fused-qkv with the kernels on (the LN kernel and K13)
STEP_CASES = [("plain", {}), ("fused", dict(compact_capacity=0.625)),
              ("fused", dict(token_keep=0.5)), ("k13", {})]


@pytest.mark.parametrize("path,kw", STEP_CASES)
def test_three_train_steps_match_vitax(path, kw):
    """make_train_step + make_adamw_for (LoRA mask, router_lr_scale 0.3,
    clip 1.0, weight decay 0.05, warmup-cosine) for three steps of both
    packages on the same batches and noise: the metrics after each step and
    the parameters after it; frozen leaves bit-unchanged."""
    jc, tc = _cfgs(**PATHS[path], **kw)
    w = _weights(jc)
    lr, total = 1e-3, 3
    j_tx = jsteps.make_adamw_for(
        jc, jax.tree.map(jnp.asarray, w),
        jsched.cosine_with_warmup_lr(lr, 1, total), weight_decay=0.05,
        clip_grad_norm=1.0, router_lr_scale=0.3)
    j_state = jsteps.create_state(jax.tree.map(jnp.asarray, w), j_tx,
                                  jax.random.PRNGKey(21))
    lambdas = jsteps.Lambdas(**LAMBDAS)
    j_step = jsteps.make_train_step(jc, j_tx, lambdas, donate=False)
    tp = tr.params_from_jax(w)
    frozen0 = {id(t): t.clone() for t, m in zip(
        tree_leaves(tp), tree_leaves(tr.trainable_mask(tp, tc))) if not m}
    t_tx = tsteps.make_adamw_for(
        tc, tp, tsched.cosine_with_warmup_lr(lr, 1, total),
        weight_decay=0.05, clip_grad_norm=1.0, router_lr_scale=0.3)
    t_state = tsteps.create_state(tp, t_tx, torch.Generator().manual_seed(0))
    t_step = tsteps.make_train_step(tc, t_tx, tsteps.Lambdas(**LAMBDAS))
    trainable = _trainable_paths(jc, w)
    for step in range(3):
        img, labels = _batch(seed=30 + step)
        noise = vitax_noise(jax.random.fold_in(j_state.rng, j_state.step),
                            jc, 4)
        j_state, jm = j_step(j_state, jnp.asarray(img, jc.dtype),
                             jnp.asarray(labels))
        t_state, tm = t_step(t_state, torch.from_numpy(img).to(tc.dtype),
                             torch.from_numpy(labels), _torch_noise(noise))
        for k in ("loss", "c_loss", "a_loss", "d_loss", "router_entropy",
                  "non_low_rank_ratio", "layer_activation_rates", "acc1",
                  "acc5"):
            _close(jm[k], tm[k], 1e-4, f"step {step} {k}")
        for (p, a), b in zip(_paths(j_state.params),
                             tree_leaves(t_state.params)):
            name = jax.tree_util.keystr(p)
            if name in trainable:
                np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                           rtol=0, atol=2e-5,
                                           err_msg=f"step {step} {name}")
            else:
                assert torch.equal(b, frozen0[id(b)]), name
    assert t_state.step == 3


def test_router_lr_scale_is_a_parameter_group():
    jc, tc = _cfgs()
    tp = tr.params_from_jax(_weights(jc))
    tx = tsteps.make_adamw_for(tc, tp, lambda s: 0.5, router_lr_scale=0.3)
    lrs = sorted(g["lr"] for g in tx.optimizer.param_groups)
    assert lrs == pytest.approx([0.15, 0.5])
    n_opt = sum(len(g["params"]) for g in tx.optimizer.param_groups)
    assert n_opt == len(tx.trainable) == sum(
        tree_leaves(tr.trainable_mask(tp, tc)))


# ---------------------------------------------------------------- metrics

@pytest.mark.parametrize("capacity", [None, 0.625])
def test_eval_metrics_count_only_the_real_rows(capacity):
    """A padded batch (3 real images, 2 pad rows copying image 0 at weight
    0, as the pipeline pads a last batch): the port's active ratio, router
    entropy and per-layer activation rates, with the accuracies and the
    loss, equal vitax's on the 3 real images alone (where vitax has no pad
    row to count)."""
    jc, tc = _cfgs(**FUSED, compact_capacity=capacity)
    w = _weights(jc)
    img, labels = _batch(3, seed=8)
    pad_img = np.concatenate([img, img[:1], img[:1]])
    pad_lab = np.concatenate([labels, labels[:1], labels[:1]])
    weight = np.array([1, 1, 1, 0, 0], np.float32)
    jm, _ = jsteps.make_eval_step(jc)(
        jax.tree.map(jnp.asarray, w), jnp.asarray(img), jnp.asarray(labels),
        jnp.ones(3, jnp.float32))
    tm, _ = tsteps.make_eval_step(tc)(
        tr.params_from_jax(w), torch.from_numpy(pad_img),
        torch.from_numpy(pad_lab), torch.from_numpy(weight))
    for k in ("loss", "acc1", "acc5", "non_low_rank_ratio",
              "router_entropy", "layer_activation_rates"):
        _close(jm[k], tm[k], 1e-5, k)
    # the unweighted means over the padded batch differ: the fault is gone
    acts = tm.get("layer_activation_rates")
    assert acts.shape == (tc.n_layers,)
