"""K6, the KV-chunked attention half, and K2's backward at d > 1024 (the
ViT-H/14 path of vitax_torch) against vitax on CPU, on the same numpy
inputs, with vitax's Pallas kernels in interpret mode.

- K6's twins (`fused_ln_qkvo_attention_flash_ref` and its `_bwd_ref`)
  against `pk.fused_ln_qkvo_attention_flash` and its custom VJP, at b2 s21
  (spq 24, three KV chunks of 8, the last one masked past 21) with 4 heads
  of 32 and 2 heads of 80; the autograd Function on the same inputs.
- K2's backward twin against vitax's chunked route (:1610), forced at d 256
  with `_MLP_MONO_MAX_D` 128: vitax sums dW1 and dW2 from bf16 partials of
  512-row blocks, the port in fp32, so on one block the port's dW rounded
  to bf16 is within one bf16 ulp of vitax's (or, where the sum cancels to a
  small value, within the fp32 tolerance of the sum's order).
- A tiny ViT-H/14-shaped model (patch 14, image 28, d 640, 8 heads of 80,
  MLP 1280, 2 layers) with vitax's K1 gate shut at d 512
  (`VITAX_QKVO_MAX_D`, and `gates.QKVO_MAX_D` in the port's copy of it:
  the port's K1 gate, K13's limits, takes head dim 80) and both packages'
  mono MLP backward bound at 512,
  so that both take K6 and the :1610 route as h14 does: logits, every
  parameter's grad and three SGD steps.
- The dispatch at h14's shapes, the raise for the int8/int4 tiers, and the
  CLIs on the tiny model (its preset injected as "h14").

Tolerances, max|port - vitax| <= tol * max(1, max|vitax|) unless stated:
fp32 1e-5 for the kernel twins (the grads at 1e-5 of each grad's max),
1e-4 for logits and losses, 1e-3 for grads and params (sums over the
batch); bf16 2e-2 (ulp 2^-8, same rounding points, sums in another order).
vitax's chunked MLP backward returns bf16-rounded dW1 and dW2 even in fp32,
so those two grads are held at 2^-8 in the model tests.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from vitax import eval_cli as j_eval  # noqa: E402
from vitax.checkpointing.npz import save_npz_params  # noqa: E402
from vitax.core import config as j_config  # noqa: E402
from vitax.models import vit as jvit  # noqa: E402
from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax.train import (create_train_state as j_state,  # noqa: E402
                         cross_entropy as j_ce, make_train_step as j_step,
                         onecycle_lr as j_lr, onecycle_momentum as j_mom,
                         sgd_momentum as j_sgd)
from vitax_torch import eval_cli as t_eval  # noqa: E402
from vitax_torch import train_cli as t_train  # noqa: E402
from vitax_torch.core import config as t_config  # noqa: E402
from vitax_torch.models import vit as tvit  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402
from vitax_torch.ops import gates  # noqa: E402
from vitax_torch.train import (create_train_state as t_state,  # noqa: E402
                               cross_entropy as t_ce, make_train_step as t_step,
                               param_leaves, sgd_momentum as t_sgd)

EPS = 1e-5
TINY_H14 = dict(patch=14, emb_dim=640, mlp_dim=1280, num_heads=8,
                num_layers=2)
WIDE_ROUTE = "ROADMAP Queue 1 item 8"


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _close(out, ref, tol):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= bound, (err, bound)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# ---------------------------------------------------------------- K6 twins

QKVO_SHAPES = [(2, 24, 21, 128, 4, 32), (2, 24, 21, 160, 2, 80)]


def _qkvo(shape, seed=0):
    """(x, γ, β, Wqkv, bqkv, Wo, bo) and do as fp32 numpy arrays."""
    b, spq, _, d, h, hd = shape
    rng = np.random.default_rng(seed)

    def n(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    hhd = h * hd
    args = (n(b, spq, d), 1 + n(d, scale=0.1), n(d, scale=0.1),
            n(d, 3 * hhd, scale=d ** -0.5), n(3 * hhd, scale=0.1),
            n(hhd, d, scale=hhd ** -0.5), n(d, scale=0.1))
    return args, n(b, spq, d)


def _typed(args, dtype, lib):
    """The compute-dtype operands (x, Wqkv, Wo) in `dtype`, the rest fp32."""
    if lib == "jax":
        dt = getattr(jnp, dtype)
        return [jnp.asarray(a, dt if i in (0, 3, 5) else jnp.float32)
                for i, a in enumerate(args)]
    dt = getattr(torch, dtype)
    return [_t(a, dt if i in (0, 3, 5) else torch.float32)
            for i, a in enumerate(args)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", QKVO_SHAPES)
def test_flash_twin_forward_matches_vitax(shape, dtype):
    args, _ = _qkvo(shape)
    seq, h, hd = shape[2], shape[4], shape[5]
    ref = pk.fused_ln_qkvo_attention_flash(*_typed(args, dtype, "jax"), EPS,
                                           seq, h, hd)
    targs = _typed(args, dtype, "torch")
    out = ck.fused_ln_qkvo_attention_flash_ref(*targs, EPS, seq, h, hd)
    tol = 1e-5 if dtype == "float32" else 2e-2
    _close(out.float(), np.asarray(ref, np.float32), tol)
    # the wrapper under autograd: the Function, the twin's values
    leaves = [t.clone().requires_grad_() for t in targs]
    fn = ck.fused_ln_qkvo_attention_flash(*leaves, EPS, seq, h, hd)
    assert type(fn.grad_fn).__name__ == "FusedLnQkvoAttentionFlashFnBackward"
    assert torch.equal(fn.detach(), out)


@pytest.mark.parametrize("shape", QKVO_SHAPES)
def test_flash_twin_backward_matches_vitax_vjp(shape):
    """All 7 grads of K6, fp32, at 1e-5 of each grad's max; the Function's
    grads are the backward twin's."""
    args, do = _qkvo(shape, seed=1)
    seq, h, hd = shape[2], shape[4], shape[5]
    _, vjp = jax.vjp(
        lambda *a: pk.fused_ln_qkvo_attention_flash(*a, EPS, seq, h, hd),
        *_typed(args, "float32", "jax"))
    refs = vjp(jnp.asarray(do))
    targs = _typed(args, "float32", "torch")
    outs = ck.fused_ln_qkvo_attention_flash_bwd_ref(
        *targs[:6], _t(do), EPS, seq, h, hd)
    assert len(outs) == len(refs) == 7
    for out, ref in zip(outs, refs):
        ref = np.asarray(ref)
        assert out.shape == ref.shape
        assert float(np.abs(out.numpy() - ref).max()) <= \
            1e-5 * float(np.abs(ref).max())
    leaves = [t.clone().requires_grad_() for t in targs]
    ck.fused_ln_qkvo_attention_flash(*leaves, EPS, seq, h, hd).backward(
        _t(do))
    for leaf, out in zip(leaves, outs):
        assert torch.equal(leaf.grad, out)


def test_flash_twin_matches_the_whole_row_twin():
    """K6's and K1's twins: one function up to the softmax's rounding."""
    args, do = _qkvo(QKVO_SHAPES[0], seed=2)
    targs = _typed(args, "float32", "torch")
    a = ck.fused_ln_qkvo_attention_flash_ref(*targs, EPS, 21, 4, 32)
    b = ck.fused_ln_qkvo_attention_ref(*targs, EPS, 21, 4, 32)
    _close(a, b, 1e-5)
    for u, v in zip(
            ck.fused_ln_qkvo_attention_flash_bwd_ref(*targs[:6], _t(do), EPS,
                                                     21, 4, 32),
            ck.fused_ln_qkvo_attention_bwd_ref(*targs[:6], _t(do), EPS, 21, 4,
                                               32)):
        _close(u, v, 1e-4)


@pytest.mark.parametrize("spq,chunks", [(24, 3), (264, 3), (736, 4), (8, 1)])
def test_flash_chunks_copy_vitax(spq, chunks):
    assert ck.flash_chunks(spq) == pk._flash_chunks(spq) == chunks


# ------------------------------------------------- K2 backward, :1610 route

def _bf16_ulp(a):
    """One bf16 ulp at each element's magnitude."""
    a = np.maximum(np.abs(a), np.float32(2.0 ** -126))
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def test_wide_mlp_backward_twin_matches_vitax_chunked_route(monkeypatch):
    monkeypatch.setattr(pk, "_MLP_MONO_MAX_D", 128)
    d, m = 256, 512
    rng = np.random.default_rng(3)

    def n(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    args = (n(2, 200, d), 1 + n(d, scale=0.1), n(d, scale=0.1),
            n(d, m, scale=d ** -0.5), n(m, scale=0.1), n(m, d, scale=m ** -0.5),
            n(d, scale=0.1))
    do = n(2, 200, d)
    calls = []
    chunked = pk._ln_mlp_bwd_chunked_call
    monkeypatch.setattr(pk, "_ln_mlp_bwd_chunked_call",
                        lambda *a: calls.append(1) or chunked(*a))
    _, vjp = jax.vjp(lambda *a: pk.fused_ln_mlp(*a, EPS),
                     *map(jnp.asarray, args))
    refs = [np.asarray(r) for r in vjp(jnp.asarray(do))]
    assert calls, "vitax did not take its chunked route"
    outs = ck.fused_ln_mlp_bwd_wide_ref(*map(_t, args[:6]), _t(do), EPS)
    dx, dg, dbe, dw1, db1, dw2, db2 = outs
    for i, out in ((0, dx), (1, dg), (2, dbe), (4, db1), (6, db2)):
        _close(out, refs[i], 1e-5)
    for i, out in ((3, dw1), (5, dw2)):
        # one bf16 ulp, or where a sum cancels to a small value, the fp32
        # noise of a sum taken in another order (1e-5 of the grad's max)
        port = out.to(torch.bfloat16).float().numpy()
        ulp = _bf16_ulp(np.maximum(np.abs(port), np.abs(refs[i])))
        bound = np.maximum(ulp, 1e-5 * np.abs(refs[i]).max())
        assert np.all(np.abs(port - refs[i]) <= bound)


# ------------------------------------------------ the tiny h14-shaped model

@pytest.fixture
def h14_routes(monkeypatch):
    """Both packages on K6 and the :1610 route at d 640, as at h14's d 1280;
    returns the call counts of the port's twins on that path."""
    monkeypatch.setenv("VITAX_QKVO_MAX_D", "512")
    monkeypatch.setattr(gates, "QKVO_MAX_D", 512)
    monkeypatch.setenv("VITAX_NO_CACHE", "1")
    monkeypatch.setattr(pk, "_MLP_MONO_MAX_D", 512)
    monkeypatch.setattr(ck, "MLP_MONO_MAX_D", 512)
    calls = dict.fromkeys(("fused_ln_qkvo_attention_flash_ref",
                           "fused_ln_qkvo_attention_flash_bwd_ref",
                           "fused_ln_mlp_bwd_wide_ref",
                           "fused_ln_qkvo_attention_ref"), 0)
    for name in calls:
        fn = getattr(ck, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(ck, name, spy)
    return calls


def _h14_cfgs(dtype):
    kw = dict(fused_qkv=True, fused_mlp=True, use_pallas=True,
              emb_dim=640, mlp_dim=1280, num_heads=8, num_layers=2)
    jc = j_config.arch_config("h14", 28, 10).replace(
        dtype=getattr(jnp, dtype), **kw)
    tc = t_config.arch_config("h14", 28, 10).replace(
        dtype=getattr(torch, dtype), **kw)
    return jc, tc


@pytest.fixture(scope="module")
def h14_weights():
    jc, _ = _h14_cfgs("float32")
    p = jax.tree.map(np.asarray, jvit.init_params(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        p)


def _h14_batches(n, batch=3):
    rng = np.random.default_rng(7)
    return [(rng.uniform(-1, 1, (batch, 28, 28, 3)).astype(np.float32),
             rng.integers(0, 10, batch).astype(np.int32)) for _ in range(n)]


def _vitax_layout(tree):
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return t.detach().float().numpy()

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = jax.tree.map(lambda *a: np.stack(a),
                                 *[conv(lp) for lp in tree["layers"]])
    return out


def _trees_close(ref, out, tol, wide_tol):
    flat = dict(jax.tree_util.tree_flatten_with_path(out)[0])
    for path, r in jax.tree_util.tree_flatten_with_path(ref)[0]:
        key = jax.tree_util.keystr(path)
        t = wide_tol if "fc1" in key or "fc2" in key else tol
        if "kernel" not in key:
            t = tol
        r = np.asarray(r, np.float32)
        err = float(np.abs(flat[path] - r).max())
        assert err <= t * max(1.0, float(np.abs(r).max())), (key, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_h14_logits_match_vitax(h14_weights, h14_routes, dtype,
                                     monkeypatch):
    jc, tc = _h14_cfgs(dtype)
    j_calls = []
    flash = pk.fused_ln_qkvo_attention_flash
    monkeypatch.setattr(pk, "fused_ln_qkvo_attention_flash",
                        lambda *a: j_calls.append(1) or flash(*a))
    img = _h14_batches(1)[0][0]
    ref = jvit.apply(jax.tree.map(jnp.asarray, h14_weights),
                     jnp.asarray(img, jc.dtype), jc)
    with torch.no_grad():
        out = tvit.apply(tvit.params_from_jax(h14_weights),
                         _t(img, tc.dtype), tc)
    _close(out, np.asarray(ref), 1e-4 if dtype == "float32" else 2e-2)
    assert j_calls, "vitax did not take K6"  # traced once: a layer scan
    assert h14_routes["fused_ln_qkvo_attention_flash_ref"] == 2
    assert h14_routes["fused_ln_qkvo_attention_ref"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_h14_grads_and_three_sgd_steps_match_vitax(h14_weights,
                                                        h14_routes,
                                                        monkeypatch, dtype):
    jc, tc = _h14_cfgs(dtype)
    tol = 1e-3 if dtype == "float32" else 2e-2
    loss_tol = 1e-4 if dtype == "float32" else 2e-2
    j_chunked = []
    chunked = pk._ln_mlp_bwd_chunked_call
    monkeypatch.setattr(pk, "_ln_mlp_bwd_chunked_call",
                        lambda *a: j_chunked.append(1) or chunked(*a))
    batches = _h14_batches(3)
    lr, total, pct, wd = 0.03, 10, 0.2, 1e-4
    jp = jax.tree.map(jnp.asarray, h14_weights)
    img0, lab0 = batches[0]

    def loss_fn(p):
        logits = jvit.apply(p, jnp.asarray(img0, jc.dtype), jc, train=True,
                            rng=jax.random.PRNGKey(1))
        return j_ce(logits, jnp.asarray(lab0))

    j_grads = jax.tree.map(np.asarray, jax.grad(loss_fn)(jp))
    assert j_chunked, "vitax did not take its chunked MLP backward"
    tx = j_sgd(j_lr(lr, total, pct), momentum_schedule=j_mom(total, pct),
               weight_decay=wd)
    state = j_state(jp, tx, jax.random.PRNGKey(1))
    step = j_step(jc, tx, donate=False)
    j_losses = []
    for img, lab in batches:
        state, metrics = step(state, jnp.asarray(img, jc.dtype),
                              jnp.asarray(lab))
        j_losses.append(float(metrics["loss"]))

    params = tvit.params_from_jax(h14_weights)
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = t_ce(tvit.apply(params, _t(img0, tc.dtype), tc, train=True),
                torch.from_numpy(lab0))
    grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    t_grads = _vitax_layout(jax.tree.map(lambda p: grads[id(p)], params))
    _trees_close(j_grads, t_grads, tol, max(tol, 2.0 ** -8))
    # the port took K6's twin and the :1610 route, forward and backward
    assert h14_routes["fused_ln_qkvo_attention_flash_bwd_ref"] == 2
    assert h14_routes["fused_ln_mlp_bwd_wide_ref"] == 2
    assert h14_routes["fused_ln_qkvo_attention_ref"] == 0

    params = tvit.params_from_jax(h14_weights)
    opt, sched = t_sgd(params, lr, total, pct, weight_decay=wd)
    tstate = t_state(params, opt, sched, torch.Generator().manual_seed(1))
    tstep = t_step(tc, opt, sched)
    t_losses = []
    for img, lab in batches:
        tstate, metrics = tstep(tstate, _t(img, tc.dtype),
                                torch.from_numpy(lab))
        t_losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(t_losses, j_losses, rtol=loss_tol,
                               atol=loss_tol)
    _trees_close(jax.tree.map(np.asarray, state.params),
                 _vitax_layout(tstate.params), tol, tol)


# ------------------------------------------------------------- dispatch

@pytest.mark.parametrize("image,seq,spq", [(384, 730, 736), (224, 257, 264)])
def test_both_packages_take_k6_at_h14_shapes(image, seq, spq):
    jx = jax.ShapeDtypeStruct((2, spq, 1280), jnp.bfloat16)
    jw = jax.ShapeDtypeStruct((1280, 3 * 1280), jnp.bfloat16)
    assert not pk.qkv_attention_supported(jx, jw)
    assert pk.qkv_attention_flash_supported(jx, jw)
    tx = torch.empty((2, spq, 1280), dtype=torch.bfloat16, device="meta")
    tw = torch.empty((1280, 3 * 1280), dtype=torch.bfloat16, device="meta")
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            assert tvit._attention_kernel(tx, tw, 16) == "k6"
    # the padded stream admits K6: one pad of seq rows to spq
    jc = j_config.arch_config("h14", image, 10).replace(fused_qkv=True,
                                                         fused_mlp=True)
    w = np.broadcast_to(np.zeros((), np.float32), (1, 1280, 5120))
    jparams = {"layers": {"mlp": {"fc1": {"kernel": w},
                                  "fc2": {"kernel": w.transpose(0, 2, 1)}}}}
    assert jvit._padded_stream_len(
        jax.ShapeDtypeStruct((2, seq, 1280), jnp.bfloat16), jparams, jc,
        None, True) == spq
    tc = t_config.arch_config("h14", image, 10).replace(fused_qkv=True,
                                                        fused_mlp=True)
    w1 = torch.empty((1280, 5120), device="meta")
    tparams = {"layers": [{"mlp": {"fc1": {"kernel": w1},
                                   "fc2": {"kernel": w1.t()}}}]}
    x = torch.empty((2, seq, 1280), dtype=torch.bfloat16, device="meta")
    with torch.no_grad():
        assert tvit._padded_stream_len(x, tparams, tc) == spq


# ------------------------------------------------ int8 / int4 at d > 1024

@pytest.mark.parametrize("flags", [["--int8"], ["--int8-grad"], ["--int8-dw"],
                                   ["--int4"], ["--int4-attn"]])
def test_low_precision_tiers_at_h14_raise_in_train_cli(flags, tmp_path):
    with pytest.raises(NotImplementedError, match=WIDE_ROUTE):
        t_train.main(["--dataset", "Synthetic", "--model-arch", "h14",
                      "--synthetic-samples", "8", "--exp-root", str(tmp_path)]
                     + flags, device="cpu")


def test_low_precision_tiers_at_h14_raise_in_eval_cli_and_apply():
    with pytest.raises(NotImplementedError, match=WIDE_ROUTE):
        t_eval.main(["--dataset", "Synthetic", "--model-arch", "h14",
                     "--synthetic-samples", "8", "--int8"], device="cpu")
    cfg = t_config.arch_config("h14", 224, 10, int8_mlp=True)
    with pytest.raises(NotImplementedError, match=WIDE_ROUTE):
        tvit.apply(None, torch.zeros(1, 224, 224, 3), cfg)


def test_int8_on_the_k6_path_raises(h14_weights, h14_routes):
    """d 640 passes the width check, but its hd 80 sends the attention half
    to K6, which has no int8 tier."""
    _, tc = _h14_cfgs("float32")
    img = _t(_h14_batches(1)[0][0])
    with pytest.raises(NotImplementedError, match=WIDE_ROUTE):
        tvit.apply(tvit.params_from_jax(h14_weights), img,
                   tc.replace(int8_attn=True, int8_mlp=True))


# ------------------------------------------------------------------ CLIs

@pytest.fixture
def tiny_h14_preset(monkeypatch, h14_routes):
    monkeypatch.setitem(t_config.ARCH_PRESETS, "h14", TINY_H14)
    monkeypatch.setitem(j_config.ARCH_PRESETS, "h14", TINY_H14)
    return h14_routes


def test_train_cli_on_the_tiny_h14(tiny_h14_preset, tmp_path):
    out = t_train.main([
        "--dataset", "Synthetic", "--model-arch", "h14", "--image-size", "32",
        "--num-workers", "0", "--dtype", "float32", "--batch-size", "4",
        "--synthetic-samples", "8", "--train-steps", "2", "--lr", "0.01",
        "--warmup-steps", "0", "--fused-qkv", "--fused-mlp",
        "--exp-root", str(tmp_path)], device="cpu")
    losses = out["epochs"][0]["train"]["losses"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert out["state"].step == 2
    # 2 layers: 2 train steps and 2 eval batches forward, 2 steps backward
    assert tiny_h14_preset == {"fused_ln_qkvo_attention_flash_ref": 8,
                               "fused_ln_qkvo_attention_flash_bwd_ref": 4,
                               "fused_ln_mlp_bwd_wide_ref": 4,
                               "fused_ln_qkvo_attention_ref": 0}


def test_eval_cli_on_the_tiny_h14_matches_vitax(tiny_h14_preset, tmp_path):
    """The port's K6 path against vitax's XLA path on one npz (fp32)."""
    cfg = j_config.arch_config("h14", 32, 10)
    params = jvit.init_params(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape), params)
    path = str(tmp_path / "w.npz")
    save_npz_params(path, params)
    argv = ["--dataset", "Synthetic", "--model-arch", "h14",
            "--image-size", "32", "--batch-size", "8",
            "--synthetic-samples", "16", "--num-workers", "0",
            "--dtype", "float32", "--checkpoint-path", path]
    ref = j_eval.main(argv)
    out = t_eval.main(argv + ["--fused-qkv", "--fused-mlp"], device="cpu")
    np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-4,
                               atol=1e-4)
    assert out["acc1"] == pytest.approx(ref["acc1"], abs=1e-6)
    assert out["acc5"] == pytest.approx(ref["acc5"], abs=1e-6)
    assert tiny_h14_preset["fused_ln_qkvo_attention_flash_ref"] == 4
    assert tiny_h14_preset["fused_ln_qkvo_attention_ref"] == 0


def test_profile_vit_refuses_unknown_configs_and_the_cpu():
    from vitax_torch.scripts import profile_vit
    with pytest.raises(SystemExit, match="unknown configs"):
        profile_vit.main(["h14-serve"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA card"):
            profile_vit.main(["h14-eval"])
