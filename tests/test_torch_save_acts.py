"""The save-acts MLP half of vitax_torch (`--save-acts`, K12) against vitax's.

- K12's four twins (ops/cuda_kernels.py: `fused_ln_mlp_save_ref`,
  `fused_ln_mlp_bwd_fast_ref`, `fused_ln_mlp_int8_save_ref`,
  `fused_ln_mlp_int8_save_bwd_ref`) against vitax's Pallas kernels in
  interpret mode (:1687, :1723, :2025, :2066), fp32 and bf16, padded and
  ragged row counts, `int8_dw` off and on (at vitax's group, from its own
  geometry helpers); the backwards take vitax's saved activations.
- Each twin pair's VJP through `FusedLnMlpSaveFn` (the wrappers' CPU route)
  against `pk._ln_mlp_2d_save` and `pk._ln_mlp_2d_int8s`.
- `vit.apply` with `fused_mlp_save` across the tiers (logits and every
  grad), three train steps, `train_cli --save-acts` (the twins it calls),
  and vitax's dispatch: `--int8` alone keeps K4 and K2's backward, and
  above d 1024 save-acts is off (forced at d 128 with `_MLP_MONO_MAX_D`).

The kernels are held against these twins on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py phase 12).

Shapes: D 128, M 256, H 2; 3 x 16 rows and the ragged 3 x 10. Tolerances,
max|port - vitax| <= tol * max(1, max|vitax|) per output: fp32 1e-4 for
activations and vector grads, 1e-3 for weight grads; bf16 2e-2 (ulp 2^-8,
the same rounding points, sums in another order). Codes (h1q, gpq) within
one step of vitax's, on at most CODE_SHARE of them: both quantize on one
grid, and a value on a .5 tie moves a code where the two packages' LN or
GELU differ in the last ulp.
"""

import argparse

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from vitax.core.config import arch_config as j_arch  # noqa: E402
from vitax.models import vit as jvit  # noqa: E402
from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax.train import (create_train_state as j_state,  # noqa: E402
                         make_train_step as j_step, onecycle_lr as j_lr,
                         onecycle_momentum as j_mom, sgd_momentum as j_sgd)
from vitax_torch import train_cli  # noqa: E402
from vitax_torch.core.config import arch_config as t_arch  # noqa: E402
from vitax_torch.models import vit as tvit  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402
from vitax_torch.train import (create_train_state as t_state,  # noqa: E402
                               cross_entropy as t_ce,
                               make_train_step as t_step, param_leaves,
                               sgd_momentum as t_sgd)

D, H, M, SPQ, SEQ, EPS = 128, 2, 256, 16, 10, 1e-5
TOL = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 2e-2)}
CODE_SHARE = 1e-2
GRADS = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
_MLP = ("x", "gamma", "beta", "w1", "b1", "w2", "b2")
_MATS = ("x", "do", "w1", "w2")
INT8_GRAD = dict(int8_mlp=True, int8_attn=True, int8_mlp_grad=True,
                 int8_attn_grad=True)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _arrays(seed, rows, batch=3):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(x=n(batch, rows, D) * 1.5 + 0.3, do=n(batch, rows, D),
                gamma=1 + n(D, scale=0.1), beta=n(D, scale=0.1),
                w1=n(D, M, scale=D ** -0.5), b1=n(M, scale=0.1),
                w2=n(M, D, scale=M ** -0.5), b2=n(D, scale=0.1))


def _both(arrays, dtype):
    j = {k: jnp.asarray(v, getattr(jnp, dtype) if k in _MATS else jnp.float32)
         for k, v in arrays.items()}
    t = {k: torch.from_numpy(v).to(getattr(torch, dtype) if k in _MATS
                                   else torch.float32)
         for k, v in arrays.items()}
    return j, t


def _close(ref, out, tol, what):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    out = out.detach().float().numpy().reshape(ref.shape)
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= bound, f"{what}: max error {err:.3e} > {bound:.3e}"


def _check_grads(refs, outs, dtype):
    small, weights = TOL[dtype]
    assert len(refs) == len(outs) == len(GRADS)
    for name, r, o in zip(GRADS, refs, outs):
        _close(r, o, weights if name.startswith("dw") else small, name)


def _codes_close(ref, out, what):
    moved = np.abs(np.asarray(ref, np.int32)
                   - out.numpy().astype(np.int32).reshape(np.shape(ref)))
    assert moved.max() <= 1 and moved.mean() <= CODE_SHARE, \
        f"{what}: codes moved {moved.max()} steps, share {moved.mean()}"


def _padder(n, npad):
    def pad(a):
        return jnp.pad(a.reshape(n, -1), ((0, npad - n), (0, 0)))
    return pad


def _vitax_mlp_dw_group(npad):
    """vitax's int8_dw group of the int8 MLP backwards over the padded
    rows: a grid step's chunk, _ln_mlp_rows // _bwd_chunks
    (pallas_kernels.py:1393, :1405)."""
    rows = pk._ln_mlp_rows(npad, int8=True)
    return rows // pk._bwd_chunks(rows)


# ------------------------------------------------------------ the bf16 pair

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [SPQ, SEQ], ids=["spq16", "ragged"])
def test_save_twins_match_pallas(dtype, rows):
    """:1687's out, h1 and g' and :1723's seven grads from vitax's saved
    h1 and g' (vitax pads the rows with zeros; a zero row with a zero
    cotangent adds nothing to a grad)."""
    j, t = _both(_arrays(1, rows), dtype)
    n = 3 * rows
    pad = _padder(n, pk._ln_mlp_pad(n))
    ref = pk._ln_mlp_fwd_save_call(pad(j["x"]), *(j[k] for k in _MLP[1:]),
                                   EPS, True)
    out = ck.fused_ln_mlp_save_ref(*(t[k] for k in _MLP), EPS)
    assert out[0].shape == t["x"].shape and out[1].shape == (n, M)
    assert all(o.dtype == t["x"].dtype for o in out)
    for name, r, o in zip(("out", "h1", "gp"), ref, out):
        _close(r[:n], o, TOL[dtype][0], name)
    torch.testing.assert_close(out[0], ck.fused_ln_mlp_ref(
        *(t[k] for k in _MLP), EPS), rtol=0, atol=0)
    for a, b in zip(out, ck.fused_ln_mlp_save(*(t[k] for k in _MLP), EPS)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    h1, gp = ref[1], ref[2]
    ref_b = pk._ln_mlp_bwd_fast_call(pad(j["x"]), j["gamma"], j["beta"],
                                     j["w1"], j["w2"], h1, gp, pad(j["do"]),
                                     EPS, True)
    ref_b = (ref_b[0][:n], *ref_b[1:])
    args = (t["x"], t["gamma"], t["beta"], t["w1"], t["w2"],
            *(torch.from_numpy(np.array(a[:n], np.float32)).to(t["x"].dtype)
              for a in (h1, gp)), t["do"], EPS)
    out_b = ck.fused_ln_mlp_bwd_fast_ref(*args)
    assert out_b[0].dtype == t["x"].dtype
    assert all(o.dtype == torch.float32 for o in out_b[1:])
    _check_grads(ref_b, out_b, dtype)
    for a, b in zip(out_b, ck.fused_ln_mlp_bwd_fast(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _vjps(j, t, dtype, vitax_fn, port_fn, n, npad):
    """(vitax's VJP, the port's grads through its Function) on the same
    cotangent; vitax's over its zero-padded rows."""
    pad = _padder(n, npad)
    _, vjp = jax.vjp(lambda x, *a: vitax_fn(pad(x), *a)[:n],
                     *(j[k] for k in _MLP))
    ref = vjp(j["do"].reshape(n, D))
    leaves = [t[k].clone().requires_grad_() for k in _MLP]
    out = port_fn(*leaves)
    grads = torch.autograd.grad(out, leaves, t["do"])
    return ref, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [SPQ, SEQ], ids=["spq16", "ragged"])
def test_save_function_matches_vitax_vjp(dtype, rows):
    j, t = _both(_arrays(2, rows), dtype)
    n = 3 * rows
    ref, out = _vjps(j, t, dtype,
                     lambda *a: pk._ln_mlp_2d_save(*a, EPS, True),
                     lambda *a: ck.fused_ln_mlp(*a, EPS, save_acts=True),
                     n, pk._ln_mlp_pad(n))
    _check_grads(ref, out, dtype)


def test_save_acts_changes_the_backward_only_in_its_rounding():
    """In fp32 g' is not rounded, so the save pair's grads are the
    recompute pair's to the last bits of the sums; in bf16 the saved g' is
    rounded (vitax's :649), so they differ, within the bf16 band."""
    for dtype, exact in (("float32", True), ("bfloat16", False)):
        _, t = _both(_arrays(3, SPQ), dtype)
        grads = []
        for save in (False, True):
            leaves = [t[k].clone().requires_grad_() for k in _MLP]
            out = ck.fused_ln_mlp(*leaves, EPS, save_acts=save)
            grads.append(torch.autograd.grad(out, leaves, t["do"]))
        for a, b in zip(*grads):
            bound = (1e-5 if exact else 2e-2) * max(1.0, a.abs().max().item())
            assert (a.float() - b.float()).abs().max().item() <= bound
        if not exact:
            assert not torch.equal(grads[0][0], grads[1][0])


# ------------------------------------------------------------ the int8 pair

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [SPQ, SEQ], ids=["spq16", "ragged"])
def test_int8_save_twins_match_pallas(dtype, rows):
    """:2025's out and codes (h1q, its row scales, gpq on the static
    GELU' grid) and :2066's seven grads from vitax's saved codes, int8_dw
    off and on (at vitax's group)."""
    j, t = _both(_arrays(4, rows), dtype)
    n = 3 * rows
    npad = pk._ln_mlp_pad(n, int8=True)
    pad = _padder(n, npad)
    ref = pk._ln_mlp_fwd_int8_save_call(pad(j["x"]),
                                        *(j[k] for k in _MLP[1:]), EPS, True)
    out, h1q, sh, gpq = ck.fused_ln_mlp_int8_save_ref(*(t[k] for k in _MLP),
                                                      EPS)
    assert (h1q.dtype, sh.dtype, gpq.dtype) == (torch.int8, torch.float32,
                                                torch.int8)
    assert h1q.shape == gpq.shape == (n, M) and sh.shape == (n,)
    _close(ref[0][:n], out, TOL[dtype][0], "out")
    _codes_close(ref[1][:n], h1q, "h1q")
    _codes_close(ref[3][:n], gpq, "gpq")
    np.testing.assert_allclose(sh.numpy(), np.asarray(ref[2][:n, 0]),
                               rtol=1e-5)
    assert np.all(np.asarray(ref[2]) == np.asarray(ref[2][:, :1]))
    torch.testing.assert_close(out, ck.fused_ln_mlp_int8_ref(
        *(t[k] for k in _MLP), EPS), rtol=0, atol=0)
    for a, b in zip((out, h1q, sh, gpq),
                    ck.fused_ln_mlp_int8_save(*(t[k] for k in _MLP), EPS)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    group = _vitax_mlp_dw_group(npad)
    saved = [torch.from_numpy(np.array(a[:n])) for a in ref[1:]]
    saved[1] = saved[1][:, 0].contiguous()
    args = (t["x"], t["gamma"], t["beta"], t["w1"], t["w2"], *saved,
            t["do"], EPS)
    for int8_dw in (False, True):
        ref_b = pk._ln_mlp_bwd_int8_save_call(
            pad(j["x"]), j["gamma"], j["beta"], j["w1"], j["w2"], ref[1],
            ref[2], ref[3], pad(j["do"]), EPS, True, int8_dw=int8_dw)
        ref_b = (ref_b[0][:n], *ref_b[1:])
        out_b = ck.fused_ln_mlp_int8_save_bwd_ref(*args, int8_dw=int8_dw,
                                                  group=group)
        assert all(o.dtype == torch.float32 for o in out_b[1:])
        _check_grads(ref_b, out_b, dtype)
    # the wrappers' CPU route: the twins at the port's group
    for a, b in zip(ck.fused_ln_mlp_int8_save_bwd_ref(*args),
                    ck.fused_ln_mlp_int8_save_bwd(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(ck.fused_ln_mlp_int8_save_dw_bwd_ref(*args),
                    ck.fused_ln_mlp_int8_save_dw_bwd(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8_dw", [False, True], ids=["int8-grad", "int8-dw"])
def test_int8_save_function_matches_vitax_vjp(dtype, int8_dw, monkeypatch):
    """3 x 10 ragged rows; int8_dw at vitax's group. The int8_dw dW2 folds
    h1's saved row scale into do: its codes are not K4's (the bf16 dW2
    lands further from it)."""
    j, t = _both(_arrays(5, SEQ), dtype)
    n = 3 * SEQ
    npad = pk._ln_mlp_pad(n, int8=True)
    monkeypatch.setattr(ck, "MLP_DW_GROUP", _vitax_mlp_dw_group(npad))
    ref, out = _vjps(
        j, t, dtype,
        lambda *a: pk._ln_mlp_2d_int8s(*a, EPS, True, int8_dw),
        lambda *a: ck.fused_ln_mlp_int8(*a, EPS, int8_grad=True,
                                        int8_dw=int8_dw, save_acts=True),
        n, npad)
    _check_grads(ref, out, dtype)


def test_int8_save_dw_weight_grads_are_int8():
    """The int8_dw save backward's dW1 and dW2 are not the bf16 products."""
    _, t = _both(_arrays(6, SPQ), "float32")
    _, h1q, sh, gpq = ck.fused_ln_mlp_int8_save_ref(*(t[k] for k in _MLP),
                                                    EPS)
    args = (t["x"], t["gamma"], t["beta"], t["w1"], t["w2"], h1q, sh, gpq,
            t["do"], EPS)
    bf, dw = (ck.fused_ln_mlp_int8_save_bwd_ref(*args, int8_dw=f)
              for f in (False, True))
    assert not torch.equal(bf[3], dw[3]) and not torch.equal(bf[5], dw[5])
    for i in (0, 1, 2, 4, 6):
        torch.testing.assert_close(bf[i], dw[i], rtol=0, atol=0)


# ------------------------------------------------------------ the dispatch

def _spy(monkeypatch, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(ck, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(ck, name, counted)
    return calls


TWINS = ("fused_ln_mlp_ref", "fused_ln_mlp_bwd_ref", "fused_ln_mlp_save_ref",
         "fused_ln_mlp_bwd_fast_ref", "fused_ln_mlp_int8_ref",
         "fused_ln_mlp_int8_bwd_ref", "fused_ln_mlp_int8_save_ref",
         "fused_ln_mlp_int8_save_bwd_ref", "fused_ln_mlp_bwd_wide_ref")


@pytest.mark.parametrize("tier,expect", [
    ("bf16", {"fused_ln_mlp_save_ref": 1, "fused_ln_mlp_bwd_fast_ref": 1}),
    ("int8", {"fused_ln_mlp_int8_ref": 1, "fused_ln_mlp_bwd_ref": 1}),
    ("int8-grad", {"fused_ln_mlp_int8_save_ref": 1,
                   "fused_ln_mlp_int8_save_bwd_ref": 1}),
    ("no-grad", {"fused_ln_mlp_ref": 1}),
])
def test_dispatch_follows_vitax(tier, expect, monkeypatch):
    """save_acts under vitax's dispatch (pallas_kernels.py:2156-2166):
    bf16 takes the save pair, `--int8` alone K4 with K2's backward (save
    ignored), `--int8-grad` the int8 save pair; a call with no grad K2's
    forward."""
    calls = _spy(monkeypatch, TWINS)
    _, t = _both(_arrays(7, SPQ), "float32")
    leaves = [t[k].clone().requires_grad_(tier != "no-grad") for k in _MLP]
    if tier == "bf16" or tier == "no-grad":
        out = ck.fused_ln_mlp(*leaves, EPS, save_acts=True)
    else:
        out = ck.fused_ln_mlp_int8(*leaves, EPS, int8_grad=tier != "int8",
                                   save_acts=True)
    if tier != "no-grad":
        torch.autograd.grad(out, leaves, t["do"])
    assert {k: v for k, v in calls.items() if v} == expect


def test_save_acts_is_off_above_the_mono_width(monkeypatch, capsys):
    """Above vitax's _MLP_MONO_MAX_D (forced to 64 at d 128 in both
    packages) save-acts is off: K2 with its wide backward, one notice a
    process, and the grads of vitax's route. vitax's wide backward returns
    bf16-rounded dW1 and dW2 even in fp32, so those two are held at 2^-8."""
    monkeypatch.setattr(pk, "_MLP_MONO_MAX_D", 64)
    monkeypatch.setattr(ck, "MLP_MONO_MAX_D", 64)
    ck._notice.cache_clear()
    calls = _spy(monkeypatch, TWINS)
    j, t = _both(_arrays(8, SPQ), "float32")
    n = 3 * SPQ
    ref, out = _vjps(
        j, t, "float32",
        lambda x, *a: pk.fused_ln_mlp(x, *a, EPS, save_acts=True),
        lambda *a: ck.fused_ln_mlp(*a, EPS, save_acts=True), n, n)
    for name, r, o in zip(GRADS, ref, out):
        _close(r, o, 2.0 ** -8 if name in ("dw1", "dw2") else 1e-4, name)
    ck.fused_ln_mlp(*[t[k].clone().requires_grad_() for k in _MLP], EPS,
                    save_acts=True)
    # the wide twin is K2's backward twin (fused_ln_mlp_bwd_ref)
    assert {k: v for k, v in calls.items() if v} == {
        "fused_ln_mlp_ref": 2, "fused_ln_mlp_bwd_wide_ref": 1,
        "fused_ln_mlp_bwd_ref": 1}
    notice = capsys.readouterr().out
    assert notice.count("save-acts is off above d 64") == 1, notice
    ck._notice.cache_clear()


# ------------------------------------------------------------ the model

SMALL = dict(emb_dim=D, mlp_dim=M, num_heads=H, num_layers=2)
TIERS = {"bf16": {}, "int8-grad": INT8_GRAD,
         "int8-dw": dict(INT8_GRAD, int8_dw=True)}


def _cfgs(dtype, patch=16, **kw):
    kw = dict(fused_qkv=True, fused_mlp=True, use_pallas=True,
              fused_mlp_save=True, patch_size=(patch, patch), **SMALL, **kw)
    return (j_arch("tiny", 48, 10).replace(dtype=getattr(jnp, dtype), **kw),
            t_arch("tiny", 48, 10).replace(dtype=getattr(torch, dtype), **kw))


@pytest.fixture(scope="module")
def weights():
    jc, _ = _cfgs("float32")
    p = jax.tree.map(np.asarray, jvit.init_params(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        p)


def _images(batch, seed=1):
    return np.random.default_rng(seed).uniform(
        -1, 1, (batch, 48, 48, 3)).astype(np.float32)


def _vitax_layout(tree):
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return t.detach().float().numpy()

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = jax.tree.map(lambda *a: np.stack(a),
                                 *[conv(lp) for lp in tree["layers"]])
    return out


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_apply_with_save_acts_matches_vitax(tier, weights, monkeypatch):
    """fp32, image 48 at patch 4 (145 tokens, spq 152: no handoff), under
    autograd: the logits and the grads of every parameter of a cross-entropy
    loss, within tol·max(1, max|g|): 1e-3 for bf16, 2e-3 for `int8_grad`,
    where a code on a .5 tie moves a step (the band of three int8 train
    steps), 1e-2 for `int8_dw`, whose weight grads are int8 products of
    column codes that move with such a tie (4.7e-3 measured without
    save-acts, 4.5e-3 with it, fc2's kernel)."""
    flags = TIERS[tier]
    jc, tc = _cfgs("float32", patch=4, **flags)
    n = 2 * 152
    if flags.get("int8_dw"):
        monkeypatch.setattr(ck, "MLP_DW_GROUP",
                            _vitax_mlp_dw_group(pk._ln_mlp_pad(n, int8=True)))
    img = _images(2)
    labels = np.array([3, 7], np.int32)

    def j_loss(p):
        logits = jvit.apply(p, jnp.asarray(img), jc)
        lse = jax.nn.logsumexp(logits, axis=-1)
        return jnp.mean(lse - logits[jnp.arange(2), labels]), logits

    (_, j_logits), j_grads = jax.value_and_grad(j_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, weights))
    params = tvit.params_from_jax(weights)
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    logits = tvit.apply(params, torch.from_numpy(img), tc)
    grads = torch.autograd.grad(t_ce(logits, torch.from_numpy(labels)),
                                leaves)
    _close(j_logits, logits, 1e-4, "logits")
    for p, g in zip(leaves, grads):
        p.grad = g
    flat = dict(jax.tree_util.tree_flatten_with_path(_vitax_layout(
        jax.tree.map(lambda p: p.grad if p.grad is not None else p * 0,
                     params, is_leaf=torch.is_tensor)))[0])
    tol = {"bf16": 1e-3, "int8-grad": 2e-3, "int8-dw": 1e-2}[tier]
    for path, r in jax.tree_util.tree_flatten_with_path(j_grads)[0]:
        r = np.asarray(r, np.float32)
        err = float(np.abs(flat[path] - r).max())
        assert err <= tol * max(1.0, float(np.abs(r).max())), \
            (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("tier", ["bf16", "int8-grad"])
def test_three_save_acts_train_steps_match_vitax(tier, weights):
    """Three SGD steps of `--save-acts` (and `--int8-grad --save-acts`) at
    spq 152, fp32: losses 5e-3 relative, params 2e-3·max(1, |p|), the bands
    of three int8 train steps (tests/test_torch_int8.py)."""
    jc, tc = _cfgs("float32", patch=4, **TIERS[tier])
    rng = np.random.default_rng(7)
    batches = [(_images(2, seed=10 + i),
                rng.integers(0, 10, 2).astype(np.int32)) for i in range(3)]
    total, pct, lr, wd = 10, 0.2, 0.003, 1e-4
    tx = j_sgd(j_lr(lr, total, pct), momentum_schedule=j_mom(total, pct),
               weight_decay=wd)
    state = j_state(jax.tree.map(jnp.asarray, weights), tx,
                    jax.random.PRNGKey(1))
    step = j_step(jc, tx, donate=False)
    j_losses = []
    for img, lab in batches:
        state, m = step(state, jnp.asarray(img), jnp.asarray(lab))
        j_losses.append(float(m["loss"]))
    params = tvit.params_from_jax(weights)
    opt, sched = t_sgd(params, lr, total, pct, weight_decay=wd)
    tstate = t_state(params, opt, sched, torch.Generator().manual_seed(1))
    tstep = t_step(tc, opt, sched)
    t_losses = [float(tstep(tstate, torch.from_numpy(img),
                            torch.from_numpy(lab))[1]["loss"])
                for img, lab in batches]
    np.testing.assert_allclose(t_losses, j_losses, rtol=5e-3)
    out = dict(jax.tree_util.tree_flatten_with_path(
        _vitax_layout(tstate.params))[0])
    for path, r in jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, state.params))[0]:
        bound = 2e-3 * max(1.0, float(np.abs(r).max()))
        assert np.abs(out[path] - r).max() <= bound, \
            jax.tree_util.keystr(path)


# ------------------------------------------------------------ the CLI

TINY = ["--dataset", "Synthetic", "--model-arch", "tiny", "--num-workers", "0",
        "--dtype", "float32", "--fused-qkv", "--fused-mlp", "--image-size",
        "224", "--batch-size", "4", "--synthetic-samples", "8",
        "--train-steps", "2", "--warmup-steps", "0"]


@pytest.mark.parametrize("flags,expect", [
    (["--save-acts"], {"fused_ln_mlp_save_ref": 6,
                       "fused_ln_mlp_bwd_fast_ref": 6,
                       "fused_ln_mlp_ref": 6}),
    (["--int8-grad", "--save-acts"], {"fused_ln_mlp_int8_save_ref": 6,
                                      "fused_ln_mlp_int8_save_bwd_ref": 6,
                                      "fused_ln_mlp_int8_ref": 6}),
    (["--int8", "--save-acts"], {"fused_ln_mlp_int8_ref": 12,
                                 "fused_ln_mlp_bwd_ref": 6}),
], ids=["save-acts", "int8-grad", "int8-alone"])
def test_train_cli_save_acts_runs_the_save_twins(flags, expect, tmp_path,
                                                 monkeypatch):
    """3 layers at spq 200 (no handoff): 2 train steps through the save
    forward and backward, the 2 eval batches through K2's or K4's forward
    (no grad); `--int8 --save-acts` keeps K4 and K2's backward."""
    calls = _spy(monkeypatch, TWINS)
    out = train_cli.main(TINY + ["--exp-root", str(tmp_path)] + flags,
                         device="cpu")
    losses = out["epochs"][0]["train"]["losses"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert {k: v for k, v in calls.items() if v} == expect


def test_train_cli_maps_save_acts():
    ns = argparse.Namespace(model_arch="b16", image_size=224, num_classes=10,
                            dtype="bfloat16", fused_qkv=None, fused_mlp=None,
                            token_keep=1.0, no_pallas=False, save_acts=True)
    assert train_cli.model_config_from_cli(ns, on_gpu=True).fused_mlp_save
    del ns.save_acts
    assert not train_cli.model_config_from_cli(ns, on_gpu=True).fused_mlp_save
