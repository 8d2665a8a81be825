"""The `residual=False` branches of the int8, int4 and save-acts MLP halves
(K4, K11-A/B, K12) and of K2's wide backward, which vitax's
tensor-parallel MLP half runs per model shard, against vitax on CPU, on
the same numpy inputs, vitax's Pallas kernels in interpret mode under
`jax.jit`.

- Every flag set of the MLP half without the residual (int8; int8 with
  int8_grad, and int8_dw; int4; int4 with int4_grad, and int8_dw;
  save-acts in bf16; int8 with int8_grad and save-acts, and int8_dw):
  the port's wrapper with `residual=False` under autograd (its partial
  twins, through `FusedLnMlpFn` or `FusedLnMlpSaveFn`) against
  `pk.fused_ln_mlp(..., residual=False, ...)` and its VJP, and which
  partial wrappers ran.
- K2's wide backward without the residual (`fused_ln_mlp_bwd_wide_partial`)
  against vitax's chunked kernel (:1610) with `residual=False` at D 1280
  on one block of rows.
- The exact identities that chip_smoke.py holds the kernels to: each
  residual twin's output is bf16(x + partial) to the bit, each residual
  backward's dx bf16(do + dx_partial), every other output the same bits.
- The save fault: `fused_ln_mlp(save_acts=True, residual=False)` takes
  K12's partial pair, as vitax's dispatch does, and its grads are vitax's.

Shapes: D 128, M 256 (a shard of 2 heads of 64's MLP), x [2, 24, D] with
the rows past seq 21 zero, as the tensor-parallel wrappers see them.
Tolerances, max|port - vitax| <= tol·max(1, max|vitax|): fp32 1e-4 for the
output and the vector grads, 1e-3 for the weight grads (sums over every
row), test_torch_int8.py's, and 5e-3 for K11-B's int8_dw weight grads,
test_torch_int4.py's (a column code on a .5 tie of its grid moves one
step: 2.4e-3 measured on dW1); bf16 2e-2. The wide backward: vitax sums dW1
and dW2 from bf16 partials of 512-row blocks, the port in fp32, so on one
block the port's dW rounded to bf16 is within one bf16 ulp of vitax's (or
1e-5 of the grad's max, where a sum cancels), test_torch_flash.py's band.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402

D, M, EPS = 128, 256, 1e-5
GRADS = ("x", "gamma", "beta", "w1", "b1", "w2", "b2")
_MATS = ("x", "do", "w1", "w2")
# flag set -> (vitax's fused_ln_mlp flags, the port's partial wrappers that
# run: forward, backward)
FLAGS = {
    "int8": (dict(int8=True), ("fused_ln_mlp_int8_partial",
                               "fused_ln_mlp_partial_bwd")),
    "int8_grad": (dict(int8=True, int8_grad=True),
                  ("fused_ln_mlp_int8_partial",
                   "fused_ln_mlp_int8_partial_bwd")),
    "int8_dw": (dict(int8=True, int8_grad=True, int8_dw=True),
                ("fused_ln_mlp_int8_partial",
                 "fused_ln_mlp_int8_partial_dw_bwd")),
    "int4": (dict(int8=True, int4=True), ("fused_ln_mlp_int4_partial",
                                          "fused_ln_mlp_partial_bwd")),
    "int4_grad": (dict(int8=True, int4=True, int4_grad=True),
                  ("fused_ln_mlp_int4_partial",
                   "fused_ln_mlp_int4_partial_bwd")),
    "int4_grad_dw": (dict(int8=True, int8_grad=True, int8_dw=True, int4=True,
                          int4_grad=True),
                     ("fused_ln_mlp_int4_partial",
                      "fused_ln_mlp_int4_partial_dw_bwd")),
    "save": (dict(save_acts=True), ("fused_ln_mlp_save_partial",
                                    "fused_ln_mlp_bwd_fast_partial")),
    "int8_save": (dict(int8=True, int8_grad=True, save_acts=True),
                  ("fused_ln_mlp_int8_save_partial",
                   "fused_ln_mlp_int8_save_partial_bwd")),
    "int8_save_dw": (dict(int8=True, int8_grad=True, int8_dw=True,
                          save_acts=True),
                     ("fused_ln_mlp_int8_save_partial",
                      "fused_ln_mlp_int8_save_partial_dw_bwd")),
}
PARTIALS = sorted({n for _, names in FLAGS.values() for n in names}
                  | {"fused_ln_mlp_bwd_wide_partial"})


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _arrays(seed, d=D, m=M):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    a = dict(x=n(2, 24, d) * 1.5 + 0.3, gamma=1 + n(d, scale=0.1),
             beta=n(d, scale=0.1), w1=n(d, m, scale=d ** -0.5),
             b1=n(m, scale=0.1), w2=n(m, d, scale=m ** -0.5),
             b2=n(d, scale=0.1), do=n(2, 24, d))
    a["x"][:, 21:] = 0
    a["do"][:, 21:] = 0
    return a


def _both(a, dtype):
    j = {k: jnp.asarray(v, getattr(jnp, dtype) if k in _MATS else jnp.float32)
         for k, v in a.items()}
    t = {k: torch.from_numpy(v).to(getattr(torch, dtype) if k in _MATS
                                   else torch.float32)
         for k, v in a.items()}
    return j, t


def _close(ref, out, tol, what):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    out = out.detach().float().numpy().reshape(ref.shape)
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= bound, f"{what}: max error {err:.3e} > {bound:.3e}"


def _port_partial(t, flags):
    """The port's MLP half without the residual in the tier of vitax's
    `flags`, as `parallel/tp_kernels.py` (and, for save-acts, a direct
    caller of `fused_ln_mlp`) calls it."""
    args = tuple(t[k] for k in GRADS) + (EPS,)
    if flags.get("int4"):
        return ck.fused_ln_mlp_int4(
            *args, int8_grad=flags.get("int8_grad", False),
            int8_dw=flags.get("int8_dw", False),
            int4_grad=flags.get("int4_grad", False), residual=False)
    if flags.get("int8"):
        return ck.fused_ln_mlp_int8(
            *args, int8_grad=flags.get("int8_grad", False),
            int8_dw=flags.get("int8_dw", False),
            save_acts=flags.get("save_acts", False), residual=False)
    return ck.fused_ln_mlp(*args, save_acts=flags.get("save_acts", False),
                           residual=False)


def _count(monkeypatch):
    """Counts the calls of every partial wrapper."""
    calls = dict.fromkeys(PARTIALS, 0)
    for name in PARTIALS:
        fn = getattr(ck, name)
        monkeypatch.setattr(ck, name, lambda *a, _f=fn, _n=name, **k: (
            calls.__setitem__(_n, calls[_n] + 1), _f(*a, **k))[1])
    return calls


def _hold_against_vitax(flags, dtype, monkeypatch):
    """The port's partial half and its grads against vitax's; returns the
    partial wrappers' calls."""
    j, t = _both(_arrays(3), dtype)
    y, vjp = jax.vjp(jax.jit(lambda *a: pk.fused_ln_mlp(
        *a, EPS, residual=False, **flags)), *(j[k] for k in GRADS))
    refs = vjp(j["do"].astype(y.dtype))
    calls = _count(monkeypatch)
    for k in GRADS:
        t[k].requires_grad_(True)
    out = _port_partial(t, flags)
    out.backward(t["do"])
    small, weights = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 2e-2)}[
        dtype]
    if flags.get("int4") and flags.get("int8_dw"):
        weights = 5e-3  # test_torch_int4.py's band for K11-B's int8_dw
    _close(y, out, small, "out")
    for k, r in zip(GRADS, refs):
        _close(r, t[k].grad, weights if k.startswith("w") else small, "d" + k)
    return calls


@pytest.mark.parametrize("tier", sorted(FLAGS))
def test_partial_half_matches_vitax(tier, monkeypatch):
    """fp32: the output and every grad of vitax's `residual=False` half in
    the tier; the port ran the tier's partial forward and backward once
    each (the int8 and int4 forwards keep K2's backward without int8_grad
    or int4_grad, as vitax's)."""
    flags, names = FLAGS[tier]
    calls = _hold_against_vitax(flags, "float32", monkeypatch)
    assert {k: v for k, v in calls.items() if v} == dict.fromkeys(names, 1)


def test_save_acts_without_residual_takes_k12_partial_pair(monkeypatch):
    """The fault this slice repairs: `fused_ln_mlp(save_acts=True,
    residual=False)` ran K2's partial pair, the save dropped, so its
    grads rounded where the recompute backward rounds. It takes K12's
    partial pair now (vitax's _ln_mlp_2d_save with residual=False,
    pallas_kernels.py:2164-2166), and in bf16 its output and grads are
    vitax's."""
    calls = _hold_against_vitax(dict(save_acts=True), "bfloat16",
                                monkeypatch)
    assert {k: v for k, v in calls.items() if v} == {
        "fused_ln_mlp_save_partial": 1, "fused_ln_mlp_bwd_fast_partial": 1}


def _bf16_ulp(a):
    a = np.maximum(np.abs(a), np.float32(2.0 ** -126))
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def test_wide_backward_without_residual_matches_vitax_chunked(monkeypatch):
    """K2's backward at D 1280 (ViT-H/14) on a model shard's M 2560 without
    the residual: `fused_ln_mlp_bwd(..., residual=False)` routes to
    `fused_ln_mlp_bwd_wide_partial`, whose twin matches vitax's chunked
    kernel with residual=False (:1589) on one block of 48 rows."""
    d, m = 1280, 2560
    a = _arrays(5, d, m)
    calls = []
    chunked = pk._ln_mlp_bwd_chunked_call
    monkeypatch.setattr(pk, "_ln_mlp_bwd_chunked_call",
                        lambda *args: calls.append(args[-1]) or
                        chunked(*args))
    _, vjp = jax.vjp(jax.jit(lambda *args: pk.fused_ln_mlp(
        *args, EPS, residual=False)), *(jnp.asarray(a[k]) for k in GRADS))
    refs = [np.asarray(r) for r in vjp(jnp.asarray(a["do"]))]
    assert calls == [False], "vitax did not take its chunked route"
    seen = _count(monkeypatch)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    outs = ck.fused_ln_mlp_bwd(*(t[k] for k in GRADS[:6]), t["do"], EPS,
                               residual=False)
    assert {k: v for k, v in seen.items() if v} == {
        "fused_ln_mlp_bwd_wide_partial": 1}
    for i in (0, 1, 2, 4, 6):  # dx, dγ, dβ, db1, db2
        _close(refs[i], outs[i], 1e-5, "d" + GRADS[i])
    for i in (3, 5):
        port = outs[i].to(torch.bfloat16).float().numpy()
        ulp = _bf16_ulp(np.maximum(np.abs(port), np.abs(refs[i])))
        bound = np.maximum(ulp, 1e-5 * np.abs(refs[i]).max())
        assert np.all(np.abs(port - refs[i]) <= bound), "d" + GRADS[i]


# the residual wrappers whose `residual=False` is a new branch: forwards
# (their first output is the half's) and backwards (dx first)
FORWARDS = ("fused_ln_mlp_int8", "fused_ln_mlp_int4", "fused_ln_mlp_save",
            "fused_ln_mlp_int8_save")
BACKWARDS = ("fused_ln_mlp_int8_bwd", "fused_ln_mlp_int8_dw_bwd",
             "fused_ln_mlp_int4_bwd", "fused_ln_mlp_int4_dw_bwd",
             "fused_ln_mlp_bwd_fast", "fused_ln_mlp_int8_save_bwd",
             "fused_ln_mlp_int8_save_dw_bwd", "fused_ln_mlp_bwd_wide")


@pytest.mark.parametrize("name", FORWARDS + BACKWARDS)
def test_partial_twins_are_the_residual_twins_less_the_residual(name):
    """bf16, as on the card: the residual forward's output is bf16(x +
    partial) to the bit and every saved activation the same bits; the
    residual backward's dx is bf16(do + dx_partial) to the bit and every
    other grad the same bits."""
    _, t = _both(_arrays(7), "bfloat16")
    fn = getattr(ck, name)
    mlp = tuple(t[k] for k in GRADS[:6])
    with torch.no_grad():
        if name in FORWARDS:
            args = mlp + (t["b2"], EPS)
            full, part = fn(*args), fn(*args, residual=False)
            full, part = (o if isinstance(o, tuple) else (o,)
                          for o in (full, part))
            assert torch.equal(full[0], t["x"] + part[0])
        else:
            if name.endswith("fast"):
                _, h1, gp = ck.fused_ln_mlp_save(*mlp, t["b2"], EPS)
                args = mlp[:4] + (t["w2"], h1, gp, t["do"], EPS)
            elif "save" in name:
                _, *codes = ck.fused_ln_mlp_int8_save(*mlp, t["b2"], EPS)
                args = mlp[:4] + (t["w2"], *codes, t["do"], EPS)
            else:
                args = mlp + (t["do"], EPS)
            full, part = fn(*args), fn(*args, residual=False)
            assert torch.equal(full[0], t["do"] + part[0])
            assert not torch.equal(full[0], part[0])
    for a, b in zip(full[1:], part[1:]):
        assert torch.equal(a, b)
