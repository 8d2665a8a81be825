"""Res-ViT's int4 (A4W4) tiers in vitax_torch against vitax's: the rect
attention half's A4W4 forward (R-F) and int4_grad backward with and without
int8_dw (R-B, R-B dw), the kv_heads branches of K11's attention half (G-F,
G-B), the autograd Functions' tiers, `resvit.apply` in training with each
int4 flag set, and `resvit_train_cli` with the int4 flags.

The twins (vitax_torch/ops/cuda_kernels.py) against vitax's Pallas kernels
in interpret mode; the kernels themselves are held against these twins on
the card (tests/test_torch_cuda_kernels.py, chip_smoke.py phase 14).

Shapes: D 128, 2 heads of 64 (GQA: 1 kv head), spq 24 with 19 keys, the
rect half's xc on 13 of them (cpq 16, zero pad rows), batch 2 and 4.
Tolerances, max|port - vitax| <= tol·max(1, max|vitax|) per output
(tests/test_torch_int4.py's): fp32 1e-4 for activations and vector grads,
5e-3 for weight grads (under int8_dw a column code on a .5 tie of its int8
grid moves one step), bf16 1e-2; the weights' codes bit for bit. The
models: 2 layers (a plain one, a routed block head), fp32, vitax's Gumbel
noise injected, logits 1e-4, grads 1e-3·max(1, max|g|), keep bits and
routing maps exact.
"""

import collections

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_resvit_train import (  # noqa: E402,F401
    FUSED, _batch, _cfgs, _close, _loss_parts, _paths, _torch_noise,
    _trainable_paths, _weights, interpret_mode, vitax_noise,
    vitax_path_ids_from_the_keep_bits)
from tests.test_torch_resvit_train_cli import (  # noqa: E402,F401
    TRAIN, _vitax_main, same_weights)
from vitax import resvit_train_cli as j_train  # noqa: E402
from vitax.core import config as j_config  # noqa: E402
from vitax.models import resvit as jr  # noqa: E402
from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax_torch import resvit_train_cli as t_train  # noqa: E402
from vitax_torch.core import config as t_config  # noqa: E402
from vitax_torch.models import resvit as tr  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402
from vitax_torch.train.optim import tree_leaves  # noqa: E402

D, H, HKV, HD, SPQ, SEQ, CAP, EPS = 128, 2, 1, 64, 24, 19, 13, 1e-5
CPQ = (CAP + 7) // 8 * 8
TOL = {"float32": (1e-4, 5e-3), "bfloat16": (1e-2, 1e-2)}
RECT_GRADS = ("dxc", "dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwo", "dbo")
QKVO_GRADS = ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwo", "dbo")
_MATS = ("x", "xc", "do", "wqkv", "wo")


def _arrays(seed, batch, kv_heads=H, rect=False):
    """x [B, spq, D] (pad rows zero past SEQ), the weights at the packed
    width (H + 2·kv_heads)·HD; with `rect` xc (CAP of x's first SEQ rows in
    random order, zero-padded to CPQ) and do on xc's rows (zero on its pad
    rows), else do on x's."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    width = (H + 2 * kv_heads) * HD
    x = n(batch, SPQ, D) * 1.5 + 0.3
    x[:, SEQ:] = 0
    a = dict(x=x, gamma=1 + n(D, scale=0.1), beta=n(D, scale=0.1),
             wqkv=n(D, width, scale=D ** -0.5), bqkv=n(width, scale=0.1),
             wo=n(H * HD, D, scale=(H * HD) ** -0.5), bo=n(D, scale=0.1))
    if rect:
        idx = np.stack([rng.permutation(SEQ)[:CAP] for _ in range(batch)])
        xc = np.zeros((batch, CPQ, D), np.float32)
        xc[:, :CAP] = np.take_along_axis(x, idx[..., None], axis=1)
        a["xc"], a["do"] = xc, n(batch, CPQ, D)
        a["do"][:, CAP:] = 0
    else:
        a["do"] = n(batch, SPQ, D)
    return a


def _both(arrays, dtype):
    j = {k: jnp.asarray(v, getattr(jnp, dtype) if k in _MATS else jnp.float32)
         for k, v in arrays.items()}
    t = {k: torch.from_numpy(v).to(getattr(torch, dtype) if k in _MATS
                                   else torch.float32)
         for k, v in arrays.items()}
    return j, t


def _check_all(refs, outs, dtype, names):
    small, weights = TOL[dtype]
    assert len(refs) == len(outs) == len(names)
    for name, r, o in zip(names, refs, outs):
        _close(r, o, weights if name.startswith("dw") else small, name)


def _same_codes(scratch, key, fn, w):
    q, s = fn(w)
    np.testing.assert_array_equal(scratch[key][0].numpy(), np.asarray(q))
    np.testing.assert_array_equal(scratch[key][1].numpy(), np.asarray(s))


def _same(outs, refs):
    for a, b in zip(outs, refs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


_QKVO = ("x", "gamma", "beta", "wqkv", "bqkv", "wo")
_RECT = ("xc",) + _QKVO


# ------------------------------------------------------------------ R-F

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rect_int4_forward_twin_matches_pallas(dtype):
    """R-F against vitax's fused_ln_qkvo_attention_rect(int4=True) (:4447):
    the kept rows' output; the weights' codes those of vitax's split Wq,
    Wkv (per column of the slices) and Wo; the wrapper on CPU tensors is
    the twin."""
    j, t = _both(_arrays(1, 2, rect=True), dtype)
    ref = pk.fused_ln_qkvo_attention_rect(
        *(j[k] for k in _RECT), j["bo"], EPS, SEQ, H, HD, True, False, False,
        True)
    scratch = {}
    args = (*(t[k] for k in _RECT), t["bo"], EPS, SEQ, H, HD)
    out = ck.fused_ln_qkvo_attention_rect_int4_ref(*args, scratch=scratch)
    assert out.shape == t["xc"].shape and out.dtype == t["xc"].dtype
    _close(ref[:, :CAP], out[:, :CAP], TOL[dtype][0], "out")
    hhd = H * HD
    w8, sw = scratch["w8"]
    for cols, wj in ((slice(0, hhd), j["wqkv"][:, :hhd]),
                     (slice(hhd, 3 * hhd), j["wqkv"][:, hhd:])):
        qj, sj = pk._quant_cols_host4(wj)
        np.testing.assert_array_equal(w8[:, cols].numpy(), np.asarray(qj))
        np.testing.assert_array_equal(sw[cols].numpy(), np.asarray(sj))
    _same_codes(scratch, "wo8", pk._quant_cols_host4, j["wo"])
    assert int(scratch["aq"][0].abs().max()) <= 7
    _same([ck.fused_ln_qkvo_attention_rect_int4(*args)], [out])


# ------------------------------------------------------------ R-B, R-B dw

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8_dw", [False, True], ids=["bf16-dw", "int8-dw"])
@pytest.mark.parametrize("batch", [2, 4])
def test_rect_int4_backward_twin_matches_pallas(dtype, int8_dw, batch):
    """R-B (and R-B dw) against the int4_grad branch of vitax's rect VJP
    (:4534) on every output. The weights' codes vitax's: Wq, Wkv per column
    and per row of the slices, Wo per row, on the int4 grid. Under int8_dw
    the groups are vitax's grid step (tile·cpq rows of xc, tile·spq of x,
    pad rows included), both operands packed fresh per column; the
    bf16-product twin misses those weight grads."""
    j, t = _both(_arrays(2 + batch, batch, rect=True), dtype)
    ref = pk._fused_ln_qkvo_rect_bwd(EPS, SEQ, H, HD, True, True, int8_dw,
                                     True, True, tuple(j[k] for k in _RECT),
                                     j["do"])
    tile = pk._qkvo_bwd_tile(batch, SPQ)
    assert ck.qkvo_rect_dw_groups(batch, CPQ, SPQ) == (tile * CPQ,
                                                       tile * SPQ)
    args = (*(t[k] for k in _RECT), t["do"], EPS, SEQ, H, HD)
    twin = (ck.fused_ln_qkvo_attention_rect_int4_dw_bwd_ref if int8_dw
            else ck.fused_ln_qkvo_attention_rect_int4_bwd_ref)
    scratch = {}
    out = twin(*args, scratch=scratch)
    assert out[0].dtype == out[1].dtype == t["x"].dtype
    assert all(o.dtype == torch.float32 for o in out[2:])
    _check_all(ref, out, dtype, RECT_GRADS)
    hhd = H * HD
    for key, fn, w in (("wq8r", pk._quant_rows_host4, j["wqkv"][:, :hhd]),
                       ("wkv8r", pk._quant_rows_host4, j["wqkv"][:, hhd:]),
                       ("wo8r", pk._quant_rows_host4, j["wo"])):
        _same_codes(scratch, key, fn, w)
    wrapper = (ck.fused_ln_qkvo_attention_rect_int4_dw_bwd if int8_dw
               else ck.fused_ln_qkvo_attention_rect_int4_bwd)
    _same(wrapper(*args), out)
    if int8_dw:
        groups = batch // tile
        assert {"atc", "doc", "xnc", "dqc", "xnk", "dkvc"} <= set(scratch)
        assert scratch["dkvc"][1].numel() == groups * 2 * hhd
        bf = ck.fused_ln_qkvo_attention_rect_int4_bwd_ref(*args)
        assert not torch.equal(bf[4], out[4]) and not torch.equal(bf[6],
                                                                  out[6])


# ------------------------------------------------------------- G-F, G-B

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_gqa_forward_twin_matches_pallas(dtype):
    """G-F against vitax's fused_ln_qkvo_attention(int4=True, kv_heads=1)
    (:3137) on the packed [q | k | v] layout: the output and the weights'
    codes; K11's wrapper with kv_heads routes to G-F's."""
    j, t = _both(_arrays(3, 2, HKV), dtype)
    ref = pk.fused_ln_qkvo_attention(
        *(j[k] for k in _QKVO), j["bo"], EPS, SEQ, H, HD, True, False, False,
        True, False, HKV)
    scratch = {}
    args = (*(t[k] for k in _QKVO), t["bo"], EPS, SEQ, H, HD)
    out = ck.fused_ln_qkvo_attention_int4_gqa_ref(*args, HKV,
                                                  scratch=scratch)
    assert out.shape == t["x"].shape and out.dtype == t["x"].dtype
    _close(ref, out, TOL[dtype][0], "out")
    _same_codes(scratch, "w8", pk._quant_cols_host4, j["wqkv"])
    _same_codes(scratch, "wo8", pk._quant_cols_host4, j["wo"])
    _same([ck.fused_ln_qkvo_attention_int4(*args, kv_heads=HKV),
           ck.fused_ln_qkvo_attention_int4_gqa(*args, HKV)], [out, out])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8_dw", [False, True], ids=["bf16-dw", "int8-dw"])
def test_int4_gqa_backward_twin_matches_pallas(dtype, int8_dw):
    """G-B (and its int8_dw tier) against the int4_grad branch of vitax's
    _fused_ln_qkvo_bwd with kv_heads (:3252) on every output: dK and dV of
    the kv group summed over its query heads; under int8_dw K3's groups
    (whole images, `qkvo_dw_group`), both operands packed fresh per
    column."""
    batch = 4
    j, t = _both(_arrays(4, batch, HKV), dtype)
    ref = pk._fused_ln_qkvo_bwd(EPS, SEQ, H, HD, True, True, int8_dw, True,
                                True, HKV, tuple(j[k] for k in _QKVO),
                                j["do"])
    assert pk._qkvo_bwd_tile(batch, SPQ) * SPQ == ck.qkvo_dw_group(batch,
                                                                   SPQ)
    args = (*(t[k] for k in _QKVO), t["do"], EPS, SEQ, H, HD, HKV)
    twin = (ck.fused_ln_qkvo_attention_int4_gqa_dw_bwd_ref if int8_dw
            else ck.fused_ln_qkvo_attention_int4_gqa_bwd_ref)
    scratch = {}
    out = twin(*args, scratch=scratch)
    assert out[3].shape == t["wqkv"].shape
    _check_all(ref, out, dtype, QKVO_GRADS)
    for key, fn, w in (("w8", pk._quant_cols_host4, "wqkv"),
                       ("w8r", pk._quant_rows_host4, "wqkv"),
                       ("wo8r", pk._quant_rows_host4, "wo")):
        _same_codes(scratch, key, fn, j[w])
    for wrapper in ((ck.fused_ln_qkvo_attention_int4_gqa_dw_bwd,
                     ck.fused_ln_qkvo_attention_int4_dw_bwd) if int8_dw
                    else (ck.fused_ln_qkvo_attention_int4_gqa_bwd,
                          ck.fused_ln_qkvo_attention_int4_bwd)):
        _same(wrapper(*args), out)
    if int8_dw:
        assert {"atc", "doc", "xnc", "dqc"} <= set(scratch)


# ------------------------------------------------- the Functions' tiers

# (flags of the int4 wrapper, the backward twins its grads must equal,
# rect and GQA): vitax's (:4526 for the rect half, :3246 for the square
# one), int4_grad only under int8_grad
_A = "fused_ln_qkvo_attention_"
TIERS = {
    "int4": ({}, _A + "rect_bwd_ref", _A + "gqa_bwd_ref"),
    "int4+int8-grad": (dict(int8_grad=True), _A + "rect_int8_bwd_ref",
                       _A + "int8_gqa_bwd_ref"),
    "int4-grad alone": (dict(int4_grad=True), _A + "rect_bwd_ref",
                        _A + "gqa_bwd_ref"),
    "int4-grad+int8-grad": (dict(int4_grad=True, int8_grad=True),
                            _A + "rect_int4_bwd_ref",
                            _A + "int4_gqa_bwd_ref"),
    "int4-grad+int8-dw": (dict(int4_grad=True, int8_grad=True, int8_dw=True),
                          _A + "rect_int4_dw_bwd_ref",
                          _A + "int4_gqa_dw_bwd_ref"),
}


@pytest.mark.parametrize("half,tier", [(h, k) for h in ("rect", "gqa")
                                       for k in TIERS])
def test_int4_functions_dispatch_as_vitax(half, tier):
    """Under autograd the int4 forward is the twin's and the grads are those
    of vitax's backward for the tier: R-B (G-B) only under int8_grad and
    int4_grad, K8's (K7's) int8 backward under int8_grad alone, else the
    bf16 one."""
    flags, rect_bwd, gqa_bwd = TIERS[tier]
    rect = half == "rect"
    _, t = _both(_arrays(6, 2, H if rect else HKV, rect=rect), "float32")
    keys = _RECT if rect else _QKVO
    tail = (EPS, SEQ, H, HD)
    fwd, kw, extra = ((ck.fused_ln_qkvo_attention_rect_int4, {}, ()) if rect
                      else (ck.fused_ln_qkvo_attention_int4,
                            dict(kv_heads=HKV), (HKV,)))
    leaves = [t[k].clone().requires_grad_() for k in keys]
    y = fwd(*leaves, t["bo"], *tail, **flags, **kw)
    with torch.no_grad():
        _same([y], [fwd(*(t[k] for k in keys), t["bo"], *tail, **kw)])
    y.backward(t["do"])
    grads = getattr(ck, rect_bwd if rect else gqa_bwd)(
        *(t[k] for k in keys), t["do"], *tail, *extra)
    for leaf, g in zip(leaves, grads):
        torch.testing.assert_close(leaf.grad, g.to(leaf.dtype), rtol=0,
                                   atol=0)


# ------------------------------------------------------------ resvit.apply

INT8 = dict(int8_attn=True, int8_mlp=True)
# resvit_train_cli's flag sets (vitax/resvit_train_cli.py:219-259: the int4
# flags imply --int4, which implies --int8, and --int8-dw --int8-grad)
FLAG_SETS = {
    "--int4": dict(INT8, int4_mlp=True),
    "--int4-attn": dict(INT8, int4_mlp=True, int4_attn=True),
    "--int4-attn --int4-grad --int8-grad": dict(
        INT8, int4_mlp=True, int4_attn=True, int4_grad=True,
        int8_attn_grad=True, int8_mlp_grad=True),
    "--int4-attn --int4-grad --int8-dw": dict(
        INT8, int4_mlp=True, int4_attn=True, int4_grad=True,
        int8_attn_grad=True, int8_mlp_grad=True, int8_dw=True),
}
# dense, compacted (the rect half on the routed layer), GQA compacted (the
# rect half declines: G-F on all rows and a gather)
MODES = {"dense": {}, "C 0.625": dict(compact_capacity=0.625),
         "kv 1, C 0.625": dict(n_kv_heads=1, compact_capacity=0.625)}
TWINS = tuple(f"fused_ln_qkvo_attention_{t}ref" for t in (
    "", "gqa_", "int8_", "int8_gqa_", "int4_", "int4_gqa_", "rect_",
    "rect_int8_", "rect_int4_", "bwd_", "gqa_bwd_", "int8_bwd_",
    "int8_gqa_bwd_", "int8_dw_bwd_", "int8_gqa_dw_bwd_", "int4_bwd_",
    "int4_gqa_bwd_", "int4_dw_bwd_", "int4_gqa_dw_bwd_", "rect_bwd_",
    "rect_int8_bwd_", "rect_int8_dw_bwd_", "rect_int4_bwd_",
    "rect_int4_dw_bwd_")) + tuple(f"fused_ln_mlp_{t}ref" for t in (
        "", "int8_", "int4_", "bwd_", "int8_bwd_", "int8_dw_bwd_",
        "int4_bwd_", "int4_dw_bwd_"))


def _count_twins(monkeypatch):
    """Counts each call of a half's twin that no other counted twin made
    (the GQA twins call the square ones, the dw twins the others)."""
    calls, depth = collections.Counter(), [0]
    for name in TWINS:
        fn = getattr(ck, name)

        def twin(*a, _f=fn, _n=name, **k):
            if depth[0] == 0:
                calls[_n] += 1
            depth[0] += 1
            try:
                return _f(*a, **k)
            finally:
                depth[0] -= 1
        monkeypatch.setattr(ck, name, twin)
    return calls


def _expected_twins(flags, mode):
    """vitax's dispatch (vitax/models/resvit.py:340-415) on the 2 layers: the
    student's plain layer and routed layer, the teacher's routed layer
    (forward only, dense), the student's backwards. The attention forward
    is K11-C (G-F with GQA) under int4_attn, else K3 (K7's int8 tier); its
    backward R-B/K11-D/G-B only under int8_grad and int4_grad, else the
    bf16 one (no int8_grad without int4_grad here); the MLP half K11-A,
    its backward K11-B under int4_grad, else K2's."""
    f = FLAG_SETS[flags]
    gqa = "gqa_" if "kv 1" in mode else ""
    rect = "C" in mode and not gqa
    fwd = "int4_" if f.get("int4_attn") else "int8_"
    bwd = ("int4_" if f.get("int8_attn_grad") else "") + \
        "dw_" * f.get("int8_dw", False)
    square_bwd = bwd.replace("dw_", gqa + "dw_") if "dw_" in bwd \
        else bwd + gqa
    a = "fused_ln_qkvo_attention_"
    c = collections.Counter({f"{a}{fwd}{gqa}ref": 3 - rect,
                             f"{a}{square_bwd}bwd_ref": 2 - rect})
    if rect:
        c[f"{a}rect_{fwd}ref"] += 1
        c[f"{a}rect_{bwd}bwd_ref"] += 1
    c["fused_ln_mlp_int4_ref"] = 3
    c["fused_ln_mlp_" + ("int4_" + "dw_" * f.get("int8_dw", False)
                         if f.get("int4_grad") else "") + "bwd_ref"] = 2
    return c


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("flags", list(FLAG_SETS))
def test_apply_int4_train_matches_vitax(flags, mode, monkeypatch):
    """apply(train=True) with each int4 flag set, fp32, vitax's Gumbel noise
    injected: the logits, the distill loss, the keep bits and routing maps,
    and the grads of the 3-term loss for every trainable leaf against
    vitax's; the twins that ran are the ones vitax's dispatch picks."""
    jc, tc = _cfgs(**FUSED, **FLAG_SETS[flags], **MODES[mode], n_layers=2,
                   block_size=1, use_lora=False)
    w = _weights(jc)
    img, labels = _batch(2)
    key = jax.random.PRNGKey(11)
    noise = vitax_noise(key, jc, 2)

    def j_loss(p):
        logits, aux = jr.apply(p, jnp.asarray(img), jc, train=True, rng=key)
        return _loss_parts(logits, jnp.asarray(labels), aux, jc, jnp), \
            (logits, aux)

    (_, (jlogits, jaux)), jgrads = jax.value_and_grad(j_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, w))
    tp = tr.params_from_jax(w)
    for t, m in zip(tree_leaves(tp), tree_leaves(tr.trainable_mask(tp, tc))):
        t.requires_grad_(m)
    calls = _count_twins(monkeypatch)
    logits, aux = tr.apply(tp, torch.from_numpy(img), tc, train=True,
                           noise=_torch_noise(noise))
    _loss_parts(logits, torch.from_numpy(labels), aux, tc, torch).backward()
    assert calls == _expected_twins(flags, mode)
    _close(jlogits, logits, 1e-4, "logits")
    _close(jaux["d_loss"], aux["d_loss"], 1e-4, "d_loss")
    np.testing.assert_array_equal(np.asarray(jaux["acts"]).round(),
                                  aux["acts"].detach().numpy().round())
    assert 0 < float(aux["acts"].detach()[..., 1].mean()) < 1
    for k, m in jaux["routing_maps"].items():  # straight-through 1 - 2^-24
        np.testing.assert_array_equal(
            np.asarray(m).round(), aux["routing_maps"][k].detach().numpy()
            .round())
    trainable = _trainable_paths(jc, w)
    n = 0
    for (path, g), t in zip(_paths(jgrads), tree_leaves(tp)):
        name = jax.tree_util.keystr(path)
        if name in trainable:
            _close(g, t.grad, 1e-3, name)
            n += 1
    assert n == len(trainable) > 0


# ------------------------------------------------------- resvit_train_cli

def _fields(cfg):
    return {k: getattr(cfg, k) for k in (
        "int8_attn", "int8_attn_grad", "int8_mlp", "int8_mlp_grad", "int8_dw",
        "int4_mlp", "int4_attn", "int4_grad")}


@pytest.mark.parametrize("flags", list(FLAG_SETS))
def test_int4_flag_map_is_vitaxs(flags, tmp_path):
    """resvit_train_cli's int4 flags map to vitax's model arguments
    (vitax/resvit_train_cli.py:219-259), the sets the model tests run."""
    argv = flags.split() + ["--exp-root", str(tmp_path)]
    a = j_train.config_to_model_args(j_train.get_train_config(argv))
    b = t_train.config_to_model_args(t_train.get_train_config(argv), "cpu")
    want = dict.fromkeys(_fields(b), False)
    want.update(FLAG_SETS[flags])
    assert _fields(a) == _fields(b) == want


# D 128 (2 heads of 64): vitax's fused gate takes it (D % 128 == 0)
INT4_TINY = dict(patch=16, emb_dim=128, mlp_dim=256, num_heads=2,
                 num_layers=2)


def test_train_cli_int4_grad_int8_dw_compact_matches_vitax(
        same_weights, tmp_path, monkeypatch, capsys):
    """`resvit_train_cli --int4-attn --int4-grad --int8-dw
    --compact-capacity 0.625` for one step on a D 128 preset from the same
    weights: the port prints vitax's warning, its step runs the int4 twins
    vitax's dispatch picks (the plain layer's K11-C and K11-D dw, the routed
    layer's R-F and R-B dw, K11-A and K11-B dw in both), and the epoch's
    validation (lr 0) equals vitax's, within the print rounding."""
    monkeypatch.setattr(pk, "_INTERPRET", True)
    for presets in (t_config.ARCH_PRESETS, j_config.ARCH_PRESETS):
        monkeypatch.setitem(presets, "tiny", INT4_TINY)
    calls = _count_twins(monkeypatch)
    argv = TRAIN + ["--int4-attn", "--int4-grad", "--int8-dw",
                    "--compact-capacity", "0.625", "--compact-warmup", "0",
                    "--fused-qkv", "--fused-mlp", "--block_size", "1", "--train-steps", "1",
                    "--synthetic-samples", "8", "--warmup-steps", "0",
                    "--lr", "0", "--dtype", "float32"]
    capsys.readouterr()
    t_out = t_train.main(argv + ["--exp-root", str(tmp_path / "t")],
                         device="cpu")
    assert "int4 tiers MEASURED DIVERGENT" in capsys.readouterr().out
    step = {k: v for k, v in calls.items() if "bwd" in k}
    assert step == {"fused_ln_qkvo_attention_int4_dw_bwd_ref": 1,
                    "fused_ln_qkvo_attention_rect_int4_dw_bwd_ref": 1,
                    "fused_ln_mlp_int4_dw_bwd_ref": 2}
    assert calls["fused_ln_qkvo_attention_rect_int4_ref"] >= 1
    _, j_valid = _vitax_main(argv + ["--exp-root", str(tmp_path / "j")],
                             monkeypatch, capsys)
    assert len(t_out["epochs"]) == len(j_valid) == 1
    for k, v in j_valid[0].items():
        assert t_out["epochs"][0][k] == pytest.approx(v, abs=5.1e-5), k
