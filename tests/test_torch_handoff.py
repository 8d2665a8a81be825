"""The int8 block handoff of vitax_torch (K5, `fused_block_int8_handoff`)
and the fast recipe's path through it, against vitax's on CPU.

vitax's Pallas kernels run in interpret mode; the port's wrappers, given CPU
tensors, run their plain twins. Held: the row pack against vitax's
pack_stream; one block (values, packed outputs and all 17 grads) against
vitax's custom VJP; `vit.apply` on a 3-layer tiny config at spq 24 (logits
and grads) against vitax's handoff loop; the port's handoff against its own
non-handoff int8 path (the same in fp32; in bf16 each half within one bf16
ulp, the handoff's fp32 residual add being one rounding apart from the
non-handoff bf16 add); the gate on vitax's auto conditions; `train_cli`
with the recipe's flags on the tiny model, with exact twin counts.

int8_dw groups: where the port's group differs from vitax's (K4: 128 rows
against a grid step's chunk), the test sets the port's to vitax's, computed
with vitax's own geometry helpers (`_vitax_mlp_dw_group`).

Tolerance, max|port - vitax| <= tol * max(1, max|vitax|): fp32 1e-4 for
activations and vector grads, 1e-3 for weight grads; bf16 2e-2 (as
tests/test_torch_int8.py).
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from vitax.core.config import arch_config as j_arch  # noqa: E402
from vitax.models import vit as jvit  # noqa: E402
from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax_torch import train_cli  # noqa: E402
from vitax_torch.core.config import ARCH_PRESETS  # noqa: E402
from vitax_torch.core.config import arch_config as t_arch  # noqa: E402
from vitax_torch.models import vit as tvit  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402
from vitax_torch.train import param_leaves  # noqa: E402

D, H, HD, M, EPS = 128, 2, 64, 256, 1e-5
TOL = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 2e-2)}
# share of packed codes that may sit one step from vitax's (LN sums in
# another order move a value across a .5 tie; see test_torch_int8.py)
CODE_SHARE = 1e-3
INT8_GRAD = dict(int8_mlp=True, int8_attn=True, int8_mlp_grad=True,
                 int8_attn_grad=True)
# bf16 model-level grads of the int8 tier, port vs vitax, per tensor
# ‖Δ‖/‖vitax‖: 3.2e-2 at worst here, 2.7e-2 to 4.0e-2 over other seeds and
# batches, and the same with the handoff or int8_dw off (measured)
BF16_GRAD_BAND = 5e-2


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _vitax_mlp_dw_group(n, padded):
    """vitax's int8_dw group of K4's backward over n stream rows: one grid
    step's chunk, _ln_mlp_rows // _bwd_chunks (pallas_kernels.py:1393,
    :1405), n first padded to its row block off the handoff path (:2123)."""
    if padded:
        n = pk._ln_mlp_pad(n, int8=True)
    rows = pk._ln_mlp_rows(n, int8=True)
    return rows // pk._bwd_chunks(rows)


def _close(ref, out, tol, what):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    out = out.detach().float().numpy().reshape(ref.shape)
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= bound, f"{what}: max error {err:.3e} > {bound:.3e}"


def _moved(q_j, q_t):
    d = np.abs(np.asarray(q_j, np.int32).reshape(-1)
               - q_t.numpy().astype(np.int32).reshape(-1))
    return d.max(), d.mean()


# ------------------------------------------------------------- one block

_BLOCK = ("x", "g1", "be1", "wqkv", "bqkv", "wo", "bo", "g2", "be2", "w1",
          "b1", "w2", "b2", "gn", "ben")
_MATS = ("x", "wqkv", "wo", "w1", "w2")


def _block_arrays(seed, batch, spq):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(x=n(batch, spq, D) * 1.5 + 0.3, g1=1 + n(D, scale=0.1),
                be1=n(D, scale=0.1), wqkv=n(D, 3 * H * HD, scale=D ** -0.5),
                bqkv=n(3 * H * HD, scale=0.1),
                wo=n(H * HD, D, scale=(H * HD) ** -0.5), bo=n(D, scale=0.1),
                g2=1 + n(D, scale=0.1), be2=n(D, scale=0.1),
                w1=n(D, M, scale=D ** -0.5), b1=n(M, scale=0.1),
                w2=n(M, D, scale=M ** -0.5), b2=n(D, scale=0.1),
                gn=1 + n(D, scale=0.1), ben=n(D, scale=0.1),
                c=n(batch, spq, D))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_rows_matches_vitax_pack_stream(dtype):
    a = _block_arrays(0, 3, 16)
    x = jnp.asarray(a["x"], getattr(jnp, dtype))
    q_j, s_j = pk.pack_stream(x, jnp.asarray(a["g1"]), jnp.asarray(a["be1"]),
                              EPS)
    q_t, s_t = ck.pack_rows(torch.from_numpy(a["x"]).to(getattr(torch, dtype)),
                            torch.from_numpy(a["g1"]),
                            torch.from_numpy(a["be1"]), EPS)
    assert q_t.shape == (48, D) and s_t.shape == (48,)
    top, share = _moved(q_j, q_t)
    assert top <= 1 and share <= CODE_SHARE, share
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j)[..., 0].ravel(),
                               rtol=1e-6)


@pytest.mark.parametrize("int8_dw", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_handoff_twin_matches_vitax(dtype, int8_dw):
    """`fused_block_int8_handoff_ref` against vitax's
    `fused_block_int8_handoff` on the same packed input: r2, the packed
    output (codes and scales) and the grads of all 17 inputs under the loss
    Σ r2·c. 3 images at spq 16 (seq_len 10): 48 rows, one int8_dw group of
    K4 and whole images for K3 in both packages."""
    a = _block_arrays(1, 3, 16)
    dt = dtype
    j = {k: jnp.asarray(v, getattr(jnp, dt) if k in _MATS else jnp.float32)
         for k, v in a.items()}
    xq_j, sx_j = pk.pack_stream(j["x"], j["g1"], j["be1"], EPS)
    seq, n = 10, 48

    def run(x, sx, *rest):
        return pk.fused_block_int8_handoff(x, xq_j, sx, *rest, EPS, seq, H,
                                           HD, int8_dw)

    floats = [j["x"], sx_j] + [j[k] for k in _BLOCK[1:]]
    out_j = run(*floats)
    c = j["c"]

    def loss(*args):
        return jnp.sum(run(*args)[0].astype(jnp.float32) * c)

    g_j = jax.grad(loss, argnums=tuple(range(len(floats))))(*floats)

    t = {k: torch.from_numpy(v).to(getattr(torch, dt) if k in _MATS
                                   else torch.float32)
         for k, v in a.items()}
    leaves = {k: t[k].clone().requires_grad_() for k in _BLOCK}
    xq = torch.from_numpy(np.array(xq_j).reshape(n, D))
    sx = torch.from_numpy(np.array(sx_j)[..., 0].reshape(n)).requires_grad_()
    lv = [leaves[k] for k in _BLOCK]
    r2, xqn, sxn = ck.fused_block_int8_handoff_ref(
        lv[0], xq, sx, *lv[1:], EPS, seq, H, HD, int8_dw)
    assert r2.dtype == t["x"].dtype and xqn.dtype == torch.int8
    small, weights = TOL[dtype]
    _close(out_j[0], r2, small, "r2")
    top, share = _moved(out_j[1], xqn)
    assert top <= 1 and share <= CODE_SHARE, share
    np.testing.assert_allclose(sxn.detach().numpy(),
                               np.asarray(out_j[2])[..., 0].ravel(),
                               rtol=1e-2 if dtype == "bfloat16" else 1e-6)
    (r2.float() * t["c"]).sum().backward()
    # 17 inputs: xq is int8 (float0 in vitax, no grad here); sx, gn and ben
    # get zeros from vitax and no gradient from the port's Function
    grads_j = dict(zip(["x", "sx"] + list(_BLOCK[1:]), g_j))
    for k in ("sx", "gn", "ben"):
        assert not np.any(np.asarray(grads_j[k]))
    assert sx.grad is None and leaves["gn"].grad is None
    assert leaves["ben"].grad is None and not xq.requires_grad
    for k in _BLOCK[:-2]:
        tol = weights if k.startswith("w") else small
        assert leaves[k].grad.dtype == leaves[k].dtype, k
        _close(grads_j[k], leaves[k].grad, tol, f"d{k}")


# ------------------------------------------------------------ vit.apply

SMALL = dict(emb_dim=D, mlp_dim=M, num_heads=H, num_layers=3)


def _cfgs(dtype, image=32, patch=8, **kw):
    kw = dict(fused_qkv=True, fused_mlp=True, use_pallas=True,
              patch_size=(patch, patch), **SMALL, **kw)
    return (j_arch("tiny", image, 10).replace(dtype=getattr(jnp, dtype), **kw),
            t_arch("tiny", image, 10).replace(dtype=getattr(torch, dtype),
                                               **kw))


def _weights(jc):
    p = jax.tree.map(np.asarray, jvit.init_params(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        p)


def _images(batch, image=32, seed=1):
    return np.random.default_rng(seed).uniform(
        -1, 1, (batch, image, image, 3)).astype(np.float32)


def _vitax_layout(tree):
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return t.detach().float().numpy()

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = jax.tree.map(lambda *a: np.stack(a),
                                 *[conv(lp) for lp in tree["layers"]])
    return out


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grad_tree(v) for v in tree]
    return tree.grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_handoff_apply_matches_vitax(dtype, monkeypatch):
    """32px at patch 8: 17 tokens, spq 24 <= 128, so both packages take the
    handoff; int8_dw on. Logits and the grads of every parameter under
    Σ logits², vitax's int8_dw groups (K4: 2 chunks of 48 rows of the 96).
    Every parameter grad is a sum over rows, held at the weight grads'
    tolerance: where a dqkv value sits on a .5 tie its dqq code moves one
    step between the packages (one in ~4e4 codes, test_torch_int8.py), which
    moves its row's dxn by a quantization step; in fp32 that moves layer 0's
    LN1 grads by 2.0e-4 and the embedding's by 1.5e-4 of their max, the same
    on vitax's non-handoff path (measured). In bf16, where the packages
    round at other places too, such moves compound over the 3 layers: each
    grad is held to ‖Δ‖/‖vitax‖ <= BF16_GRAD_BAND instead."""
    jc, tc = _cfgs(dtype, **INT8_GRAD, int8_dw=True)
    monkeypatch.setattr(ck, "MLP_DW_GROUP", _vitax_mlp_dw_group(96, False))
    w = _weights(jc)
    img = _images(4)
    calls = []
    orig = ck.fused_block_int8_handoff
    monkeypatch.setattr(ck, "fused_block_int8_handoff",
                        lambda *a: calls.append(1) or orig(*a))
    jp = jax.tree.map(jnp.asarray, w)
    jimg = jnp.asarray(img, jc.dtype)

    def jloss(p):
        out = jvit.apply(p, jimg, jc)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    (_, ref), g_j = jax.value_and_grad(jloss, has_aux=True)(jp)
    params = tvit.params_from_jax(w)
    for p in param_leaves(params):
        p.requires_grad_(True)
    out = tvit.apply(params, torch.from_numpy(img).to(tc.dtype), tc)
    out.float().square().sum().backward()
    assert len(calls) == 3
    small, weights = TOL[dtype]
    _close(ref, out, small, "logits")
    grads = _vitax_layout(_grad_tree(params))
    ref_g = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, g_j))[0]
    out_g = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    for path, r in ref_g:
        name = jax.tree_util.keystr(path)
        if "key" in name and "bias" in name:
            continue  # exact grad 0: both sides return rounding noise
        if dtype == "float32":
            _close(r, torch.from_numpy(out_g[path]), weights, name)
        else:
            rel = np.linalg.norm(out_g[path] - r) / np.linalg.norm(r)
            assert rel <= BF16_GRAD_BAND, (name, rel)


@pytest.mark.parametrize("int8_dw", [False, True])
def test_handoff_equals_the_int8_path_in_fp32(int8_dw, monkeypatch):
    """In fp32 the fp32 residual add is the non-handoff add: logits and
    every grad are the same bits with the handoff on and off."""
    _, tc = _cfgs("float32", **INT8_GRAD, int8_dw=int8_dw)
    params = tvit.init_params(torch.Generator().manual_seed(0), tc)
    img = torch.from_numpy(_images(4))

    def run():
        for p in param_leaves(params):
            p.grad = None
            p.requires_grad_(True)
        out = tvit.apply(params, img, tc)
        out.square().sum().backward()
        return out.detach(), [p.grad.clone() for p in param_leaves(params)]

    calls = []
    orig = ck.fused_block_int8_handoff
    monkeypatch.setattr(ck, "fused_block_int8_handoff",
                        lambda *a: calls.append(1) or orig(*a))
    out_ho, g_ho = run()
    assert len(calls) == 3
    monkeypatch.setattr(tvit, "_int8_handoff", lambda *a: False)
    out, g = run()
    assert len(calls) == 3
    assert torch.equal(out_ho, out)
    for a, b in zip(g_ho, g):
        assert torch.equal(a, b)


def _ulp(m):
    """bf16's spacing at magnitude m (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(m.clamp_min(1e-30))) - 7)


def test_handoff_halves_within_one_bf16_ulp_of_the_int8_path():
    """bf16, along the handoff's own stream, layer by layer: each half
    against the non-handoff half on the same input differs by the place of
    one rounding (bf16(f32(x) + y) against x + bf16(y)), at most one bf16
    ulp at the magnitude of its operands, max(|in|, |out|), on the real rows
    (pad rows carry confined garbage)."""
    dt = torch.bfloat16
    _, tc = _cfgs("bfloat16", **INT8_GRAD, int8_dw=True)
    params = tvit.init_params(torch.Generator().manual_seed(0), tc)
    x = tvit.embed(params, torch.from_numpy(_images(8)).to(dt), tc)
    s = x.shape[1]
    x = torch.nn.functional.pad(x, (0, 0, 0, 24 - s))
    layers = params["layers"]
    xq = sx = None
    with torch.no_grad():
        for i, lp in enumerate(layers):
            nxt = (layers[i + 1]["ln1"] if i + 1 < len(layers)
                   else params["encoder_norm"])
            p, mlp = lp["attn"], lp["mlp"]
            wqkv, bqkv = tvit._merged_qkv(p, dt)
            r1, xq2, sx2 = ck.fused_ln_qkvo_attention_int8_ho(
                x, xq, sx, lp["ln1"]["scale"], lp["ln1"]["bias"],
                lp["ln2"]["scale"], lp["ln2"]["bias"], wqkv, bqkv,
                p["out"]["kernel"].to(dt).reshape(H * HD, D), p["out"]["bias"],
                EPS, s, H, HD)
            r2, xqn, sxn = ck.fused_ln_mlp_int8_ho(
                r1, xq2, sx2, nxt["scale"], nxt["bias"],
                mlp["fc1"]["kernel"].to(dt), mlp["fc1"]["bias"],
                mlp["fc2"]["kernel"].to(dt), mlp["fc2"]["bias"], EPS)
            for half, inp, ho, plain in (
                    ("attention", x, r1,
                     x + tvit._fused_block_attention(x, lp, tc, s)),
                    ("mlp", r1, r2, tvit._fused_block_mlp(r1, lp, tc))):
                ho, plain, inp = (t.float()[:, :s] for t in (ho, plain, inp))
                mag = torch.maximum(torch.maximum(ho.abs(), plain.abs()),
                                    inp.abs())
                assert ((ho - plain).abs() <= _ulp(mag)).all(), (i, half)
                assert not torch.equal(ho, plain)  # the rounding differs
            x, xq, sx = r2, xqn, sxn


# ------------------------------------------------------------- the gate

class _Taken(Exception):
    pass


class _NotTaken(Exception):
    pass


@pytest.mark.parametrize("case", [
    # (flags, batch, image, patch, train with dropout, vitax hands off)
    (dict(INT8_GRAD), 2, 32, 8, False, True),      # spq 24
    (dict(INT8_GRAD, int8_dw=True), 2, 32, 8, False, True),
    (dict(int8_mlp=True, int8_attn=True), 2, 32, 8, False, False),
    (dict(INT8_GRAD), 2, 48, 4, False, False),     # spq 152, 304 rows
    (dict(INT8_GRAD), 384, 48, 4, False, True),    # spq 152, 58368 rows
    (dict(INT8_GRAD), 2, 32, 8, True, False),      # dropout
], ids=["int8-grad", "int8-dw", "int8-fwd", "spq152", "rows58368",
        "dropout"])
def test_handoff_gate_is_vitaxs_auto_condition(case, monkeypatch):
    """Whether the port takes the handoff where vitax's auto gate does
    (vitax/models/vit.py:506-516): each package is stopped at its first
    block's kernel, which tells which path it took. The row counts are ones
    that vitax's TPU row block divides (block_handoff_supported :3852),
    which the port does not copy: at 51224 rows vitax refuses the handoff
    for its geometry alone, where the port takes it."""
    flags, batch, image, patch, dropout, handoff = case
    jc, tc = _cfgs("float32", image=image, patch=patch, **flags)
    if dropout:
        jc, tc = jc.replace(dropout_rate=0.1), tc.replace(dropout_rate=0.1)
    w = _weights(jc)
    img = _images(batch, image=image)

    def raiser(exc):
        def f(*a, **k):
            raise exc
        return f

    monkeypatch.setattr(pk, "fused_block_int8_handoff", raiser(_Taken))
    monkeypatch.setattr(pk, "fused_ln_qkvo_attention", raiser(_NotTaken))
    monkeypatch.setattr(ck, "fused_block_int8_handoff", raiser(_Taken))
    monkeypatch.setattr(ck, "fused_ln_qkvo_attention_int8",
                        raiser(_NotTaken))
    monkeypatch.setattr(ck, "fused_ln_qkvo_attention", raiser(_NotTaken))
    monkeypatch.setattr(tvit, "_attention", raiser(_NotTaken))
    monkeypatch.setattr(jvit, "_attention", raiser(_NotTaken))
    with pytest.raises((_Taken, _NotTaken)) as ref:
        jvit.apply(jax.tree.map(jnp.asarray, w), jnp.asarray(img), jc,
                   train=dropout, rng=jax.random.PRNGKey(0))
    with pytest.raises((_Taken, _NotTaken)) as out:
        tvit.apply(tvit.params_from_jax(w), torch.from_numpy(img), tc,
                   train=dropout, gen=torch.Generator().manual_seed(0))
    assert ref.type is (_Taken if handoff else _NotTaken)
    assert out.type is ref.type


# ------------------------------------------------------------ train_cli

TINY = ["--dataset", "Synthetic", "--model-arch", "tiny", "--num-workers", "0",
        "--dtype", "float32", "--fused-qkv", "--fused-mlp"]
# the tiny preset at D 128 (2 heads of 64): vitax's fused gates take D %
# 128 == 0 only, and the port picks its fused halves where they do
WIDE_TINY = dict(patch=16, emb_dim=128, mlp_dim=256, num_heads=2,
                 num_layers=3)


def test_train_cli_fast_recipe_flags_run_the_handoff_twins(tmp_path,
                                                          monkeypatch):
    """`--int8-dw --token-keep 0.5 --token-keep-schedule 0.5` at image 224
    on the tiny model: a drop epoch (1 + 98 tokens, spq 104: K5 and the
    int8_dw backwards) and a dense epoch (spq 200: K3/K4 forward and the
    int8_dw backwards), each 2 steps of batch 4 through 3 layers, and an
    eval epoch of 2 batches after each (full sequence, K3/K4 forward)."""
    names = ("fused_ln_qkvo_attention_int8_ho_ref", "fused_ln_mlp_int8_ho_ref",
             "fused_ln_qkvo_attention_int8_ref", "fused_ln_mlp_int8_ref",
             "fused_ln_qkvo_attention_int8_dw_bwd_ref",
             "fused_ln_mlp_int8_dw_bwd_ref",
             "fused_ln_qkvo_attention_int8_bwd_ref",
             "fused_ln_mlp_int8_bwd_ref")
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(ck, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(ck, name, counted)
    monkeypatch.setitem(ARCH_PRESETS, "tiny", WIDE_TINY)
    out = train_cli.main(TINY + [
        "--image-size", "224", "--batch-size", "4", "--synthetic-samples", "8",
        "--train-steps", "4", "--warmup-steps", "0", "--int8-dw",
        "--token-keep", "0.5", "--token-keep-schedule", "0.5",
        "--exp-root", str(tmp_path)], device="cpu")
    losses = [v for e in out["epochs"] for v in e["train"]["losses"]]
    assert len(losses) == 4 and all(map(math.isfinite, losses))
    # the int8_dw twins run the int8 backward twins with int8_dw on
    assert calls == {"fused_ln_qkvo_attention_int8_ho_ref": 6,
                     "fused_ln_mlp_int8_ho_ref": 6,
                     "fused_ln_qkvo_attention_int8_ref": 18,
                     "fused_ln_mlp_int8_ref": 18,
                     "fused_ln_qkvo_attention_int8_dw_bwd_ref": 12,
                     "fused_ln_mlp_int8_dw_bwd_ref": 12,
                     "fused_ln_qkvo_attention_int8_bwd_ref": 12,
                     "fused_ln_mlp_int8_bwd_ref": 12}
