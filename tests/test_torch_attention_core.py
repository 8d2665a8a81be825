"""K13, the standalone attention core (vitax's flash_attention_bhsd and
flash_attention, pallas_kernels.py:228-256), and the `--no-fused-qkv`
paths of ViT that reach it, against vitax on CPU on the same numpy inputs,
vitax's Pallas kernels in interpret mode.

- K13's twins (`flash_attention_bhsd_ref`, `flash_attention_bwd_ref`, and
  `flash_attention` on CPU tensors) against `pk.flash_attention_bhsd`,
  `pk.flash_attention` and their custom VJP at S 21 and 40 (vitax pads the
  query rows to 24 and 40 and the keys to 128, masked), head dims 32, 40,
  64 and 80; the wrappers under autograd give the twins' values and grads.
- `attention_supported` against vitax's gate on a grid of shapes, and the
  dispatch of `multi_head_attention{,_bhsd}`: K13 inside the gate, `mha_ref`
  outside; the raise for fp32 on the card names its queue item.
- The wrapper's layout plumbing, which the kernel relies on: the [B, S, H,
  Hd] memory of the projection einsums is taken as it is, and a head dim
  of 40 is zero-padded to 48 and cut back.
- `vit.apply` with `fused_qkv=False, use_pallas=True` (the LN twin and
  K13's twin, forward and backward): logits and the grads of every leaf.
- `eval_cli` and `train_cli` with `--no-fused-qkv` against vitax's CLIs on
  the tiny preset from one npz, both packages' attention dispatch forced
  onto K13 as on their accelerators.

Tolerances, max|port - vitax| <= tol * max|vitax| per output: the twins
1e-5 in fp32 (the same products and one softmax; sums in another order)
and 2^-7 in bf16 (both round at the same points; a one-ulp flip of a bf16
value is 2^-8 of it); the model and the CLIs 1e-4 (logits, losses) and 1e-3
(grads, sums over the batch) in fp32, 2e-2 in bf16.
"""

import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from vitax import eval_cli as j_eval  # noqa: E402
from vitax import train_cli as j_train  # noqa: E402
from vitax.checkpointing.npz import save_npz_params  # noqa: E402
from vitax.core.config import arch_config as j_arch  # noqa: E402
from vitax.models import vit as jvit  # noqa: E402
from vitax.ops import attention as jatt  # noqa: E402
from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax.train import cross_entropy as j_ce  # noqa: E402
from vitax_torch import eval_cli as t_eval  # noqa: E402
from vitax_torch import train_cli as t_train  # noqa: E402
from vitax_torch.core.config import arch_config as t_arch  # noqa: E402
from vitax_torch.models import vit as tvit  # noqa: E402
from vitax_torch.ops import attention as tatt  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402
from vitax_torch.train import cross_entropy as t_ce  # noqa: E402
from vitax_torch.train import param_leaves  # noqa: E402

TWIN_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
TOL = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 2e-2)}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _close(ref, out, tol, what=""):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    out = out.detach().float().numpy()
    assert out.shape == ref.shape, what
    err = float(np.abs(out - ref).max())
    bound = tol * float(np.abs(ref).max())
    assert err <= bound, f"{what}: {err:.3e} > {bound:.3e}"


def _qkv(seed, s, hd, b=2, h=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, hd)).astype(np.float32)
            for _ in range(4)]


def _pair(a, dtype):
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


# ---------------------------------------------------------------- twins

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 40, 64, 80])
@pytest.mark.parametrize("s", [21, 40])
def test_twin_forward_matches_vitax_in_both_layouts(s, hd, dtype):
    q, k, v, _ = _qkv(0, s, hd)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    ref = pk.flash_attention_bhsd(jq, jk, jv)
    out = ck.flash_attention_bhsd_ref(tq, tk, tv)
    assert out.dtype == tq.dtype
    _close(ref, out, TWIN_TOL[dtype], "bhsd")
    # [B, S, H, Hd]: vitax's transposes, the port's transposed views
    ref_s = pk.flash_attention(*(jnp.transpose(a, (0, 2, 1, 3))
                                 for a in (jq, jk, jv)))
    out_s = ck.flash_attention(*(t.transpose(1, 2).contiguous()
                                 for t in (tq, tk, tv)))
    _close(ref_s, out_s, TWIN_TOL[dtype], "bshd")
    torch.testing.assert_close(ck.flash_attention_bhsd(tq, tk, tv), out,
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 40, 64, 80])
@pytest.mark.parametrize("s", [21, 40])
def test_twin_backward_matches_vitax_vjp(s, hd, dtype):
    """dq, dk, dv from the saved (q, k, v, out), as vitax's custom VJP; the
    autograd Function's grads are the twin's, in both layouts."""
    q, k, v, do = _qkv(1, s, hd)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (_pair(a, dtype)
                                                for a in (q, k, v, do))
    out, vjp = jax.vjp(pk.flash_attention_bhsd, jq, jk, jv)
    refs = vjp(jdo)
    tout = torch.from_numpy(np.array(out, np.float32)).to(tq.dtype)
    grads = ck.flash_attention_bwd_ref(tq, tk, tv, tout, tdo)
    for name, ref, g in zip(("dq", "dk", "dv"), refs, grads):
        assert g.dtype == tq.dtype
        _close(ref, g, TWIN_TOL[dtype], name)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    y = ck.flash_attention_bhsd(*leaves)
    assert type(y.grad_fn).__name__ == "FlashAttentionFnBackward"
    y.backward(tdo)
    own = ck.flash_attention_bwd_ref(tq, tk, tv, y.detach(), tdo)
    for leaf, g in zip(leaves, own):
        assert torch.equal(leaf.grad, g)
    leaves = [t.clone().transpose(1, 2).contiguous().requires_grad_()
              for t in (tq, tk, tv)]
    ck.flash_attention(*leaves).backward(tdo.transpose(1, 2))
    for leaf, g in zip(leaves, own):
        assert torch.equal(leaf.grad.transpose(1, 2), g)


# ---------------------------------------------------------------- gate

GATE_SHAPES = [(2, 197, 12, 64), (1, 1024, 1, 128), (1, 1025, 1, 64),
               (1, 8, 1, 136), (1, 8, 2, 8), (1, 8, 2, 12), (1, 577, 3, 40),
               (1, 730, 2, 80), (1, 1, 1, 120), (1, 16, 2, 0)]


@pytest.mark.parametrize("shape", GATE_SHAPES)
def test_gate_answers_as_vitaxs(shape):
    a = np.zeros(shape, np.float32)
    assert ck.attention_supported(*(torch.from_numpy(a),) * 3) == \
        pk.attention_supported(a, a, a)
    other = np.zeros(shape[:-1] + (shape[-1] + 8,), np.float32)
    assert not ck.attention_supported(torch.from_numpy(a),
                                      torch.from_numpy(other),
                                      torch.from_numpy(a))
    assert not pk.attention_supported(a, other, a)
    flat = torch.zeros(shape[:-1])
    assert not ck.attention_supported(flat, flat, flat)


@pytest.fixture
def k13_calls(monkeypatch):
    """Calls of K13's twins and of mha_ref (bhsd) in the port."""
    calls = dict.fromkeys(("flash_attention_bhsd_ref",
                           "flash_attention_bwd_ref"), 0)
    for name in calls:
        fn = getattr(ck, name)

        def spy(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(ck, name, spy)
    ref = tatt.mha_ref_bhsd
    calls["mha_ref_bhsd"] = 0

    def mha_spy(*a):
        calls["mha_ref_bhsd"] += 1
        return ref(*a)

    monkeypatch.setattr(tatt, "mha_ref_bhsd", mha_spy)
    return calls


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_dispatch_takes_k13_inside_the_gate_and_mha_ref_outside(layout,
                                                               k13_calls):
    fn = {"bshd": tatt.multi_head_attention,
          "bhsd": tatt.multi_head_attention_bhsd}[layout]
    for s, hd, taken in ((40, 40, "flash_attention_bhsd_ref"),
                         (1025, 8, "mha_ref_bhsd"),
                         (16, 12, "mha_ref_bhsd")):
        q = torch.randn(1, 2, s, hd) if layout == "bhsd" else \
            torch.randn(1, s, 2, hd)
        before = dict(k13_calls)
        fn(q, q, q, use_kernels=True)
        assert {k: k13_calls[k] - before[k] for k in k13_calls} == \
            {k: int(k == taken) for k in k13_calls}
        fn(q, q, q, use_kernels=None)  # a CPU tensor: kernels off
        assert k13_calls["mha_ref_bhsd"] == before["mha_ref_bhsd"] + 1 + (
            taken == "mha_ref_bhsd")


def test_fp32_on_the_card_raises_naming_its_queue_item():
    with pytest.raises(NotImplementedError,
                       match=r'Queue 1 item 9, "fp32 models on the card"'):
        ck.check_k13_dtype("flash_attention_bhsd", torch.float32)
    ck.check_k13_dtype("flash_attention_bhsd", torch.bfloat16)


def test_wrapper_takes_the_einsum_memory_as_it_is_and_pads_odd_head_dims():
    x = torch.randn(2, 5, 16)
    w = torch.randn(16, 3, 40)
    q = torch.einsum("bnd,dhk->bhnk", x, w)  # [B,H,S,Hd] over [B,S,H,Hd]
    assert not q.is_contiguous() and q.transpose(1, 2).is_contiguous()
    rows = ck._core_rows(q, False, 0)
    assert rows.data_ptr() == q.data_ptr() and rows.shape == (2, 5, 3, 40)
    padded = ck._core_rows(q, False, 8)
    assert padded.shape == (2, 5, 3, 48) and padded.is_contiguous()
    assert torch.equal(padded[..., :40], rows)
    assert not padded[..., 40:].any()
    back = ck._from_rows(padded, False, 40)
    assert torch.equal(back, q)
    head_major = ck._core_rows(q, True, 0)
    assert head_major.shape == (2, 3, 5, 40) and torch.equal(head_major, q)


# ---------------------------------------------------------------- model

SMALL = dict(emb_dim=128, mlp_dim=256, num_heads=2, num_layers=2)
K13_PATH = dict(fused_qkv=False, fused_mlp=False, use_pallas=True)


def _cfgs(dtype):
    jc = j_arch("tiny", 48, 10).replace(dtype=getattr(jnp, dtype), **SMALL,
                                         **K13_PATH)
    tc = t_arch("tiny", 48, 10).replace(dtype=getattr(torch, dtype), **SMALL,
                                         **K13_PATH)
    return jc, tc


@pytest.fixture(scope="module")
def weights():
    jc, _ = _cfgs("float32")
    p = jax.tree.map(np.asarray, jvit.init_params(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        p)


def _vitax_layout(tree):
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return t.detach().float().numpy()

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = jax.tree.map(lambda *a: np.stack(a),
                                 *[conv(lp) for lp in tree["layers"]])
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_apply_on_k13_matches_vitax(weights, k13_calls, dtype,
                                        monkeypatch):
    """logits and the grads of every leaf; both packages take K13 (vitax's
    flash_attention_bhsd, counted) in each of the 2 layers."""
    jc, tc = _cfgs(dtype)
    j_calls = []
    flash = pk.flash_attention_bhsd
    monkeypatch.setattr(pk, "flash_attention_bhsd",
                        lambda *a: j_calls.append(1) or flash(*a))
    rng = np.random.default_rng(1)
    img = rng.uniform(-1, 1, (3, 48, 48, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 3).astype(np.int32)

    def loss(p):
        logits = jvit.apply(p, jnp.asarray(img, jc.dtype), jc, train=True,
                            rng=jax.random.PRNGKey(1))
        return j_ce(logits, jnp.asarray(labels)), logits

    (_, ref), j_grads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree.map(jnp.asarray, weights))
    assert j_calls
    params = tvit.params_from_jax(weights)
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    logits = tvit.apply(params, torch.from_numpy(img).to(tc.dtype), tc,
                        train=True)
    grads = dict(zip(map(id, leaves), torch.autograd.grad(
        t_ce(logits, torch.from_numpy(labels)), leaves)))
    small, wide = TOL[dtype]
    _close(ref, logits, small, "logits")
    assert k13_calls == {"flash_attention_bhsd_ref": 2,
                         "flash_attention_bwd_ref": 2, "mha_ref_bhsd": 0}
    t_grads = _vitax_layout(jax.tree.map(lambda p: grads[id(p)], params))
    flat = dict(jax.tree_util.tree_flatten_with_path(t_grads)[0])
    for path, r in jax.tree_util.tree_flatten_with_path(j_grads)[0]:
        name = jax.tree_util.keystr(path)
        r = np.asarray(r, np.float32)
        err = float(np.abs(flat[path] - r).max())
        # the key biases' exact grad is 0: rounding noise on both sides
        scale = 1.0 if "key" in name and "bias" in name else max(
            1.0, float(np.abs(r).max()))
        assert err <= wide * scale, (name, err)


# ---------------------------------------------------------------- CLIs

@pytest.fixture
def k13_forced(monkeypatch, k13_calls):
    """Both packages' attention dispatch on K13 on the CPU, as on their
    accelerators (the rest of each CLI stays on its CPU path)."""
    monkeypatch.setenv("VITAX_NO_CACHE", "1")
    monkeypatch.setattr(jatt, "default_use_pallas",
                        lambda flag=None: True if flag is None else flag)
    monkeypatch.setattr(tatt, "_use_kernels",
                        lambda flag, x: True if flag is None else flag)
    return k13_calls


@pytest.fixture
def tiny_npz(tmp_path):
    cfg = j_arch("tiny", image_size=32, num_classes=10)
    params = jvit.init_params(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape), params)
    path = str(tmp_path / "w.npz")
    save_npz_params(path, params)
    return path


TINY = ["--dataset", "Synthetic", "--model-arch", "tiny", "--image-size",
        "32", "--batch-size", "8", "--num-workers", "0", "--dtype",
        "float32", "--no-fused-qkv", "--no-fused-mlp"]


def test_eval_cli_no_fused_qkv_matches_vitax(k13_forced, tiny_npz):
    argv = TINY + ["--synthetic-samples", "16", "--checkpoint-path",
                   tiny_npz]
    ref = j_eval.main(argv)
    out = t_eval.main(argv, device="cpu")
    np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-4,
                               atol=1e-4)
    assert out["acc1"] == pytest.approx(ref["acc1"], abs=1e-6)
    assert out["acc5"] == pytest.approx(ref["acc5"], abs=1e-6)
    # 2 batches of the 3-layer tiny model
    assert k13_forced == {"flash_attention_bhsd_ref": 6,
                          "flash_attention_bwd_ref": 0, "mha_ref_bhsd": 0}


def test_train_cli_no_fused_qkv_matches_vitax(k13_forced, tiny_npz, tmp_path,
                                              capsys):
    """Two epochs of 2 SGD steps from one npz: each epoch's validation
    metrics, the port's against those vitax prints."""
    argv = TINY + ["--synthetic-samples", "16", "--train-steps", "4",
                   "--lr", "0.05", "--warmup-steps", "2", "--wd", "0",
                   "--checkpoint-path", tiny_npz]
    j_train.main(argv + ["--exp-root", str(tmp_path / "j")])
    printed = re.findall(r"epoch \d+ valid: (.*)", capsys.readouterr().out)
    j_valid = [{k: float(v) for k, v in re.findall(r"(\w+)=([-\d.e]+)", line)}
               for line in printed]
    out = t_train.main(argv + ["--exp-root", str(tmp_path / "t")],
                       device="cpu")
    assert len(out["epochs"]) == len(j_valid) == 2
    for t, j in zip(out["epochs"], j_valid):
        np.testing.assert_allclose(t["valid"]["loss"], j["loss"], rtol=1e-4,
                                   atol=1e-4)
        for k in ("acc1", "acc5"):
            assert t["valid"][k] == pytest.approx(j[k], abs=1e-4)
    # 4 steps and 2 x 2 eval batches of the 3-layer model; 4 backwards
    assert k13_forced == {"flash_attention_bhsd_ref": 24,
                          "flash_attention_bwd_ref": 12, "mha_ref_bhsd": 0}
