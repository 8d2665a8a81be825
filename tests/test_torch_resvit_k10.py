"""K10 in vitax_torch against vitax: `fused_qkv_attention`'s plain twins
(forward and backward) against vitax's Pallas kernel and its VJP, and
`resvit.apply` with `fused_qkv=True, fused_qkvo=False` (every attention half
through K10, as vitax's `attention` dispatches it) against vitax's.

vitax's side runs its Pallas kernels in interpret mode (its models under
jax.jit, which traces them once: 5x faster here); the port's CPU
tensors take the twins, also through `FusedQkvAttentionFn`. The kernels are
held against these twins on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py phase 15).

Shapes: D 128; 2 heads of 64 or 4 of 32; seq 17 in spq 24 (pad rows) and
seq 24; batch 2. Tolerances, max|port - vitax| <= tol·max(1, max|vitax|) per
output, tests/test_torch_kernels_ref.py's: forward fp32 1e-4, bf16 2e-2;
backward fp32 1e-4 for dx and db, 1e-3 for dW (a sum over every row), bf16
2e-2. The model: tests/test_torch_resvit_train.py's small config cut to 2
layers (a plain one and a routed block head), LoRA on, its TOL; keep bits
and routing maps exactly.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_kernels_ref import BWD_TOL, TOL as FWD_TOL  # noqa: E402
from tests.test_torch_resvit_train import (  # noqa: E402,F401
    TOL, _batch, _cfgs, _close, _loss_parts, _paths, _torch_noise,
    _trainable_paths, _weights, interpret_mode, vitax_noise,
    vitax_path_ids_from_the_keep_bits)
from vitax.models import resvit as jr  # noqa: E402
from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax_torch.models import resvit as tr  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402
from vitax_torch.train.optim import tree_leaves  # noqa: E402

D = 128
K10 = dict(fused_qkv=True, fused_qkvo=False, use_pallas=True)
TWO_LAYERS = dict(n_layers=2, block_size=1)


def _k10_arrays(seed, spq, seq, heads, hd):
    """x̂ [2, spq, D] (the LN output: zero pad rows past seq), wqkv, bqkv and
    do [2, spq, H·Hd] (zero on the pad rows, as the caller's row cut
    leaves it), numpy fp32."""
    rng = np.random.default_rng(seed)
    w = 3 * heads * hd
    x = rng.standard_normal((2, spq, D)).astype(np.float32)
    x[:, seq:] = 0
    do = rng.standard_normal((2, spq, heads * hd)).astype(np.float32)
    do[:, seq:] = 0
    return (x, (rng.standard_normal((D, w)) * D ** -0.5).astype(np.float32),
            (rng.standard_normal(w) * 0.1).astype(np.float32), do)


def _close_all(refs, outs, tols, names):
    for r, o, tol, name in zip(refs, outs, tols, names):
        r = np.asarray(jnp.asarray(r).astype(jnp.float32))
        o = o.detach().float().numpy()
        assert o.shape == r.shape, name
        bound = tol * max(1.0, float(np.abs(r).max()))
        err = float(np.abs(o - r).max())
        assert err <= bound, f"{name}: max error {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,hd", [(2, 64), (4, 32)])
@pytest.mark.parametrize("spq,seq", [(24, 17), (24, 24)])
def test_k10_twins_match_pallas(dtype, heads, hd, spq, seq):
    """The forward twin against `pk.fused_qkv_attention`, the backward twin
    and `FusedQkvAttentionFn`'s grads (dW in W's dtype, db fp32) against
    its VJP, on every output; the wrapper on CPU tensors is the twin."""
    x, w, b, do = _k10_arrays(seq + hd, spq, seq, heads, hd)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jw, jdo = (jnp.asarray(a, jdt) for a in (x, w, do))
    jb = jnp.asarray(b)
    ref, vjp = jax.vjp(
        lambda x_, w_, b_: pk.fused_qkv_attention(x_, w_, b_, seq, heads, hd),
        jx, jw, jb)
    jgrads = vjp(jdo)
    tx, tw, tdo = (torch.from_numpy(a).to(tdt) for a in (x, w, do))
    tb = torch.from_numpy(b)
    args = (seq, heads, hd)
    out = ck.fused_qkv_attention_ref(tx, tw, tb, *args)
    assert out.dtype == tdt
    _close_all([ref], [out], [FWD_TOL[dtype]], ["out"])
    torch.testing.assert_close(ck.fused_qkv_attention(tx, tw, tb, *args),
                               out, rtol=0, atol=0)
    small, wide = BWD_TOL[dtype]
    names, tols = ("dx", "dwqkv", "dbqkv"), (small, wide, small)
    grads = ck.fused_qkv_attention_bwd_ref(tx, tw, tb, tdo, *args)
    assert [g.dtype for g in grads] == [tdt, torch.float32, torch.float32]
    _close_all(jgrads, grads, tols, names)
    leaves = [t.clone().requires_grad_() for t in (tx, tw, tb)]
    ck.fused_qkv_attention(*leaves, *args).backward(tdo)
    assert [t.grad.dtype for t in leaves] == [tdt, tdt, torch.float32]
    _close_all(jgrads, [t.grad for t in leaves], tols, names)


def _count_k10(monkeypatch):
    """Counts the K10 calls `resvit.apply` makes (the wrapper, by the
    module name the model calls; not the Function's own call of it), with
    the x̂ dtype each one got."""
    calls, real, depth = [], ck.fused_qkv_attention, [0]

    def counted(x, *a):
        if depth[0] == 0:
            calls.append(x.dtype)
        depth[0] += 1
        try:
            return real(x, *a)
        finally:
            depth[0] -= 1
    monkeypatch.setattr(ck, "fused_qkv_attention", counted)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity", [None, 0.625])
def test_apply_without_fused_qkvo_matches_vitax(dtype, capacity,
                                                monkeypatch):
    """Serving: both layers' attention halves through K10 (the compacted
    block's too, on all rows before the gather, as vitax's
    compact_routed_block), logits and routing maps against vitax's."""
    jc, tc = _cfgs(dtype, **K10, **TWO_LAYERS, compact_capacity=capacity)
    w = _weights(jc)
    img, _ = _batch(3)
    ref, jaux = jax.jit(lambda p, x: jr.apply(p, x, jc, train=False))(
        jax.tree.map(jnp.asarray, w), jnp.asarray(img, jc.dtype))
    calls = _count_k10(monkeypatch)
    with torch.inference_mode():
        out, taux = tr.apply(tr.params_from_jax(w),
                             torch.from_numpy(img).to(tc.dtype), tc)
    assert calls == [tc.dtype] * 2
    _close(ref, out, TOL[dtype][0], "logits")
    for k, m in jaux["routing_maps"].items():
        np.testing.assert_array_equal(np.asarray(m),
                                      taux["routing_maps"][k].numpy())
    assert 0 < float(taux["acts"][..., 1].mean()) < 1


TRAIN_CASES = [("float32", {}), ("float32", dict(compact_capacity=0.625)),
               ("bfloat16", {}),
               # int8_attn does not reach K10 (vitax's `attention` has no
               # int8 tier): the attention half stays in bf16 while the MLP
               # half runs K4's twins
               ("bfloat16", dict(int8_attn=True, int8_attn_grad=True,
                                 int8_mlp=True, int8_mlp_grad=True,
                                 fused_mlp=True))]


@pytest.mark.parametrize("dtype,kw", TRAIN_CASES)
def test_apply_train_without_fused_qkvo_matches_vitax(dtype, kw,
                                                      monkeypatch):
    """apply(train=True) with vitax's noise injected: K10 in the student's
    two layers and the teacher's routed one, logits, distill loss, keep
    bits and the grads of the 3-term loss for every trainable leaf (LoRA's
    through the fold) against vitax's."""
    jc, tc = _cfgs(dtype, **K10, **TWO_LAYERS, **kw)
    w = _weights(jc)
    img, labels = _batch(2)
    key = jax.random.PRNGKey(11)
    noise = vitax_noise(key, jc, 2)

    def j_loss(p):
        logits, aux = jr.apply(p, jnp.asarray(img, jc.dtype), jc, train=True,
                               rng=key)
        return _loss_parts(logits, jnp.asarray(labels), aux, jc, jnp), \
            (logits, aux)

    (_, (jlogits, jaux)), jgrads = jax.jit(jax.value_and_grad(
        j_loss, has_aux=True))(jax.tree.map(jnp.asarray, w))
    tp = tr.params_from_jax(w)
    for t, m in zip(tree_leaves(tp), tree_leaves(tr.trainable_mask(tp, tc))):
        t.requires_grad_(m)
    calls = _count_k10(monkeypatch)
    int8_attn = []
    monkeypatch.setattr(ck, "fused_ln_qkvo_attention_int8",
                        lambda *a, **k: int8_attn.append(a))
    logits, aux = tr.apply(tp, torch.from_numpy(img).to(tc.dtype), tc,
                           train=True, noise=_torch_noise(noise))
    _loss_parts(logits, torch.from_numpy(labels), aux, tc, torch).backward()
    assert calls == [tc.dtype] * 3 and not int8_attn
    small, wide = TOL[dtype]
    _close(jlogits, logits, small, "logits")
    _close(jaux["d_loss"], aux["d_loss"], small, "d_loss")
    np.testing.assert_array_equal(np.asarray(jaux["acts"]).round(),
                                  aux["acts"].detach().numpy().round())
    trainable = _trainable_paths(jc, w)
    n = 0
    for (path, g), t in zip(_paths(jgrads), tree_leaves(tp)):
        name = jax.tree_util.keystr(path)
        if name in trainable:
            _close(g, t.grad, wide, name)
            n += 1
    assert n == len(trainable) > 0
    assert any("lora_q" in name for name in trainable)


def test_k10_gates_and_fp32_raise():
    """The port's K10 gate takes the b16 Res-ViT's shapes in eval and
    training at 224 and 384 px and, on K13's core since K10 runs K1's
    Hopper launches, B/16 @416 (seq 677) and head dim 80 (d 1280 with 16
    heads), which the whole-row core refused; it refuses what K13's core
    and the products do not take (head dim 40, seq > 1024, D % 16); on a
    CUDA-less machine the dtype test cannot be reached, so the message it
    raises is held here."""
    def meta(*shape):
        return torch.empty(shape, device="meta", dtype=torch.bfloat16)

    for s, grad in ((197, False), (197, True), (577, False), (577, True),
                    (677, False), (677, True)):
        gate = (ck.fused_qkv_attention_bwd_supported if grad
                else ck.fused_qkv_attention_supported)
        assert gate(meta(2, s, 768), meta(768, 3 * 768), 12)
        assert gate(meta(2, s, 1280), meta(1280, 3840), 16)  # head dim 80
    for gate in (ck.fused_qkv_attention_supported,
                 ck.fused_qkv_attention_bwd_supported):
        assert not gate(meta(2, 197, 640), meta(640, 1920), 16)  # hd 40
        assert not gate(meta(2, 1032, 768), meta(768, 2304), 12)
        assert not gate(meta(2, 197, 120), meta(120, 384), 2)  # D % 16
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        ck.check_k10_dtype("fused_qkv_attention", torch.float32)
    ck.check_k10_dtype("fused_qkv_attention", torch.bfloat16)
