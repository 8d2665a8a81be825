"""K9 in vitax_torch against vitax: `fused_qkvo_attention`'s plain twins
(forward and backward) against vitax's Pallas kernel and its VJP, K2's
`residual=False` twins against vitax's kernel calls, and `resvit.apply`
under a 1-rank gloo mesh (every attention half through the LN kernel and
K9, as vitax's `attention` dispatches it under any mesh) against vitax's
`resvit.apply` under a 1-device mesh.

vitax's side runs its Pallas kernels in interpret mode (its models under
jax.jit); the port's CPU tensors take the twins, also through
`FusedQkvoAttentionFn` and `FusedLnMlpFn`. The kernels are held against
these twins on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py
phase 16).

Shapes: D 128, 2 heads of 64, seq 21 in spq 24 (pad rows) and seq 24, batch
2; K2 at M 256 over 2 x 24 rows. Tolerances, max|port - vitax| <=
tol·max(1, max|vitax|) per output, tests/test_torch_kernels_ref.py's:
forward fp32 1e-4, bf16 2e-2; backward fp32 1e-4 for dx and the vector
grads, 1e-3 for the weight grads (sums over every row), bf16 2e-2. The
model: tests/test_torch_resvit_train.py's small config cut to 2 layers (a
plain one and a routed block head), LoRA on, its TOL; keep bits and routing
maps exactly.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from tests.test_torch_kernels_ref import BWD_TOL, TOL as FWD_TOL  # noqa: E402
from tests.test_torch_resvit_train import (  # noqa: E402,F401
    TOL, _batch, _cfgs, _close, _loss_parts, _paths, _torch_noise,
    _trainable_paths, _weights, interpret_mode, vitax_noise,
    vitax_path_ids_from_the_keep_bits)
from vitax.models import resvit as jr  # noqa: E402
from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax.parallel import mesh as jmesh  # noqa: E402
from vitax_torch.models import resvit as tr  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402
from vitax_torch.parallel import make_mesh  # noqa: E402
from vitax_torch.parallel.mesh import Mesh  # noqa: E402
from vitax_torch.train.optim import tree_leaves  # noqa: E402

D, M, EPS = 128, 256, 1e-5
FUSED = dict(fused_qkv=True, fused_qkvo=True, use_pallas=True)
TWO_LAYERS = dict(n_layers=2, block_size=1)


def _k9_arrays(seed, spq, seq, heads, hd):
    """x̂ [2, spq, D] (the LN output: zero pad rows past seq), wqkv, bqkv, wo
    [H·Hd, D], bo and dY [2, spq, D] (zero on the pad rows, as the caller's
    row cut leaves it), numpy fp32."""
    rng = np.random.default_rng(seed)
    w, hhd = 3 * heads * hd, heads * hd
    x = rng.standard_normal((2, spq, D)).astype(np.float32)
    x[:, seq:] = 0
    do = rng.standard_normal((2, spq, D)).astype(np.float32)
    do[:, seq:] = 0
    return (x, (rng.standard_normal((D, w)) * D ** -0.5).astype(np.float32),
            (rng.standard_normal(w) * 0.1).astype(np.float32),
            (rng.standard_normal((hhd, D)) * hhd ** -0.5).astype(np.float32),
            (rng.standard_normal(D) * 0.1).astype(np.float32), do)


def _close_all(refs, outs, tols, names):
    for r, o, tol, name in zip(refs, outs, tols, names):
        r = np.asarray(jnp.asarray(r).astype(jnp.float32))
        o = o.detach().float().numpy()
        assert o.shape == r.shape, name
        bound = tol * max(1.0, float(np.abs(r).max()))
        err = float(np.abs(o - r).max())
        assert err <= bound, f"{name}: max error {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spq,seq", [(24, 21), (24, 24)])
def test_k9_twins_match_pallas(dtype, spq, seq):
    """The forward twin against `pk.fused_qkvo_attention`, the backward twin
    and `FusedQkvoAttentionFn`'s grads (dW and dWo in their weights' dtype,
    db and dbo fp32) against its VJP, on every output; the wrappers on CPU
    tensors are the twins."""
    heads, hd = 2, 64
    x, w, b, wo, bo, do = _k9_arrays(seq, spq, seq, heads, hd)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jw, jwo, jdo = (jnp.asarray(a, jdt) for a in (x, w, wo, do))
    jb, jbo = jnp.asarray(b), jnp.asarray(bo)
    ref, vjp = jax.vjp(
        lambda *t: pk.fused_qkvo_attention(*t, seq, heads, hd),
        jx, jw, jb, jwo, jbo)
    jgrads = vjp(jdo)
    assert jgrads[4].dtype == jnp.float32
    tx, tw, two, tdo = (torch.from_numpy(a).to(tdt) for a in (x, w, wo, do))
    tb, tbo = torch.from_numpy(b), torch.from_numpy(bo)
    args = (seq, heads, hd)
    out = ck.fused_qkvo_attention_ref(tx, tw, tb, two, tbo, *args)
    assert out.dtype == tdt
    _close_all([ref], [out], [FWD_TOL[dtype]], ["out"])
    torch.testing.assert_close(
        ck.fused_qkvo_attention(tx, tw, tb, two, tbo, *args), out, rtol=0,
        atol=0)
    small, wide = BWD_TOL[dtype]
    names = ("dx", "dwqkv", "dbqkv", "dwo", "dbo")
    tols = (small, wide, small, wide, small)
    grads = ck.fused_qkvo_attention_bwd_ref(tx, tw, tb, two, tdo, *args)
    assert [g.dtype for g in grads] == [tdt] + [torch.float32] * 4
    _close_all([jgrads[i] for i in (0, 1, 2, 3, 4)], grads, tols, names)
    for a, c in zip(grads, ck.fused_qkvo_attention_bwd(tx, tw, tb, two, tdo,
                                                       *args)):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    leaves = [t.clone().requires_grad_() for t in (tx, tw, tb, two, tbo)]
    ck.fused_qkvo_attention(*leaves, *args).backward(tdo)
    assert [t.grad.dtype for t in leaves] == [tdt, tdt, torch.float32, tdt,
                                              torch.float32]
    _close_all(jgrads, [t.grad for t in leaves], tols, names)


def _mlp_arrays(seed):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)
    return dict(x=n(2, 24, D) * 1.5 + 0.3, do=n(2, 24, D),
                gamma=1 + n(D, s=0.1), beta=n(D, s=0.1),
                w1=n(D, M, s=D ** -0.5), b1=n(M, s=0.1),
                w2=n(M, D, s=M ** -0.5), b2=n(D, s=0.1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_mlp_partial_twins_match_pallas(dtype):
    """K2's `residual=False` branch (vitax's tensor-parallel MLP half): the
    forward twin against `pk._ln_mlp_fwd_call(..., residual=False)`, the
    backward twin and `FusedLnMlpFn(..., residual=False)`'s grads against
    `pk._ln_mlp_bwd_call(..., residual=False)`; `fused_ln_mlp(...,
    residual=False)` is `fused_ln_mlp_partial`."""
    a = _mlp_arrays(9)
    mats = ("x", "do", "w1", "w2")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = {k: jnp.asarray(v, jdt if k in mats else jnp.float32)
         for k, v in a.items()}
    t = {k: torch.from_numpy(v).to(tdt if k in mats else torch.float32)
         for k, v in a.items()}
    n = 2 * 24
    rows = pk._ln_mlp_pad(n)

    def pad(v):
        return jnp.pad(v.reshape(n, D), ((0, rows - n), (0, 0)))
    keys = ("gamma", "beta", "w1", "b1", "w2")
    ref = pk._ln_mlp_fwd_call(pad(j["x"]), *(j[k] for k in keys), j["b2"],
                              EPS, False)[:n]
    targs = (t["x"], *(t[k] for k in keys), t["b2"], EPS)
    out = ck.fused_ln_mlp_partial_ref(*targs)
    _close_all([ref], [out.reshape(n, D)], [FWD_TOL[dtype]], ["out"])
    torch.testing.assert_close(ck.fused_ln_mlp(*targs, residual=False), out,
                               rtol=0, atol=0)
    jg = pk._ln_mlp_bwd_call(pad(j["x"]), *(j[k] for k in keys),
                             pad(j["do"]), EPS, False)
    jg = (jg[0][:n], *jg[1:])
    small, wide = BWD_TOL[dtype]
    names = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    tols = (small, small, small, wide, small, wide, small)
    grads = ck.fused_ln_mlp_partial_bwd_ref(t["x"], *(t[k] for k in keys),
                                            t["do"], EPS)
    _close_all(jg, (grads[0].reshape(n, D), *grads[1:]), tols, names)
    leaves = [t[k].clone().requires_grad_()
              for k in ("x", "gamma", "beta", "w1", "b1", "w2", "b2")]
    ck.fused_ln_mlp(*leaves, EPS, residual=False).backward(t["do"])
    _close_all(jg, [leaves[0].grad.reshape(n, D)]
               + [v.grad for v in leaves[1:]], tols, names)


@pytest.fixture(scope="module")
def one_rank_mesh(tmp_path_factory):
    """A gloo world of this one process (a FileStore) and its (1, 1) mesh."""
    init = tmp_path_factory.mktemp("gloo") / "init"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                            world_size=1)
    try:
        yield make_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def _vitax_mesh():
    return jmesh.make_mesh(n_data=1, devices=jax.devices()[:1])


def _counting(monkeypatch, names):
    """Counts the top-level calls `resvit.apply` makes of the wrappers
    `names` (not a Function's own call of its wrapper)."""
    calls = {n: 0 for n in names}
    for name in names:
        real, depth = getattr(ck, name), [0]

        def counted(*a, _real=real, _name=name, _depth=depth, **k):
            if _depth[0] == 0:
                calls[_name] += 1
            _depth[0] += 1
            try:
                return _real(*a, **k)
            finally:
                _depth[0] -= 1
        monkeypatch.setattr(ck, name, counted)
    return calls


ATTN_KERNELS = ("fused_qkvo_attention", "fused_qkv_attention",
                "fused_ln_qkvo_attention", "fused_ln_qkvo_attention_rect")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity", [None, 0.625])
def test_apply_under_a_mesh_matches_vitax(dtype, capacity, one_rank_mesh,
                                          monkeypatch):
    """Serving under a (1, 1) mesh: both layers' attention halves through
    K9 (the compacted block's too, on all rows before the gather: the rect
    half declines under a mesh), no K1, K8 or K10; logits and routing maps
    against vitax's under a 1-device mesh."""
    jc, tc = _cfgs(dtype, **FUSED, **TWO_LAYERS, compact_capacity=capacity)
    w = _weights(jc)
    img, _ = _batch(3)
    jm = _vitax_mesh()
    ref, jaux = jax.jit(lambda p, x: jr.apply(p, x, jc, train=False,
                                              mesh=jm))(
        jax.tree.map(jnp.asarray, w), jnp.asarray(img, jc.dtype))
    calls = _counting(monkeypatch, ATTN_KERNELS)
    with torch.inference_mode():
        out, taux = tr.apply(tr.params_from_jax(w),
                             torch.from_numpy(img).to(tc.dtype), tc,
                             mesh=one_rank_mesh)
    assert calls == {"fused_qkvo_attention": 2, "fused_qkv_attention": 0,
                     "fused_ln_qkvo_attention": 0,
                     "fused_ln_qkvo_attention_rect": 0}
    _close(ref, out, TOL[dtype][0], "logits")
    for k, m in jaux["routing_maps"].items():
        np.testing.assert_array_equal(np.asarray(m),
                                      taux["routing_maps"][k].numpy())
    assert 0 < float(taux["acts"][..., 1].mean()) < 1


TRAIN_CASES = [("float32", {}), ("float32", dict(compact_capacity=0.625)),
               ("bfloat16", {}),
               # int8_attn does not reach K9 (vitax's `attention` has no
               # int8 tier): the attention half stays in bf16 while the MLP
               # half runs K4's twins
               ("bfloat16", dict(int8_attn=True, int8_attn_grad=True,
                                 int8_mlp=True, int8_mlp_grad=True,
                                 fused_mlp=True))]


@pytest.mark.parametrize("dtype,kw", TRAIN_CASES)
def test_apply_train_under_a_mesh_matches_vitax(dtype, kw, one_rank_mesh,
                                                monkeypatch):
    """apply(train=True) under a (1, 1) mesh with vitax's noise injected:
    K9 in the student's two layers and the teacher's routed one, logits,
    distill loss, keep bits and the grads of the 3-term loss for every
    trainable leaf (LoRA's through the fold) against vitax's under a
    1-device mesh."""
    jc, tc = _cfgs(dtype, **FUSED, **TWO_LAYERS, **kw)
    w = _weights(jc)
    img, labels = _batch(2)
    key = jax.random.PRNGKey(11)
    noise = vitax_noise(key, jc, 2)
    jm = _vitax_mesh()

    def j_loss(p):
        logits, aux = jr.apply(p, jnp.asarray(img, jc.dtype), jc, train=True,
                               rng=key, mesh=jm)
        return _loss_parts(logits, jnp.asarray(labels), aux, jc, jnp), \
            (logits, aux)

    (_, (jlogits, jaux)), jgrads = jax.jit(jax.value_and_grad(
        j_loss, has_aux=True))(jax.tree.map(jnp.asarray, w))
    tp = tr.params_from_jax(w)
    for t, m in zip(tree_leaves(tp), tree_leaves(tr.trainable_mask(tp, tc))):
        t.requires_grad_(m)
    calls = _counting(monkeypatch, ATTN_KERNELS)
    int8_attn = []
    monkeypatch.setattr(ck, "fused_ln_qkvo_attention_int8",
                        lambda *a, **k: int8_attn.append(a))
    logits, aux = tr.apply(tp, torch.from_numpy(img).to(tc.dtype), tc,
                           train=True, noise=_torch_noise(noise),
                           mesh=one_rank_mesh)
    _loss_parts(logits, torch.from_numpy(labels), aux, tc, torch).backward()
    assert calls["fused_qkvo_attention"] == 3 and not int8_attn
    assert sum(calls.values()) == 3
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


@pytest.mark.parametrize("case,want", [
    (dict(), "fused_qkvo_attention"),
    (dict(fused_qkvo=False), "fused_qkv_attention"),
    (dict(n_kv_heads=1), None)])
def test_dispatch_under_a_mesh(case, want, one_rank_mesh, monkeypatch):
    """Under a mesh, as vitax's: K9 with fused_qkvo, K10 without, the
    unfused path with GQA (vitax's fused branch declines it); never K1."""
    jc, tc = _cfgs("float32", **{**FUSED, **TWO_LAYERS, **case})
    w = _weights(jc)
    img, _ = _batch(2)
    calls = _counting(monkeypatch, ATTN_KERNELS)
    with torch.inference_mode():
        out, _ = tr.apply(tr.params_from_jax(w), torch.from_numpy(img), tc,
                          mesh=one_rank_mesh)
    assert torch.isfinite(out).all()
    assert calls == {k: 2 * (k == want) for k in ATTN_KERNELS}


def test_resvit_under_tensor_parallelism_raises():
    """A model axis > 1 raises with its ROADMAP item: vitax shards wq/wk/
    wv/wo and fc1/fc2 there, which the port does not run yet."""
    _, tc = _cfgs("float32", **FUSED, **TWO_LAYERS)
    mesh = Mesh(n_data=1, n_model=2, rank=0, data_group=None,
                model_group=None)
    img, _ = _batch(2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        tr.apply(None, torch.from_numpy(img), tc, mesh=mesh)


def test_k9_gates_and_fp32_raise():
    """The port's K9 gate takes the b16 Res-ViT's shapes in eval and
    training at 224 and 384 px and the TP shard width (6 heads of a 768
    model), and, on K13's core since K9 runs K1's Hopper sequence, head
    dim 80 (d 1280 with 16 heads), which K10, on K13's core too, takes as
    well; it refuses what K13's core and the products do not take (D % 16,
    head dim 40, seq > 1024). It has no dtype test, so a CUDA fp32 input reaches the
    wrapper's raise, whose message, unreachable on a CUDA-less machine, is
    held here."""
    for s, grad in ((197, False), (197, True), (577, False), (577, True)):
        x = torch.empty((2, s, 768), device="meta", dtype=torch.bfloat16)
        for heads in (12, 6):
            wqkv = torch.empty((768, 3 * 64 * heads), device="meta",
                               dtype=torch.bfloat16)
            gate = (ck.fused_qkvo_attention_bwd_supported if grad
                    else ck.fused_qkvo_attention_supported)
            assert gate(x, wqkv, heads)
    hd80 = (torch.empty((2, 197, 1280), device="meta"),
            torch.empty((1280, 3840), device="meta"), 16)
    assert ck.fused_qkvo_attention_supported(*hd80)
    assert ck.fused_qkvo_attention_bwd_supported(*hd80)
    assert ck.fused_qkv_attention_supported(*hd80)
    assert not ck.fused_qkvo_attention_supported(
        torch.empty((2, 197, 120), device="meta"),
        torch.empty((120, 384), device="meta"), 2)
    assert not ck.fused_qkvo_attention_supported(
        torch.empty((2, 197, 640), device="meta"),
        torch.empty((640, 1920), device="meta"), 16)
    assert not ck.fused_qkvo_attention_supported(
        torch.empty((2, 1032, 768), device="meta"),
        torch.empty((768, 2304), device="meta"), 12)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        ck.check_k9_dtype("fused_qkvo_attention", torch.float32)
    ck.check_k9_dtype("fused_qkvo_attention", torch.bfloat16)
