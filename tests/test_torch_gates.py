"""Which fused attention half vitax_torch picks, against vitax's gates, at
every preset of ARCH_PRESETS and 224 and 384 px, in eval and in training,
for the ViT (K1 / K6 / plain), Res-ViT's square half (K1, or K10 without
fused_qkvo / plain) and its rect half (K8 / the square half and a gather). Shapes only: meta
tensors on the port's side, ShapeDtypeStructs on vitax's.

vitax's choices come from its own gate functions
(vitax/ops/pallas_kernels.py:2185, :3363) composed as its models compose
them (vitax/models/vit.py:220-227, vitax/models/resvit.py:266, :336, :375);
the port's from the functions its models call.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax_torch.core import config as t_config  # noqa: E402
from vitax_torch.models import resvit as tr  # noqa: E402
from vitax_torch.models import vit as tvit  # noqa: E402
from vitax_torch.ops import gates  # noqa: E402

PRESETS = sorted(t_config.ARCH_PRESETS)
CASES = [(a, i, m) for a in PRESETS for i in (224, 384)
         for m in ("eval", "train")]
CAPACITY = 0.625  # the compacted rows of Res-ViT's rect half
KV_HEADS = 4      # Res-ViT's GQA runs (--n_kv_heads 4)


def _seq(arch, image):
    p = t_config.ARCH_PRESETS[arch]
    return (image // p["patch"]) ** 2 + 1, p["emb_dim"], p["num_heads"]


def _shapes(b, s, d, width):
    return ((jax.ShapeDtypeStruct((b, s, d), jnp.bfloat16),
             jax.ShapeDtypeStruct((d, width), jnp.bfloat16)),
            (torch.empty((b, s, d), dtype=torch.bfloat16, device="meta"),
             torch.empty((d, width), dtype=torch.bfloat16, device="meta")))


def _vitax_vit(jx, jw):
    if pk.qkv_attention_supported(jx, jw):
        return "k1"
    return "k6" if pk.qkv_attention_flash_supported(jx, jw) else None


@pytest.mark.parametrize("arch,image,mode", CASES)
def test_vit_attention_half_is_vitaxs(arch, image, mode):
    s, d, h = _seq(arch, image)
    (jx, jw), (tx, tw) = _shapes(2, s, d, 3 * d)
    with torch.set_grad_enabled(mode == "train"):
        assert tvit._attention_kernel(tx, tw, h) == _vitax_vit(jx, jw)


def _vitax_square(jx, jw, h, hkv, qkvo):
    """vitax's square route (vitax/models/resvit.py:220-279, 322-353, no
    mesh): K1 under fused_qkvo where its gate with heads passes, else its
    `attention`'s fused branch without GQA where the gate without heads
    passes, K9 with fused_qkvo and K10 without, else plain."""
    if qkvo and pk.qkv_attention_supported(jx, jw, h, hkv):
        return "k1"
    if hkv == h and pk.qkv_attention_supported(jx, jw):
        return "k9" if qkvo else "k10"
    return "plain"


def _port_square(tx, tw, cfg):
    """The port's square route as `_attention_half` and `attention` take
    it; "raise" where `attention` raises rather than follow vitax."""
    if cfg.fused_qkvo and tr.square_half_supported(tx, tw, cfg):
        return "k1"
    if tr.attention_is_fused(tx, cfg):
        return ("k10" if not cfg.fused_qkvo and tr.k10_supported(tx, tw, cfg)
                else "raise")
    return "plain"


@pytest.mark.parametrize("kv", ["mha", "gqa"])
@pytest.mark.parametrize("arch,image,mode", CASES)
def test_resvit_halves_are_vitaxs(arch, image, mode, kv):
    """The square half at n_kv_heads = n_heads and 4 (the packed width), and
    the rect half on ceil(0.625·N) rows, which declines under GQA; with
    fused_qkvo vitax never reaches K9 on one device (its gate is the square
    one's), and without it runs K10 in `attention` wherever its gate passes
    without GQA: the port's route is vitax's, and nowhere does the port
    raise where vitax's gate passes and the port's does not."""
    s, d, h = _seq(arch, image)
    hkv = h if kv == "mha" else KV_HEADS
    hd = d // h
    (jx, jw), (tx, tw) = _shapes(2, s, d, (h + 2 * hkv) * hd)
    for qkvo in (True, False):
        cfg = t_config.resvit_arch_config(arch, image, n_kv_heads=hkv,
                                          fused_qkv=True, fused_qkvo=qkvo)
        with torch.set_grad_enabled(mode == "train"):
            vitax_square = _vitax_square(jx, jw, h, hkv, qkvo)
            assert _port_square(tx, tw, cfg) == vitax_square != "k9"
    cfg = t_config.resvit_arch_config(arch, image, n_kv_heads=hkv,
                                      fused_qkv=True, fused_qkvo=True)
    with torch.set_grad_enabled(mode == "train"):
        cap = int(np.ceil(CAPACITY * s))
        spq, cpq = (s + 7) // 8 * 8, (cap + 7) // 8 * 8
        xp = torch.empty((2, spq, d), dtype=torch.bfloat16, device="meta")
        xcp = torch.empty((2, cpq, d), dtype=torch.bfloat16, device="meta")
        vitax_rect = hkv == h and pk.qkv_attention_supported(jx, jw)
        assert tr.rect_half_supported(xcp, xp, tw, cfg) == vitax_rect


def test_gate_copies_are_vitaxs_arithmetic():
    """ops/gates.py against vitax's functions on shapes around each limit:
    s 1024/1025, d 1024/1152/1536/1664, d % 128, the GQA width, and the
    VMEM estimate's edge (l16 @384: 90349568 bytes against 83886080)."""
    assert gates.qkv_attention_vmem(577, 1024, 1024) == 90349568
    assert gates.qkv_attention_vmem(577, 1024, 1024) > gates.QKVO_VMEM
    for b, s, d, width, heads, kv in [
            (2, 577, 1024, 3072, None, None), (2, 197, 1024, 3072, 16, 16),
            (2, 1024, 768, 2304, None, None), (2, 1025, 768, 2304, 12, 12),
            (2, 197, 768, 2304, 12, 4), (2, 197, 768, 1536, 12, 4),
            (2, 197, 768, 1280, 12, 2), (2, 197, 640, 1920, None, None),
            (2, 197, 1152, 3456, None, None), (2, 200, 96, 288, 3, 3),
            (2, 730, 1280, 3840, None, None), (2, 257, 1536, 4608, None, None),
            (2, 257, 1664, 4992, None, None), (3, 5, 128, 385, None, None)]:
        (jx, jw), (tx, tw) = _shapes(b, s, d, width)
        assert (gates.qkv_attention_supported(tx, tw, heads, kv)
                == pk.qkv_attention_supported(jx, jw, heads, kv)), (s, d)
        assert (gates.qkv_attention_flash_supported(tx, tw)
                == pk.qkv_attention_flash_supported(jx, jw)), (s, d)


def test_l16_at_384_runs_k6_and_its_int8_flags_raise(monkeypatch):
    """ViT-L/16 at eval_cli's default 384 px: vitax's K1 gate rejects it
    (the VMEM estimate), so both packages run K6, and the port's int8 and
    int4 tiers raise Queue 1 item 8's message there (vitax drops them to
    bf16 without a word)."""
    s, d, h = _seq("l16", 384)
    tx = torch.empty((2, s, d), dtype=torch.bfloat16, device="meta")
    tw = torch.empty((d, 3 * d), dtype=torch.bfloat16, device="meta")
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            assert tvit._attention_kernel(tx, tw, h) == "k6"
    monkeypatch.setattr(tvit, "embed", lambda params, images, cfg:
                        torch.zeros((1, s, d), dtype=torch.bfloat16))
    images = torch.zeros((1, 384, 384, 3))
    for tier in (dict(int8_attn=True, int8_mlp=True),
                 dict(int8_attn=True, int8_mlp=True, int4_mlp=True)):
        cfg = t_config.arch_config("l16", 384, 10, fused_qkv=True,
                                   fused_mlp=True, **tier)
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            tvit.apply(None, images, cfg)


# ------------------------------------------------------------ under a mesh

def test_k9_route_is_vitaxs_under_a_mesh():
    """Res-ViT under a mesh (vitax/models/resvit.py:220-277, 330-331): its
    fused half declines, and `attention` takes K9 where vitax's gate without
    heads passes (fused_qkv, fused_qkvo, no GQA). Wherever vitax takes K9,
    at every preset × {224, 384}, serving and training, the port's route is
    K9 and its K9 gate passes, so the port never raises there; elsewhere
    both run the unfused attention."""
    from vitax_torch.parallel.mesh import Mesh
    mesh = Mesh(n_data=1, n_model=1, rank=0, data_group=None,
                model_group=None)
    taken = 0
    for arch, image, mode in CASES:
        s, d, h = _seq(arch, image)
        (jx, jw), (tx, tw) = _shapes(2, s, d, 3 * d)
        cfg = t_config.resvit_arch_config(arch, image, fused_qkv=True,
                                          fused_qkvo=True)
        with torch.set_grad_enabled(mode == "train"):
            vitax_k9 = bool(pk.qkv_attention_supported(jx, jw))
            assert tr._fused_attention_half(tx, None, cfg, mesh) is None
            assert tr.attention_is_fused(tx, cfg) == vitax_k9, (arch, image)
            if vitax_k9:
                assert tr.k9_supported(tx, tw, cfg), (arch, image, mode)
                taken += 1
    assert taken >= 8  # b16 and b32 at both sizes, both modes, at least


def _vitax_tp(jx, d, h, hd, m, tp):
    """vitax's per-shard gates under a model axis of tp
    (vitax/models/vit.py:190-194, :272-279): K1's at the shard width, the
    MLP's on the shards; each None where the axis does not split it."""
    attn = (bool(pk.qkv_attention_supported(
        jx, jax.ShapeDtypeStruct((d, 3 * (h // tp) * hd), jnp.bfloat16)))
        if h % tp == 0 else None)
    w1 = jax.ShapeDtypeStruct((d, m // tp), jnp.bfloat16)
    w2 = jax.ShapeDtypeStruct((m // tp, d), jnp.bfloat16)
    mlp = bool(pk.ln_mlp_supported(jx, w1, w2)) if m % tp == 0 else None
    return attn, mlp


# (preset, image, tp) where vitax's per-shard K1 or K2 gate passes and the
# port's does not: none. (ViT-H/14's attention half declines in both: vitax's
# gate takes d <= 1024 only, so vitax hands its sharded weights to XLA, and
# the port runs its plain attention on the gathered weights; its MLP half
# passes both at tp 2 and 4.)
TP_PORT_DECLINES = set()


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_gates_are_vitaxs(tp, monkeypatch):
    """The per-shard K1 and K2 gates at every preset × {224, 384}, serving
    and training: the port runs a half per shard only where vitax's gate
    passes; where vitax's passes and the port's does not
    (TP_PORT_DECLINES, listed in ROADMAP: none); where vitax's declines
    and it hands the sharded weights to XLA (ViT-H/14's attention half),
    `_tp_attention` declines and the block runs the plain attention on the
    gathered weights, the MLP half per shard; the port's per-shard MLP
    gate is vitax's (ops/gates.py's copy) with its own."""
    from vitax_torch.parallel.mesh import Mesh
    declines, runs = set(), 0
    for arch, image, mode in CASES:
        s, d, h = _seq(arch, image)
        m = t_config.ARCH_PRESETS[arch]["mlp_dim"]
        (jx, _), (tx, _) = _shapes(2, s, d, 3 * d)
        cfg = t_config.arch_config(arch, image, 10, fused_qkv=True,
                                   fused_mlp=True)
        vitax_attn, vitax_mlp = _vitax_tp(jx, d, h, d // h, m, tp)
        w1 = torch.empty((d, m // tp), device="meta", dtype=torch.bfloat16)
        w2 = torch.empty((m // tp, d), device="meta", dtype=torch.bfloat16)
        assert gates.ln_mlp_supported(tx, w1, w2) == bool(vitax_mlp)
        assert tvit.tp_mlp_supported(tx, w1, w2) <= bool(vitax_mlp)
        with torch.set_grad_enabled(mode == "train"):
            ran = tvit.tp_attention_supported(tx, cfg, tp)
        assert ran <= bool(vitax_attn), (arch, image, mode)
        if (vitax_attn and not ran) or (vitax_mlp and not
                                         tvit.tp_mlp_supported(tx, w1, w2)):
            declines.add((arch, image, tp))
        runs += ran
    assert declines == {c for c in TP_PORT_DECLINES if c[2] == tp}
    assert runs > 0
    s, d, h = _seq("h14", 224)
    (jx, _), _ = _shapes(2, s, d, 3 * d)
    assert _vitax_tp(jx, d, h, d // h, 4 * d, tp)[0] is False
    cfg = t_config.arch_config("h14", 224, 10, fused_qkv=True,
                               fused_mlp=True)
    mesh = Mesh(n_data=1, n_model=tp, rank=0, data_group=None,
                model_group=None)
    x = torch.empty((2, s, d), device="meta", dtype=torch.bfloat16)
    assert tvit._tp_attention(x, None, cfg, mesh) is None
    route = []
    monkeypatch.setattr(tvit, "_gathered", lambda p, half, mesh: (
        route.append(f"gathered {half}"), p)[1])
    monkeypatch.setattr(tvit, "_attention", lambda h, p, cfg: (
        route.append("plain attention"), h)[1])
    monkeypatch.setattr(tvit, "_tp_mlp", lambda x, lp, cfg, mesh: (
        route.append("MLP per shard"), x)[1])
    ln = {"scale": torch.empty(d, device="meta"),
          "bias": torch.empty(d, device="meta")}
    tvit._block(x, {"ln1": ln, "attn": {}, "ln2": ln}, cfg, mesh=mesh)
    assert route == ["gathered attn", "plain attention", "MLP per shard"]


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_tier_gates_are_vitaxs(tp):
    """K3 and K11-C per shard (the attention half with `--int8` or
    `--int4-attn` under a model axis) at every preset × {224, 384}, serving
    and training: vitax asks K1's gate at the shard width for every tier
    (vitax/models/vit.py:190-194), and so does the port, which runs the
    tier per shard exactly where vitax does. Where vitax's gate declines at
    d <= 1024 its plain attention drops the tier, which the port refuses
    with Queue 1 item 8 (the tiers at d > 1024 raise before, in
    `check_tiers`)."""
    from vitax_torch.parallel.mesh import Mesh
    mesh = Mesh(n_data=1, n_model=tp, rank=0, data_group=None,
                model_group=None)
    runs = 0
    for arch, image, mode in CASES:
        s, d, h = _seq(arch, image)
        if h % tp or d > 1024:
            continue
        (jx, _), (tx, _) = _shapes(2, s, d, 3 * d)
        vitax_attn = _vitax_tp(jx, d, h, d // h, 4 * d, tp)[0]
        for flags in ({"int8_attn": True, "int8_mlp": True},
                      {"int4_attn": True, "int4_mlp": True,
                       "int8_attn": True, "int8_mlp": True}):
            cfg = t_config.arch_config(arch, image, 10, fused_qkv=True,
                                       fused_mlp=True, **flags)
            with torch.set_grad_enabled(mode == "train"):
                ran = tvit.tp_attention_supported(tx, cfg, tp)
                assert ran == bool(vitax_attn), (arch, image, mode, flags)
                if not ran:
                    with pytest.raises(NotImplementedError,
                                       match="Queue 1 item 8"):
                        tvit._tp_attention(tx, None, cfg, mesh)
            runs += ran
    assert runs > 0
