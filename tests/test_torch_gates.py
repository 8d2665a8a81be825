"""Which fused attention half vitax_torch picks, against vitax's gates, at
every preset of ARCH_PRESETS and 224 and 384 px, and off the presets (image
sizes up to vitax's seq limit of 1024, (d, heads) pairs (640, 8) with head
dim 80 and (1024, 8) at seq 353–544), in eval and in training, for the ViT
(K1 / K6 / plain), Res-ViT's square half (K1, or K10 without fused_qkvo /
plain) and its rect half (K8 / the square half and a gather). Shapes only:
meta tensors on the port's side, ShapeDtypeStructs on vitax's. Where the
pick is a path that keeps the first design's whole-row core (K7, K10,
R-F) and that core cannot take the shapes, the path raises by name.

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
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402
from vitax_torch.ops import gates  # noqa: E402

PRESETS = sorted(t_config.ARCH_PRESETS)
PRESET_CASES = [(a, i, m) for a in PRESETS for i in (224, 384)
                for m in ("eval", "train")]
# off the presets: (d, heads) pairs as patch-16 models
OFF_PRESETS = {"d640h8": dict(patch=16, emb_dim=640, mlp_dim=2560,
                              num_heads=8),
               "d1024h8": dict(patch=16, emb_dim=1024, mlp_dim=4096,
                               num_heads=8)}
# seq 677 (K1 in vitax, past the whole-row core), 785 and 962 (K6), 1025
# (past vitax's seq limit); Hd 80 at seq 197 and 577; Hd 128 at seq 362 and
# 530 (the whole-row backward's limit, vitax's K1)
WIDE = [("b16", 416), ("b16", 448), ("b16", 512), ("l16", 416),
        ("b32", 992), ("d640h8", 224), ("d640h8", 384), ("d1024h8", 304),
        ("d1024h8", 368)]
CASES = PRESET_CASES + [(a, i, m) for a, i in WIDE
                        for m in ("eval", "train")]
CAPACITY = 0.625  # the compacted rows of Res-ViT's rect half
KV_HEADS = 4      # Res-ViT's GQA runs (--n_kv_heads 4)


def _preset(arch):
    return t_config.ARCH_PRESETS.get(arch) or OFF_PRESETS[arch]


def _seq(arch, image):
    p = _preset(arch)
    return (image // p["patch"]) ** 2 + 1, p["emb_dim"], p["num_heads"]


def _resvit_cfg(arch, image, **kw):
    p = _preset(arch)
    return t_config.resvit_arch_config(
        "b16", image, dim=p["emb_dim"], mlp_dim=p["mlp_dim"],
        n_heads=p["num_heads"], **{"n_kv_heads": p["num_heads"], **kw})


def _vit_cfg(arch, image, **kw):
    if arch in t_config.ARCH_PRESETS:
        return t_config.arch_config(arch, image, 10, **kw)
    p = OFF_PRESETS[arch]
    return t_config.arch_config("b16", image, 10, **kw).replace(
        emb_dim=p["emb_dim"], mlp_dim=p["mlp_dim"], num_heads=p["num_heads"])


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
    it: "k1" (K1's family: K1, K3 on K13's core; K7 with GQA), "k10" or
    "plain"."""
    if cfg.fused_qkvo and tr.square_half_supported(tx, tw, cfg):
        return "k1"
    if tr.attention_is_fused(tx, cfg):
        return "k10" if not cfg.fused_qkvo else "raise"
    return "plain"


def _first_design_takes(route, tx, tw, cfg):
    """Whether the route's kernel takes the shapes: K1 and K3 with kv_heads
    == heads run K13's core, whose limits the route gate is, and so does
    K10 (its own gate, K13's limits); K7 (GQA) keeps the whole-row core,
    and raises by name where it does not."""
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    train = torch.is_grad_enabled()
    if route == "k1" and hkv != h:
        return ck._core_fits(tx, tw, h, hkv, backward=train)
    if route == "k10":
        return tr.k10_supported(tx, tw, cfg)
    return True


@pytest.mark.parametrize("kv", ["mha", "gqa"])
@pytest.mark.parametrize("arch,image,mode", CASES)
def test_resvit_halves_are_vitaxs(arch, image, mode, kv):
    """The square half at n_kv_heads = n_heads and 4 (the packed width), and
    the rect half on ceil(0.625·N) rows, which declines under GQA; with
    fused_qkvo vitax never reaches K9 on one device (its gate is the square
    one's), and without it runs K10 in `attention` wherever its gate passes
    without GQA: the port's route is vitax's everywhere. Where the route's
    kernel keeps the whole-row core and that core cannot take the shapes
    (K7 at seq 677), the kernel raises by name and never another path
    runs; on the presets every route's kernel takes them, and K10, on
    K13's core, takes every shape vitax routes to it."""
    s, d, h = _seq(arch, image)
    hkv = h if kv == "mha" else KV_HEADS
    hd = d // h
    (jx, jw), (tx, tw) = _shapes(2, s, d, (h + 2 * hkv) * hd)
    for qkvo in (True, False):
        cfg = _resvit_cfg(arch, image, n_kv_heads=hkv, fused_qkv=True,
                          fused_qkvo=qkvo)
        with torch.set_grad_enabled(mode == "train"):
            vitax_square = _vitax_square(jx, jw, h, hkv, qkvo)
            route = _port_square(tx, tw, cfg)
            assert route == vitax_square != "k9"
            takes = _first_design_takes(route, tx, tw, cfg)
            if (arch, image, mode) in PRESET_CASES:
                assert takes, (arch, image, mode, qkvo)
            elif route == "k10":
                assert takes, (arch, image, mode)
    cfg = _resvit_cfg(arch, image, n_kv_heads=hkv, fused_qkv=True,
                      fused_qkvo=True)
    with torch.set_grad_enabled(mode == "train"):
        cap = int(np.ceil(CAPACITY * s))
        spq, cpq = (s + 7) // 8 * 8, (cap + 7) // 8 * 8
        xp = torch.empty((2, spq, d), dtype=torch.bfloat16, device="meta")
        xcp = torch.empty((2, cpq, d), dtype=torch.bfloat16, device="meta")
        vitax_rect = hkv == h and pk.qkv_attention_supported(jx, jw)
        assert tr.rect_half_supported(xcp, xp, tw, cfg) == vitax_rect


def _k10_params(d, hkv, hd, h=None):
    """Meta parameters of Res-ViT's attention for `_k10_attention`'s
    merged weights (no LoRA)."""
    def lin(n_in, n_out):
        return {"kernel": torch.empty((n_in, n_out), device="meta",
                                      dtype=torch.bfloat16),
                "bias": torch.empty((n_out,), device="meta")}
    return {"wq": lin(d, d), "wk": lin(d, hkv * hd), "wv": lin(d, hkv * hd),
            "wo": lin(d, d)}


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


INT8_TIERS = {"--int8": dict(int8_attn=True, int8_mlp=True),
              "--int8-grad": dict(int8_attn=True, int8_mlp=True,
                                  int8_attn_grad=True, int8_mlp_grad=True),
              "--int8-dw": dict(int8_attn=True, int8_mlp=True,
                                int8_attn_grad=True, int8_mlp_grad=True,
                                int8_dw=True)}


class _PastTheCheck(Exception):
    pass


@pytest.mark.parametrize("tier", sorted(INT8_TIERS))
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_int8_tiers_at_416_run_k3_and_k4(monkeypatch, tier, mode):
    """ViT-B/16 at 416 px (seq 677): vitax's K1 gate passes, and so does
    the port's (K13's limits), so the int8 tiers pass `apply`'s check
    against K6 (`vit.py`, the NotImplementedError of Queue 1 item 8) and
    run K3 and K4, as vitax does; before K3's forward moved to K13's core,
    the port's whole-row gate sent them to that raise."""
    s, d, h = _seq("b16", 416)
    tx = torch.empty((2, s, d), dtype=torch.bfloat16, device="meta")
    tw = torch.empty((d, 3 * d), dtype=torch.bfloat16, device="meta")
    (jx, jw), _ = _shapes(2, s, d, 3 * d)
    assert _vitax_vit(jx, jw) == "k1"
    assert not ck._core_fits(tx, tw, h)  # the first design's core cannot
    monkeypatch.setattr(tvit, "embed", lambda params, images, cfg:
                        torch.zeros((1, s, d), dtype=torch.bfloat16))

    def past(*args, **kw):
        raise _PastTheCheck

    monkeypatch.setattr(tvit, "_padded_stream_len", past)
    cfg = t_config.arch_config("b16", 416, 10, fused_qkv=True,
                               fused_mlp=True, **INT8_TIERS[tier])
    with torch.set_grad_enabled(mode == "train"):
        assert tvit._attention_kernel(tx, tw, h) == "k1"
        with pytest.raises(_PastTheCheck):
            tvit.apply(None, torch.zeros((1, 416, 416, 3)), cfg,
                       train=mode == "train", gen=torch.Generator())


def _meta_half(arch, image, kv_heads=None):
    """Meta tensors of one fused attention half's arguments (x padded to
    spq) at a preset or an off-preset shape."""
    s, d, h = _seq(arch, image)
    hd, hkv = d // h, kv_heads or h
    spq = (s + 7) // 8 * 8
    width = (h + 2 * hkv) * hd

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    return dict(x=meta(2, spq, d, dtype=torch.bfloat16), gamma=meta(d),
                beta=meta(d), wqkv=meta(d, width, dtype=torch.bfloat16),
                bqkv=meta(width), wo=meta(h * hd, d, dtype=torch.bfloat16),
                bo=meta(d), do=meta(2, spq, d, dtype=torch.bfloat16)), \
        s, h, hd, hkv


# (path, the launch function and its tier, kv heads): every path that keeps
# the first design's whole-row core, forward and backward
FIRST_DESIGN = [
    ("K7", "bf16", KV_HEADS), ("K7's backward", "bf16_bwd", KV_HEADS),
    ("K7's int8 tier", "int8", KV_HEADS), ("R-F", "rect_int4", None)]


def _launch_checks(launch, t, s, h, hd, hkv):
    """The launch function's checks up to its first allocation, on meta
    tensors (its device check returns the meta device)."""
    x, g, be, w, bq, wo = (t[k] for k in ("x", "gamma", "beta", "wqkv",
                                          "bqkv", "wo"))
    if launch == "bf16":
        return ck._ln_qkvo_cuda("k", x, g, be, w, bq, wo, t["bo"], 1e-6, s,
                                h, hd, hkv)
    if launch == "bf16_bwd":
        return ck._ln_qkvo_bwd_cuda("k", x, g, be, w, bq, wo, t["do"], 1e-6,
                                    s, h, hd, hkv)
    if launch in ("int8", "int4"):
        return ck._ln_qkvo_int8_cuda("k", x, g, be, w, bq, wo, t["bo"], 1e-6,
                                     s, h, hd, hkv, None,
                                     int4=launch == "int4")
    if launch in ("int8_bwd", "int4_bwd"):
        return ck._ln_qkvo_int8_bwd_cuda("k", x, g, be, w, bq, wo, t["do"],
                                         1e-6, s, h, hd, hkv, False, None,
                                         int4=launch == "int4_bwd")
    xc = x[:, :x.shape[1] // 16 * 8]
    if launch == "rect_int4_bwd":
        return ck._rect_bwd_cuda("k", True, False, xc, x, g, be, w, bq, wo,
                                 t["do"][:, :xc.shape[1]], 1e-6, s, h, hd,
                                 int4=True)
    assert launch == "rect_int4", launch
    return ck._check_rect("k", xc, x, g, be, w, bq, wo, t["bo"], s, h, hd,
                          int4=True)


@pytest.mark.parametrize("arch,image", [("b16", 416), ("d640h8", 224)])
@pytest.mark.parametrize("path,launch,kv", FIRST_DESIGN)
def test_first_design_paths_raise_by_name_where_only_k13_fits(
        monkeypatch, arch, image, path, launch, kv):
    """Where the K1 family's gate and vitax's take a shape that the whole-row
    core cannot (seq 677; head dim 80), each path that keeps that core
    (K7's bf16 pair and int8 forward, R-F) raises its named error in its
    wrapper's checks, before it allocates or launches anything; K1's and
    K3's Hopper launches pass the same checks."""
    t, s, h, hd, hkv = _meta_half(arch, image, kv)
    assert ck.qkv_attention_supported(t["x"], t["wqkv"], h, hkv)
    assert not ck._core_fits(t["x"], t["wqkv"], h, hkv)
    monkeypatch.setattr(ck, "_check_cuda",
                        lambda name, tensors, dtypes: torch.device("meta"))
    with pytest.raises(NotImplementedError,
                       match=f"{path} keeps the first design.*Queue 2"):
        _launch_checks(launch, t, s, h, hd, hkv)
    # K1 and K3 with kv_heads == heads: K13's core takes the shapes
    t, s, h, hd, hkv = _meta_half(arch, image)
    ck._check_qkvo("k", t["x"], t["gamma"], t["beta"], t["wqkv"], t["bqkv"],
                   t["wo"], s, h, hd, ck.qkv_attention_supported)


@pytest.mark.parametrize("arch,image", [("b16", 416), ("d640h8", 224)])
def test_k5_takes_the_shapes_only_k13_fits(monkeypatch, arch, image):
    """K5's attention half runs K13's core: where the K1 family's gate and
    vitax's take a shape that the whole-row core cannot (seq 677; head dim
    80), its wrapper's checks pass before it allocates anything, as K1's
    and K3's Hopper launches do (the first block's pack checks the buffers
    the wrapper makes for it, of the same shapes); K5's MLP half takes those
    widths too."""
    t, s, h, hd, _ = _meta_half(arch, image)
    x = t["x"]
    b, spq, d = x.shape
    assert ck.qkv_attention_supported(x, t["wqkv"], h)
    assert not ck._core_fits(x, t["wqkv"], h)
    monkeypatch.setattr(ck, "_check_cuda",
                        lambda name, tensors, dtypes: torch.device("meta"))
    xq = torch.empty((b * spq, d), dtype=torch.int8, device="meta")
    sx = torch.empty((b * spq,), device="meta")
    assert ck._check_ho_attention(
        "k", x, xq, sx, t["gamma"], t["beta"], t["gamma"], t["beta"],
        t["wqkv"], t["bqkv"], t["wo"], t["bo"], s, h, hd) == \
        torch.device("meta")
    w1 = torch.empty((d, 4 * d), dtype=torch.bfloat16, device="meta")
    w2 = torch.empty((4 * d, d), dtype=torch.bfloat16, device="meta")
    assert ck.ln_mlp_supported(x.reshape(1, b * spq, d), w1, w2)


class _Allocates(Exception):
    """Raised where a launch function, its checks passed, loads the kernel
    library to allocate its scratch and launch."""


@pytest.mark.parametrize("int8_dw", [False, True])
@pytest.mark.parametrize("arch,image", [("b16", 416), ("d640h8", 224)])
def test_k7_int8_backward_takes_the_shapes_only_k13_fits(monkeypatch, arch,
                                                         image, int8_dw):
    """K7's int8 backward runs K3's Hopper sequence with K13's core in its
    GQA geometry: where the K1 family's gate and vitax's take a shape that
    the whole-row core cannot (seq 677; head dim 80) with 4 kv heads, its
    launch function's checks pass, with int8_dw off and on, and it goes on
    to load the library for its scratch and launch; K7's int8 forward at
    the same shapes, on the first design, still raises by name."""
    t, s, h, hd, hkv = _meta_half(arch, image, KV_HEADS)
    assert ck.qkv_attention_supported(t["x"], t["wqkv"], h, hkv)
    assert not ck._core_fits(t["x"], t["wqkv"], h, hkv, backward=True)
    monkeypatch.setattr(ck, "_check_cuda",
                        lambda name, tensors, dtypes: torch.device("meta"))

    def load():
        raise _Allocates

    monkeypatch.setattr(ck.build, "load", load)
    x, g, be, w, bq, wo = (t[k] for k in ("x", "gamma", "beta", "wqkv",
                                          "bqkv", "wo"))
    with pytest.raises(_Allocates):
        ck._ln_qkvo_int8_bwd_cuda("k", x, g, be, w, bq, wo, t["do"], 1e-6, s,
                                  h, hd, hkv, int8_dw, None)
    with pytest.raises(NotImplementedError,
                       match="K7's int8 tier keeps the first design.*Queue 2"):
        _launch_checks("int8", t, s, h, hd, hkv)


# (path, the launch function, kv heads): the A4W4 attention half, K3's
# Hopper sequences at L = 7 on K13's core (in its GQA geometry for G-F and
# G-B), and R-B, K8's int8 backward at L = 7 (K13's core in its rect
# geometry)
INT4_ATTENTION = [("K11-C", "int4", None), ("G-F", "int4", KV_HEADS),
                  ("K11-D", "int4_bwd", None), ("G-B", "int4_bwd", KV_HEADS),
                  ("R-B", "rect_int4_bwd", None)]


@pytest.mark.parametrize("arch,image", [("b16", 416), ("d640h8", 224)])
@pytest.mark.parametrize("path,launch,kv", INT4_ATTENTION)
def test_int4_attention_takes_the_shapes_only_k13_fits(monkeypatch, arch,
                                                       image, path, launch,
                                                       kv):
    """K11-C, G-F, K11-D and G-B run K3's Hopper sequences at L = 7 with
    K13's core, and R-B K8's int8 backward's: where the K1 family's gate
    and vitax's take a shape that the whole-row core cannot (seq 677; head
    dim 80), each launch function's checks pass, and it goes on to load the
    library for its scratch and launch, as K3's and K7's int8 backward
    do."""
    t, s, h, hd, hkv = _meta_half(arch, image, kv)
    assert ck.qkv_attention_supported(t["x"], t["wqkv"], h, hkv)
    assert not ck._core_fits(t["x"], t["wqkv"], h, hkv,
                             backward=launch == "int4_bwd")
    monkeypatch.setattr(ck, "_check_cuda",
                        lambda name, tensors, dtypes: torch.device("meta"))

    def load():
        raise _Allocates

    monkeypatch.setattr(ck.build, "load", load)
    with pytest.raises(_Allocates):
        _launch_checks(launch, t, s, h, hd, hkv)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("arch,image", [("b16", 416), ("d640h8", 224)])
def test_k8_int8_takes_the_shapes_only_k13_fits(monkeypatch, arch, image,
                                                backward):
    """K8's int8 tier runs K13's core in its rect geometry: where the K1
    family's gate and vitax's take a shape that the whole-row core cannot
    (seq 677; head dim 80), its wrappers' checks pass, forward and
    backward, before they allocate anything, as K5's and K3's Hopper
    launches do, and so do R-B's (K8's int8 backward at L = 7); R-F, its
    int4 forward on the first design, still raises by name."""
    t, s, h, hd, _ = _meta_half(arch, image)
    x = t["x"]
    xc = x[:, :x.shape[1] // 16 * 8]
    assert ck.qkv_attention_rect_supported(xc, x, t["wqkv"], h)
    assert not ck._core_fits(x, t["wqkv"], h)
    monkeypatch.setattr(ck, "_check_cuda",
                        lambda name, tensors, dtypes: torch.device("meta"))
    args = ("k", xc, x, t["gamma"], t["beta"], t["wqkv"], t["bqkv"], t["wo"],
            t["bo"], s, h, hd)
    ck._check_rect(*args, backward=backward)
    if backward:  # R-B
        ck._check_rect(*args, backward=True, int4=True)
        return
    with pytest.raises(NotImplementedError,
                       match="R-F keeps the first design.*Queue 2"):
        ck._check_rect(*args, int4=True)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("arch,image", [("b16", 416), ("d640h8", 224)])
def test_k8_bf16_takes_the_shapes_only_k13_fits(monkeypatch, arch, image,
                                                backward):
    """The bf16 K8 runs K1's Hopper launches with K13's core in its rect
    geometry: where the K1 family's gate and vitax's take a shape that the
    whole-row core cannot (seq 677; head dim 80), its wrappers' checks pass,
    forward and backward, before they allocate anything, as its int8
    tier's do."""
    t, s, h, hd, _ = _meta_half(arch, image)
    x = t["x"]
    xc = x[:, :x.shape[1] // 16 * 8]
    assert ck.qkv_attention_rect_supported(xc, x, t["wqkv"], h)
    assert not ck._core_fits(x, t["wqkv"], h, backward=backward)
    monkeypatch.setattr(ck, "_check_cuda",
                        lambda name, tensors, dtypes: torch.device("meta"))
    ck._check_rect("k", xc, x, t["gamma"], t["beta"], t["wqkv"], t["bqkv"],
                   t["wo"], None if backward else t["bo"], s, h, hd,
                   backward=backward)


# ------------------------------------------------------------ under a mesh

def test_k9_route_is_vitaxs_under_a_mesh():
    """Res-ViT under a mesh (vitax/models/resvit.py:220-277, 330-331): its
    fused half declines, and `attention` takes K9 where vitax's gate without
    heads passes (fused_qkv, fused_qkvo, no GQA). Wherever vitax takes K9,
    serving and training, the port's route is K9 and its K9 gate passes: K9
    runs K1's Hopper sequence on K13's core, so it takes every preset × {224,
    384} and the shapes off the presets that the whole-row core refused
    (seq 677, Hd 80, Hd 128 at seq 362 and 530); elsewhere both run the
    unfused attention."""
    from vitax_torch.parallel.mesh import Mesh
    mesh = Mesh(n_data=1, n_model=1, rank=0, data_group=None,
                model_group=None)
    taken = 0
    for arch, image, mode in CASES:
        s, d, h = _seq(arch, image)
        (jx, jw), (tx, tw) = _shapes(2, s, d, 3 * d)
        cfg = _resvit_cfg(arch, image, fused_qkv=True, fused_qkvo=True)
        with torch.set_grad_enabled(mode == "train"):
            vitax_k9 = bool(pk.qkv_attention_supported(jx, jw))
            assert tr._fused_attention_half(tx, None, cfg, mesh) is None
            assert tr.attention_is_fused(tx, cfg) == vitax_k9, (arch, image)
            if vitax_k9:
                assert tr.k9_supported(tx, tw, cfg), (arch, image, mode)
                taken += 1
    # 24 of the 42 cases: b16 and b32 at both sizes, l16 at 224, B/16 @416
    # and the (d, heads) pairs off the presets, both modes
    assert taken >= 20


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("arch,image", [("b16", 416), ("d640h8", 224)])
def test_k9_takes_the_shapes_only_k13_fits(monkeypatch, arch, image, mode):
    """K9 runs K1's Hopper sequence on K13's core, and K10 its first
    launches: where vitax's gate takes a shape that the whole-row core
    cannot (seq 677; head dim 80), the port's K9 and K10 gates take it,
    serving and training, and their wrappers' checks pass before they
    allocate anything. Neither gate has a dtype test, so a CUDA fp32 input
    reaches the wrapper's `check_k9_dtype` or `check_k10_dtype`."""
    s, d, h = _seq(arch, image)
    (jx, jw), (tx, tw) = _shapes(2, s, d, 3 * d)
    cfg = _resvit_cfg(arch, image, fused_qkv=True, fused_qkvo=True)
    assert pk.qkv_attention_supported(jx, jw)
    with torch.set_grad_enabled(mode == "train"):
        assert tr.k9_supported(tx, tw, cfg)
        assert tr.k10_supported(tx, tw, cfg.replace(fused_qkvo=False))
    t, s, h, hd, _ = _meta_half(arch, image)
    train = mode == "train"
    gate = (ck.fused_qkvo_attention_bwd_supported if train
            else ck.fused_qkvo_attention_supported)
    k10_gate = (ck.fused_qkv_attention_bwd_supported if train
                else ck.fused_qkv_attention_supported)
    for g in (gate, k10_gate):
        assert g(t["x"], t["wqkv"], h)
        assert g(t["x"].float(), t["wqkv"].float(), h)
    monkeypatch.setattr(ck, "_check_cuda",
                        lambda name, tensors, dtypes: torch.device("meta"))
    tensors = {"x": t["x"], "wqkv": t["wqkv"], "bqkv": t["bqkv"],
               "wo": t["wo"]}
    tensors.update({"do": t["do"]} if train else {"bo": t["bo"]})
    ck._check_k9("k", tensors, s, h, hd, gate)
    k10 = {"x": t["x"], "wqkv": t["wqkv"], "bqkv": t["bqkv"]}
    if train:
        k10["do"] = torch.empty((*t["x"].shape[:2], h * hd), device="meta",
                                dtype=torch.bfloat16)
    ck._check_k10("k", k10, s, h, hd, k10_gate)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        ck.check_k9_dtype("k", torch.float32)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        ck.check_k10_dtype("k", torch.float32)


def test_k9_raises_by_name_where_k13_does_not_fit():
    """Where vitax's gate takes K9 at a head dim that K13's core does not
    (d 640 with 16 heads: head dim 40), `_k9_attention` raises by name
    rather than run the unfused path or another kernel."""
    s, d, h = 197, 640, 16
    (jx, jw), (tx, tw) = _shapes(2, s, d, 3 * d)
    cfg = t_config.resvit_arch_config("b16", 224, dim=d, mlp_dim=4 * d,
                                      n_heads=h, n_kv_heads=h,
                                      fused_qkv=True, fused_qkvo=True)
    assert pk.qkv_attention_supported(jx, jw)
    for train in (False, True):
        with torch.set_grad_enabled(train):
            assert tr.attention_is_fused(tx, cfg)
            assert not tr.k9_supported(tx, tw, cfg)
            with pytest.raises(NotImplementedError,
                               match="fused_qkvo_attention .K9.*K13's core"):
                tr._k9_attention(tx, _k10_params(d, h, d // h), cfg)


def test_k10_raises_by_name_where_k13_does_not_fit():
    """Where vitax's gate takes K10 at a head dim that K13's core does not
    (d 640 with 16 heads: head dim 40), `_k10_attention` raises by name
    (K13's limits), serving and training, rather than run the unfused path
    or another kernel."""
    s, d, h = 197, 640, 16
    (jx, jw), (tx, tw) = _shapes(2, s, d, 3 * d)
    cfg = t_config.resvit_arch_config("b16", 224, dim=d, mlp_dim=4 * d,
                                      n_heads=h, n_kv_heads=h,
                                      fused_qkv=True, fused_qkvo=False)
    assert pk.qkv_attention_supported(jx, jw)
    assert _vitax_square(jx, jw, h, h, False) == "k10"
    for train in (False, True):
        with torch.set_grad_enabled(train):
            assert tr.attention_is_fused(tx, cfg)
            assert not tr.k10_supported(tx, tw, cfg)
            with pytest.raises(NotImplementedError,
                               match="fused_qkv_attention .K10.*K13's core"):
                tr._k10_attention(tx, _k10_params(d, h, d // h), cfg)


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
        m = _preset(arch)["mlp_dim"]
        (jx, _), (tx, _) = _shapes(2, s, d, 3 * d)
        cfg = _vit_cfg(arch, image, fused_qkv=True, fused_mlp=True)
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
            cfg = _vit_cfg(arch, image, fused_qkv=True, fused_mlp=True,
                           **flags)
            with torch.set_grad_enabled(mode == "train"):
                ran = tvit.tp_attention_supported(tx, cfg, tp)
                assert ran == bool(vitax_attn), (arch, image, mode, flags)
                if not ran:
                    with pytest.raises(NotImplementedError,
                                       match="Queue 1 item 8"):
                        tvit._tp_attention(tx, None, cfg, mesh)
            runs += ran
    assert runs > 0
