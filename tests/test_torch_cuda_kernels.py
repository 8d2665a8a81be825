"""The Hopper kernels of vitax_torch on a CUDA card: each against its plain
twin, forward and backward, the autograd Functions, and the wrappers'
argument checks. Needs torch only (no jax), so it runs on a machine with the
card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Where there is no card every test skips (the CUDA kernels have no CPU mode).
Tolerance: max|kernel - twin| <= 2e-2 * max(1, max|twin|) in bf16 (ulp 2^-8,
same rounding points, sums in another order), on every output; 1e-5 for the
fp32 LN.
"""

import pytest

torch = pytest.importorskip("torch")

from vitax_torch.ops import cuda_kernels as ck  # noqa: E402

pytestmark = pytest.mark.cuda
EPS = 1e-5
BWD_NAMES = ("layer_norm_bwd", "fused_ln_qkvo_attention_bwd",
             "fused_ln_mlp_bwd")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the twins' fp32 products
    return torch.device("cuda")


def _args(dev, batch, spq, seq, d, h, hd, m, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def n(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    f32 = torch.float32
    x = n(batch, spq, d)
    gamma, beta = 1 + n(d, scale=0.1, dtype=f32), n(d, scale=0.1, dtype=f32)
    ln = (x, gamma, beta, EPS)
    qkvo = (x, gamma, beta, n(d, 3 * h * hd, scale=d ** -0.5),
            n(3 * h * hd, scale=0.1, dtype=f32),
            n(h * hd, d, scale=(h * hd) ** -0.5), n(d, scale=0.1, dtype=f32),
            EPS, seq, h, hd)
    mlp = (x, gamma, beta, n(d, m, scale=d ** -0.5), n(m, scale=0.1, dtype=f32),
           n(m, d, scale=m ** -0.5), n(d, scale=0.1, dtype=f32), EPS)
    return ln, qkvo, mlp


def _bwd_args(dev, batch, spq, seq, d, h, hd, m, seed=0, rows=None):
    """Backward arguments; `rows` < spq cuts LN's and K2's x to a ragged
    row count (K1 takes the padded stream only)."""
    ln, qkvo, mlp = _args(dev, batch, spq, seq, d, h, hd, m, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    do = torch.randn((batch, spq, d), generator=g, device=dev).to(torch.bfloat16)
    x, x_r, do_r = ln[0], ln[0], do
    if rows is not None:
        x_r, do_r = x[:, :rows].contiguous(), do[:, :rows].contiguous()
    return {
        "layer_norm_bwd": (x_r, ln[1], do_r, EPS),
        "fused_ln_qkvo_attention_bwd": (x, *qkvo[1:6], do, *qkvo[7:]),
        "fused_ln_mlp_bwd": (x_r, *mlp[1:6], do_r, EPS),
    }


def _assert_close(out, ref, tol=2e-2):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert torch.isfinite(out).all()
    bound = tol * max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= bound


# (batch, spq, seq_len, D, heads, head_dim, M): the test config, ViT-B/16 at
# 224 and 384, and the head_dim 32 / 128 instantiations of the core
SHAPES = [(2, 16, 10, 128, 2, 64, 256), (3, 200, 197, 768, 12, 64, 3072),
          (2, 584, 577, 768, 12, 64, 3072), (2, 40, 33, 256, 8, 32, 512),
          (1, 64, 50, 256, 2, 128, 512)]

# backward: ViT-B/16 at train_cli's b32 and at b8 (spq 200), the token-drop
# geometry at keep 0.5 (1 + 98 tokens -> spq 104), a ragged row count
# (3 images x 197 rows for LN and K2, 3 images for K1), spq 584, the test
# config and head_dim 32 / 128
BWD_SHAPES = [(32, 200, 197, 768, 12, 64, 3072, None),
              (8, 200, 197, 768, 12, 64, 3072, None),
              (8, 104, 99, 768, 12, 64, 3072, None),
              (3, 200, 197, 768, 12, 64, 3072, 197),
              (2, 584, 577, 768, 12, 64, 3072, None),
              (2, 16, 10, 128, 2, 64, 256, None),
              (2, 40, 33, 256, 8, 32, 512, 37),
              (1, 64, 50, 256, 2, 128, 512, None)]


@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain_twins(dev, shape):
    ln, qkvo, mlp = _args(dev, *shape)
    ck.reset_launch_counts()
    with torch.inference_mode():
        _assert_close(ck.layer_norm(*ln), ck.layer_norm_ref(*ln))
        _assert_close(ck.fused_ln_qkvo_attention(*qkvo),
                      ck.fused_ln_qkvo_attention_ref(*qkvo))
        _assert_close(ck.fused_ln_mlp(*mlp), ck.fused_ln_mlp_ref(*mlp))
        torch.cuda.synchronize()
    counts = ck.launch_counts()
    assert {k: counts[k] for k in ("layer_norm", "fused_ln_qkvo_attention",
                                   "fused_ln_mlp")} == {
        "layer_norm": 1, "fused_ln_qkvo_attention": 1, "fused_ln_mlp": 1}


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_backward_kernels_match_plain_twins(dev, shape):
    args = _bwd_args(dev, *shape[:7], rows=shape[7])
    ck.reset_launch_counts()
    for name in BWD_NAMES:
        with torch.no_grad():
            outs = getattr(ck, name)(*args[name])
            torch.cuda.synchronize()
            refs = getattr(ck, name + "_ref")(*args[name])
        assert len(outs) == len(refs)
        for out, ref in zip(outs, refs):
            _assert_close(out, ref)
        del outs, refs
    assert {k: v for k, v in ck.launch_counts().items()
            if k in BWD_NAMES} == dict.fromkeys(BWD_NAMES, 1)


def test_backward_kernels_are_deterministic(dev):
    args = _bwd_args(dev, 8, 200, 197, 768, 12, 64, 3072)
    for name in BWD_NAMES:
        with torch.no_grad():
            a = getattr(ck, name)(*args[name])
            b = getattr(ck, name)(*args[name])
        for u, v in zip(a, b):
            assert torch.equal(u, v), name


def test_autograd_functions_launch_both_kernels(dev):
    ln, qkvo, mlp = _args(dev, 2, 200, 197, 768, 12, 64, 3072)
    leaves = {}

    def req(key, t):
        leaves[key] = t.detach().clone().requires_grad_()
        return leaves[key]

    ck.reset_launch_counts()
    x = req("x", ln[0])
    y = ck.layer_norm(x, req("g", ln[1]), req("b", ln[2]), EPS)
    y = ck.fused_ln_qkvo_attention(y, *(req(k, t) for k, t in zip(
        ("g1", "b1", "wqkv", "bqkv", "wo", "bo"), qkvo[1:7])), *qkvo[7:])
    y = ck.fused_ln_mlp(y, *(req(k, t) for k, t in zip(
        ("g2", "b2", "w1", "fb1", "w2", "fb2"), mlp[1:7])), EPS)
    assert type(y.grad_fn).__name__ == "FusedLnMlpFnBackward"
    y.float().square().mean().backward()
    torch.cuda.synchronize()
    assert {k: v for k, v in ck.launch_counts().items() if v} == \
        dict.fromkeys(("layer_norm", "fused_ln_qkvo_attention",
                       "fused_ln_mlp") + BWD_NAMES, 1)
    for key, t in leaves.items():
        assert t.grad is not None and t.grad.dtype == t.dtype, key
        assert t.grad.shape == t.shape and torch.isfinite(t.grad).all(), key


def test_fp32_layer_norm_and_ragged_rows(dev):
    x = torch.randn(3, 197, 768, device=dev)
    g, b = torch.rand(768, device=dev) + 0.5, torch.randn(768, device=dev)
    _assert_close(ck.layer_norm(x, g, b, EPS), ck.layer_norm_ref(x, g, b, EPS),
                  tol=1e-5)
    dy = torch.randn_like(x)
    for out, ref in zip(ck.layer_norm_bwd(x, g, dy, EPS),
                        ck.layer_norm_bwd_ref(x, g, dy, EPS)):
        _assert_close(out, ref, tol=1e-4)
    ln, _, mlp = _args(dev, 3, 197, 197, 768, 12, 64, 3072)
    with torch.inference_mode():
        _assert_close(ck.layer_norm(*ln), ck.layer_norm_ref(*ln))
        _assert_close(ck.fused_ln_mlp(*mlp), ck.fused_ln_mlp_ref(*mlp))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    ln, qkvo, mlp = _args(dev, 2, 16, 10, 128, 2, 64, 256)
    x = qkvo[0]
    # an input that needs grad goes through the autograd Function
    out = ck.fused_ln_mlp(x.clone().requires_grad_(), *mlp[1:])
    assert type(out.grad_fn).__name__ == "FusedLnMlpFnBackward"
    with pytest.raises(ValueError, match="contiguous"):
        ck.layer_norm(x.transpose(0, 1), *ln[1:])
    with pytest.raises(TypeError):
        ck.fused_ln_mlp(x.float(), *mlp[1:])
    with pytest.raises(ValueError):
        ck.fused_ln_qkvo_attention(x[:, :10].contiguous(), *qkvo[1:])
    with pytest.raises(ValueError, match="not CUDA"):
        ck.fused_ln_mlp(x, *mlp[1:3], mlp[3].cpu(), *mlp[4:])
    with pytest.raises(TypeError):
        ck.fused_ln_mlp_bwd(x, *mlp[1:6], x.float(), EPS)
    with pytest.raises(ValueError):
        ck.fused_ln_qkvo_attention_bwd(x, *qkvo[1:6], x[:1].contiguous(),
                                       *qkvo[7:])


# ---------------------------------------------------------------------------
# the W8A8 tiers (K3, K4): same tolerance, every output. Kernel and twin
# quantize on one grid; where an fp32 value sits on a .5 tie, the last-ulp
# differences between the kernel's and torch's LN, softmax and GELU move its
# code one step, which moves that row's output by one quantization step.

INT8_FWD = ("fused_ln_qkvo_attention_int8", "fused_ln_mlp_int8")
INT8_BWD = ("fused_ln_qkvo_attention_int8_bwd", "fused_ln_mlp_int8_bwd")
# (largest step, share of codes moved) of an activation code tensor against
# the twin's (chip_smoke.py's CODE_BAND, which says why aq and dqq move more)
CODE_BAND = {"xq": (1, 1e-3), "h1q": (2, 1e-3), "dh1q": (2, 1e-3),
             "aq": (2, 5e-3), "dqq": (2, 5e-3)}

# (batch, spq, seq_len, rows): serving b64 and training b32 at spq 200, K3 at
# spq 584 (b16@384), K4 on ragged rows (3 x 197)
INT8_SHAPES = [(64, 200, 197, None), (32, 200, 197, None),
               (8, 584, 577, None), (3, 200, 197, 197)]


def _int8_args(dev, batch, spq, seq, rows, seed=0):
    _, qkvo, mlp = _args(dev, batch, spq, seq, 768, 12, 64, 3072, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    do = torch.randn((batch, spq, 768), generator=g, device=dev).to(
        torch.bfloat16)
    x, do_r = mlp[0], do
    if rows is not None:
        x, do_r = x[:, :rows].contiguous(), do[:, :rows].contiguous()
    return {
        "fused_ln_qkvo_attention_int8": qkvo,
        "fused_ln_mlp_int8": (x, *mlp[1:]),
        "fused_ln_qkvo_attention_int8_bwd": (*qkvo[:6], do, *qkvo[7:]),
        "fused_ln_mlp_int8_bwd": (x, *mlp[1:6], do_r, EPS),
    }


@pytest.mark.parametrize("shape", INT8_SHAPES)
def test_int8_kernels_match_plain_twins(dev, shape):
    args = _int8_args(dev, *shape)
    names = INT8_FWD + INT8_BWD
    if shape[1] == 584:  # K3's geometry
        names = names[::2]
    elif shape[3] is not None:  # ragged rows are K4's
        names = names[1::2]
    ck.reset_launch_counts()
    for name in names:
        with torch.no_grad():
            outs = getattr(ck, name)(*args[name])
            torch.cuda.synchronize()
            refs = getattr(ck, name + "_ref")(*args[name])
        if not isinstance(outs, tuple):
            outs, refs = (outs,), (refs,)
        assert len(outs) == len(refs)
        for out, ref in zip(outs, refs):
            _assert_close(out, ref)
        del outs, refs
    assert {k: v for k, v in ck.launch_counts().items() if v} == \
        dict.fromkeys(names, 1)


def test_int8_ln_quant_codes_match_the_twin(dev):
    """The codes each int8 kernel writes (read back from its scratch)
    against its twin's, at train_cli's b32 spq 200: the weights' codes and
    scales the same bits; xq from the fp32 LN (forward, K3's backward) and
    from the bf16-rounded LN (K4's backward), aq, h1q, dqq and dh1q each
    within its CODE_BAND of moved codes; doq, the quantized input do, the
    same bits."""
    args = _int8_args(dev, 32, 200, 197, None)
    for name in INT8_FWD + INT8_BWD:
        sk, st = {}, {}
        with torch.no_grad():
            getattr(ck, name)(*args[name], scratch=sk)
            getattr(ck, name + "_ref")(*args[name], scratch=st)
        assert sk.keys() == st.keys()
        for key, (q, s) in st.items():
            qk, s_k = sk[key]
            assert qk.dtype == torch.int8 and qk.shape == q.shape, key
            if key.startswith("w") or key == "doq":
                assert torch.equal(qk, q) and torch.equal(s_k, s), key
                continue
            d = (qk.long() - q.long()).abs()
            share = d.float().mean().item()
            print(f"{name} {key}: {share:.2e} of codes moved, max "
                  f"{d.max().item()} step")
            max_step, max_share = CODE_BAND[key]
            assert d.max().item() <= max_step, (name, key)
            assert share <= max_share, (name, key)


def test_int8_backward_kernels_are_deterministic(dev):
    args = _int8_args(dev, 8, 200, 197, None)
    for name in INT8_BWD:
        with torch.no_grad():
            a = getattr(ck, name)(*args[name])
            b = getattr(ck, name)(*args[name])
        for u, v in zip(a, b):
            assert torch.equal(u, v), name


def test_int8_autograd_picks_the_backward_of_its_tier(dev):
    """Under --int8-grad the int8 backward kernels run; under --int8 alone
    the bf16 ones (K1/K2 bwd), as vitax's custom VJPs."""
    args = _int8_args(dev, 2, 200, 197, None)
    for int8_grad in (True, False):
        ck.reset_launch_counts()
        for name in INT8_FWD:
            a = [t.detach().clone().requires_grad_() if torch.is_tensor(t)
                 else t for t in args[name]]
            y = getattr(ck, name)(*a, int8_grad=int8_grad)
            y.float().square().mean().backward()
            for t in a:
                if torch.is_tensor(t):
                    assert t.grad.dtype == t.dtype
                    assert torch.isfinite(t.grad.float()).all()
        torch.cuda.synchronize()
        bwd = INT8_BWD if int8_grad else ("fused_ln_qkvo_attention_bwd",
                                          "fused_ln_mlp_bwd")
        assert {k: v for k, v in ck.launch_counts().items() if v} == \
            dict.fromkeys(INT8_FWD + bwd, 1)


# ---------------------------------------------------------------------------
# int8_dw (per-group int8 weight grads) and the int8 block handoff (K5): the
# same tolerance on every output; the codes each kernel wrote against the
# twin's (the column codes of int8_dw and the packed outputs of K5 quantize
# values that differ from the twin's by the bf16 flips above, hence the
# bands of aq/h1q).

DW_NAMES = ("fused_ln_qkvo_attention_int8_dw_bwd", "fused_ln_mlp_int8_dw_bwd")
HO_NAMES = ("fused_ln_qkvo_attention_int8_ho", "fused_ln_mlp_int8_ho")
CODE_BAND.update({"h1c": (2, 1e-3), "xnc": (2, 1e-3), "atc": (2, 5e-3),
                  "xq2": (2, 5e-3), "xqn": (2, 5e-3)})


def _codes_within_band(name, sk, st):
    assert sk.keys() == st.keys(), name
    for key, (q, s) in st.items():
        qk, s_k = sk[key]
        assert qk.dtype == torch.int8 and qk.shape == q.shape, (name, key)
        assert s_k.shape == s.shape, (name, key)
        if key.startswith("w") or key == "doq":
            assert torch.equal(qk, q) and torch.equal(s_k, s), (name, key)
            continue
        d = (qk.long() - q.long()).abs()
        print(f"{name} {key}: {d.float().mean().item():.2e} of codes moved, "
              f"max {d.max().item()} step")
        max_step, max_share = CODE_BAND[key]
        assert d.max().item() <= max_step, (name, key)
        assert d.float().mean().item() <= max_share, (name, key)


# (batch, spq, seq_len, rows): train_cli's dense b32 and drop-phase b32 spq
# 104, K4's ragged rows (3 x 197: groups 128, 128, 128, 128, 79)
DW_SHAPES = [(32, 200, 197, None), (32, 104, 99, None), (3, 200, 197, 197)]


@pytest.mark.parametrize("shape", DW_SHAPES)
def test_int8_dw_backward_kernels_match_plain_twins(dev, shape):
    args = _int8_args(dev, *shape)
    names = DW_NAMES[1:] if shape[3] is not None else DW_NAMES
    ck.reset_launch_counts()
    for name in names:
        a = args[name.replace("_dw", "")]
        sk, st = {}, {}
        with torch.no_grad():
            outs = getattr(ck, name)(*a, scratch=sk)
            torch.cuda.synchronize()
            refs = getattr(ck, name + "_ref")(*a, scratch=st)
        for out, ref in zip(outs, refs):
            _assert_close(out, ref)
        _codes_within_band(name, sk, st)
    assert {k: v for k, v in ck.launch_counts().items() if v} == \
        dict.fromkeys(names, 1)


def test_int8_dw_backward_kernels_are_deterministic(dev):
    args = _int8_args(dev, 8, 200, 197, None)
    for name in DW_NAMES:
        with torch.no_grad():
            a = getattr(ck, name)(*args[name.replace("_dw", "")])
            b = getattr(ck, name)(*args[name.replace("_dw", "")])
        for u, v in zip(a, b):
            assert torch.equal(u, v), name


def _ho_args(dev, batch, spq, seq):
    _, qkvo, mlp = _args(dev, batch, spq, seq, 768, 12, 64, 3072, seed=5)
    x, g1, be1, wqkv, bqkv, wo, bo = qkvo[:7]
    g2, be2 = 1 + 0.1 * g1.clone() - 0.1, be1.flip(0).contiguous()
    attn = (x, None, None, g1, be1, g2, be2, wqkv, bqkv, wo, bo, EPS, seq, 12,
            64)
    return attn, mlp[3:7]


@pytest.mark.parametrize("shape", [(32, 104, 99), (8, 200, 197)])
@pytest.mark.parametrize("pack", [True, False])
def test_handoff_kernels_match_plain_twins(dev, shape, pack):
    """K5's two kernels: the attention half packing its own input (the first
    block) or taking the twin's pack, then the MLP half on the attention
    half's outputs; r1/r2 within the tolerance, the packed codes within
    their band, every scratch code as K3's/K4's."""
    attn, (w1, b1, w2, b2) = _ho_args(dev, *shape)
    if not pack:
        xq, sx = ck.pack_rows(attn[0], attn[3], attn[4], EPS)
        attn = (attn[0], xq, sx, *attn[3:])
    ck.reset_launch_counts()
    sk, st = {}, {}
    with torch.no_grad():
        r1, xq2, sx2 = ck.fused_ln_qkvo_attention_int8_ho(*attn, scratch=sk)
        torch.cuda.synchronize()
        r1_t, xq2_t, sx2_t = ck.fused_ln_qkvo_attention_int8_ho_ref(
            *attn, scratch=st)
    _assert_close(r1, r1_t)
    _codes_within_band("fused_ln_qkvo_attention_int8_ho", sk, st)
    # the MLP half on the same input: the twin's packed r1
    mlp = (r1_t, xq2_t, sx2_t, attn[5], attn[6], w1, b1, w2, b2, EPS)
    sk, st = {}, {}
    with torch.no_grad():
        r2, _, _ = ck.fused_ln_mlp_int8_ho(*mlp, scratch=sk)
        torch.cuda.synchronize()
        r2_t, _, _ = ck.fused_ln_mlp_int8_ho_ref(*mlp, scratch=st)
    _assert_close(r2, r2_t)
    _codes_within_band("fused_ln_mlp_int8_ho", sk, st)
    assert {k: v for k, v in ck.launch_counts().items() if v} == \
        dict.fromkeys(HO_NAMES, 1)


@pytest.mark.parametrize("int8_dw", [True, False])
def test_handoff_block_autograd_launches_its_kernels(dev, int8_dw):
    attn, (w1, b1, w2, b2) = _ho_args(dev, 4, 104, 99)
    x, _, _, g1, be1, g2, be2, wqkv, bqkv, wo, bo = attn[:11]
    leaves = [t.detach().clone().requires_grad_() for t in
              (x, g1, be1, wqkv, bqkv, wo, bo, g2, be2, w1, b1, w2, b2)]
    ck.reset_launch_counts()
    r2, xqn, sxn = ck.fused_block_int8_handoff(
        leaves[0], None, None, *leaves[1:], g1, be1, EPS, 99, 12, 64, int8_dw)
    assert not (xqn.requires_grad or sxn.requires_grad)
    r2.float().square().mean().backward()
    torch.cuda.synchronize()
    bwd = DW_NAMES if int8_dw else INT8_BWD
    assert {k: v for k, v in ck.launch_counts().items() if v} == \
        dict.fromkeys(HO_NAMES + bwd, 1)
    for t in leaves:
        assert t.grad.dtype == t.dtype and torch.isfinite(t.grad.float()).all()


# ------------------------------------------------------------------ K7, K8
CODE_BAND["xqk"] = CODE_BAND["xq"]  # K8 int8: the LN codes of x's rows

# (batch, spq, seq_len, D, heads, kv_heads, head_dim): Res-ViT b16 serving
# at b64 with 4 and 6 kv heads, the test config with one
GQA_SHAPES = [(64, 200, 197, 768, 12, 4, 64), (64, 200, 197, 768, 12, 6, 64),
              (2, 16, 10, 128, 2, 1, 64)]


@pytest.mark.parametrize("shape", GQA_SHAPES)
def test_gqa_kernel_matches_twin(dev, shape):
    batch, spq, seq, d, h, hkv, hd = shape
    _, qkvo, _ = _args(dev, batch, spq, seq, d, h, hd, 4 * d)
    g = torch.Generator(device=dev).manual_seed(7)
    width = (h + 2 * hkv) * hd
    wqkv = (torch.randn((d, width), generator=g, device=dev)
            * d ** -0.5).to(torch.bfloat16)
    bqkv = 0.1 * torch.randn(width, generator=g, device=dev)
    args = (*qkvo[:3], wqkv, bqkv, *qkvo[5:], hkv)
    ck.reset_launch_counts()
    with torch.inference_mode():
        out = ck.fused_ln_qkvo_attention(*args[:-1], kv_heads=hkv)
        torch.cuda.synchronize()
        _assert_close(out, ck.fused_ln_qkvo_attention_gqa_ref(*args))
    counts = {k: v for k, v in ck.launch_counts().items() if v}
    assert counts == {"fused_ln_qkvo_attention_gqa": 1}


def _rect_args(dev, batch, spq, seq, cap, seed=0):
    """K1's arguments at ViT-B/16 width, and xc: `cap` rows of each image
    (a random choice of its first seq rows) zero-padded to round_up(cap, 8),
    with their indices."""
    _, qkvo, _ = _args(dev, batch, spq, seq, 768, 12, 64, 3072, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    idx = torch.stack([torch.randperm(seq, generator=g, device=dev)[:cap]
                       for _ in range(batch)])
    x = qkvo[0]
    xc = torch.zeros((batch, (cap + 7) // 8 * 8, 768), dtype=x.dtype,
                     device=dev)
    xc[:, :cap] = torch.gather(x, 1, idx[..., None].expand(-1, -1, 768))
    return xc, qkvo, idx


# (batch, spq, seq_len, cap): Res-ViT b16 serving at capacity 0.625 (124 of
# 197, cpq 128) and 0.5 (99, cpq 104), and a ragged small case
RECT_SHAPES = [(64, 200, 197, 124), (64, 200, 197, 99), (3, 200, 197, 37)]


@pytest.mark.parametrize("shape", RECT_SHAPES)
@pytest.mark.parametrize("int8", [False, True])
def test_rect_kernel_matches_twin_and_square_gather(dev, shape, int8):
    """K8 against its twin, and against the square kernel (K1, K3) on all
    rows followed by the row gather: the same bits, since every row's
    arithmetic is the same."""
    xc, qkvo, idx = _rect_args(dev, *shape)
    cap = shape[3]
    name = ("fused_ln_qkvo_attention_rect_int8" if int8
            else "fused_ln_qkvo_attention_rect")
    square = (ck.fused_ln_qkvo_attention_int8 if int8
              else ck.fused_ln_qkvo_attention)
    args = (xc, *qkvo)
    ck.reset_launch_counts()
    sk, st = {}, {}
    kw = (lambda s: {"scratch": s}) if int8 else (lambda s: {})
    with torch.inference_mode():
        out = getattr(ck, name)(*args, **kw(sk))
        torch.cuda.synchronize()
        _assert_close(out, getattr(ck, name + "_ref")(*args, **kw(st)))
        full = square(*qkvo)
    assert torch.isfinite(out).all()
    gathered = torch.gather(full, 1, idx[..., None].expand(-1, -1, 768))
    assert torch.equal(out[:, :cap], gathered)
    if int8:
        _codes_within_band(name, sk, st)
    counts = {k: v for k, v in ck.launch_counts().items() if v}
    assert counts == {name: 1, square.__name__: 1}


def test_rect_kernel_rejects_what_it_does_not_take(dev):
    xc, qkvo, _ = _rect_args(dev, 2, 200, 197, 20)
    with pytest.raises(ValueError):  # cpq not a multiple of 8
        ck.fused_ln_qkvo_attention_rect(xc[:, :20].contiguous(), *qkvo)
    with pytest.raises(TypeError):
        ck.fused_ln_qkvo_attention_rect(xc.float(), *qkvo)
    with pytest.raises(ValueError):  # another batch
        ck.fused_ln_qkvo_attention_rect(xc[:1].contiguous(), *qkvo)
    ck.reset_launch_counts()
    xg = xc.clone().requires_grad_()  # under autograd: K8's backward runs
    ck.fused_ln_qkvo_attention_rect(xg, *qkvo).float().sum().backward()
    torch.cuda.synchronize()
    assert {k: v for k, v in ck.launch_counts().items() if v} == {
        "fused_ln_qkvo_attention_rect": 1,
        "fused_ln_qkvo_attention_rect_bwd": 1}
    assert xg.grad.dtype == xg.dtype and torch.isfinite(xg.grad.float()).all()
    with pytest.raises(ValueError):  # the cotangent on the wrong rows
        ck.fused_ln_qkvo_attention_rect_bwd(xc, *qkvo[:6], qkvo[0],
                                            *qkvo[7:])


# ---------------------------------------------------------- K7, K8 backward
RECT_BWD = ("fused_ln_qkvo_attention_rect_bwd",
            "fused_ln_qkvo_attention_rect_int8_bwd",
            "fused_ln_qkvo_attention_rect_int8_dw_bwd")
# dkvq: as dqq; xnk: xn folded with the row scales of dkv, which move with
# the bf16 flips of dkv, hence atc's band
CODE_BAND.update({"dkvq": CODE_BAND["dqq"], "xnk": CODE_BAND["atc"]})

# (batch, spq, seq_len, D, heads, kv_heads, head_dim): Res-ViT b16 training
# at b32 with 4 and 6 kv heads, the test config with one
GQA_BWD_SHAPES = [(32, 200, 197, 768, 12, 4, 64),
                  (32, 200, 197, 768, 12, 6, 64), (2, 16, 10, 128, 2, 1, 64)]


def _gqa_bwd_args(dev, batch, spq, seq, d, h, hkv, hd):
    _, qkvo, _ = _args(dev, batch, spq, seq, d, h, hd, 4 * d)
    g = torch.Generator(device=dev).manual_seed(7)
    width = (h + 2 * hkv) * hd
    wqkv = (torch.randn((d, width), generator=g, device=dev)
            * d ** -0.5).to(torch.bfloat16)
    bqkv = 0.1 * torch.randn(width, generator=g, device=dev)
    do = torch.randn((batch, spq, d), generator=g, device=dev).to(
        torch.bfloat16)
    return (*qkvo[:3], wqkv, bqkv, qkvo[5], do, *qkvo[7:], hkv)


@pytest.mark.parametrize("shape", GQA_BWD_SHAPES)
def test_gqa_backward_kernel_matches_twin(dev, shape):
    """K7's backward against its twin on every output (dWqkv and dbqkv on the
    packed GQA width), through `fused_ln_qkvo_attention_bwd(kv_heads=)`;
    two launches give the same bits (the group sum has no atomics)."""
    args = _gqa_bwd_args(dev, *shape)
    ck.reset_launch_counts()
    with torch.no_grad():
        outs = ck.fused_ln_qkvo_attention_bwd(*args[:-1], kv_heads=args[-1])
        again = ck.fused_ln_qkvo_attention_gqa_bwd(*args)
        torch.cuda.synchronize()
        refs = ck.fused_ln_qkvo_attention_gqa_bwd_ref(*args)
    assert len(outs) == len(refs) == 7
    for out, ref, out2 in zip(outs, refs, again):
        _assert_close(out, ref)
        assert torch.equal(out, out2)
    assert {k: v for k, v in ck.launch_counts().items() if v} == {
        "fused_ln_qkvo_attention_gqa_bwd": 2}


def test_gqa_autograd_launches_the_gqa_backward(dev):
    args = _gqa_bwd_args(dev, 2, 200, 197, 768, 12, 4, 64)
    bo = torch.zeros(768, device=dev, requires_grad=True)
    leaves = [t.detach().clone().requires_grad_() for t in args[:6]]
    ck.reset_launch_counts()
    y = ck.fused_ln_qkvo_attention_gqa(*leaves, bo, *args[7:])
    y.float().square().mean().backward()
    torch.cuda.synchronize()
    assert {k: v for k, v in ck.launch_counts().items() if v} == {
        "fused_ln_qkvo_attention_gqa": 1,
        "fused_ln_qkvo_attention_gqa_bwd": 1}
    for t in leaves + [bo]:
        assert t.grad.dtype == t.dtype and torch.isfinite(t.grad.float()).all()


def _rect_bwd_args(dev, batch, spq, seq, cap, seed=0):
    """K8's backward arguments (xc, x, γ, β, Wqkv, bqkv, Wo, do, eps,
    seq_len, heads, head_dim), do zero on xc's pad rows as the caller's cut
    leaves it; and the row indices."""
    xc, qkvo, idx = _rect_args(dev, batch, spq, seq, cap, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 200)
    do = torch.randn(xc.shape, generator=g, device=dev).to(torch.bfloat16)
    do[:, cap:] = 0
    return (xc, *qkvo[:6], do, *qkvo[7:]), idx


# (batch, spq, seq_len, cap): Res-ViT b16 training at capacity 0.625 (b32,
# cpq 128; the fast recipe's token-drop geometry, 1 + 98 + 1 -> spq 104, cap
# 63, cpq 64, at b16) and a ragged small case
RECT_BWD_SHAPES = [(32, 200, 197, 124), (16, 104, 100, 63), (3, 200, 197, 37)]


@pytest.mark.parametrize("shape", RECT_BWD_SHAPES)
def test_rect_backward_kernels_match_twins(dev, shape):
    """K8's three backwards against their twins on every output, the int8
    ones also by their codes; two launches give the same bits."""
    args, _ = _rect_bwd_args(dev, *shape)
    ck.reset_launch_counts()
    for name in RECT_BWD:
        kw = (lambda s: {"scratch": s}) if "int8" in name else (lambda s: {})
        sk, st = {}, {}
        with torch.no_grad():
            outs = getattr(ck, name)(*args, **kw(sk))
            again = getattr(ck, name)(*args)
            torch.cuda.synchronize()
            refs = getattr(ck, name + "_ref")(*args, **kw(st))
        assert len(outs) == len(refs) == 8
        for out, ref, out2 in zip(outs, refs, again):
            _assert_close(out, ref)
            assert torch.equal(out, out2), name
        if "int8" in name:
            _codes_within_band(name, sk, st)
        del outs, refs, again
    assert {k: v for k, v in ck.launch_counts().items() if v} == \
        dict.fromkeys(RECT_BWD, 2)


def test_rect_backward_matches_square_backward_and_gather(dev):
    """K8's backward against K1's on all rows with `do` scattered to the kept
    rows, dxc added back through the gather transpose: within the bf16 band
    (K1 sums both dxn paths of a kept row in fp32 before one LN backward, K8
    runs one LN backward a row set and adds in bf16)."""
    args, idx = _rect_bwd_args(dev, 32, 200, 197, 124)
    xc, x, do = args[0], args[1], args[7]
    cap = idx.shape[1]
    rows = idx[..., None].expand(-1, -1, x.shape[-1])
    do_full = torch.zeros_like(x).scatter(1, rows, do[:, :cap])
    with torch.no_grad():
        rect = ck.fused_ln_qkvo_attention_rect_bwd(*args)
        square = ck.fused_ln_qkvo_attention_bwd(x, *args[2:7], do_full,
                                                *args[8:])
    dx = rect[1].float().scatter_add(1, rows, rect[0][:, :cap].float())
    _assert_close(dx, square[0].float())
    for out, ref in zip(rect[2:], square[1:]):
        _assert_close(out, ref)


def test_rect_autograd_picks_the_backward_of_its_tier(dev):
    """bf16 and --int8 alone take K8's bf16 backward; --int8-grad its int8
    one, --int8-dw the int8_dw one (vitax's tier rule, :4526)."""
    args, _ = _rect_bwd_args(dev, 2, 200, 197, 37)
    bo = torch.zeros(768, device=dev)
    for int8, int8_grad, int8_dw, bwd in (
            (False, False, False, RECT_BWD[0]), (True, False, False, RECT_BWD[0]),
            (True, True, False, RECT_BWD[1]), (True, True, True, RECT_BWD[2])):
        leaves = [t.detach().clone().requires_grad_() for t in args[:7]]
        ck.reset_launch_counts()
        if int8:
            y = ck.fused_ln_qkvo_attention_rect_int8(
                *leaves, bo, *args[8:], int8_grad=int8_grad, int8_dw=int8_dw)
        else:
            y = ck.fused_ln_qkvo_attention_rect(*leaves, bo, *args[8:])
        y.float().square().mean().backward()
        torch.cuda.synchronize()
        fwd = ("fused_ln_qkvo_attention_rect_int8" if int8
               else "fused_ln_qkvo_attention_rect")
        assert {k: v for k, v in ck.launch_counts().items() if v} == {
            fwd: 1, bwd: 1}
        for t in leaves:
            assert t.grad.dtype == t.dtype
            assert torch.isfinite(t.grad.float()).all()


# K6, the KV-chunked attention half: (batch, spq, seq_len, D, heads,
# head_dim): ViT-H/14 at 384 (spq 736) and 224 (spq 264), ViT-B/16 at 224,
# a ragged small case at hd 80, and head_dim 32 / 128
FLASH_SHAPES = [(2, 736, 730, 1280, 16, 80), (4, 264, 257, 1280, 16, 80),
                (2, 200, 197, 768, 12, 64), (3, 24, 21, 160, 2, 80),
                (2, 40, 33, 256, 8, 32), (1, 64, 50, 256, 2, 128)]


def _flash_args(dev, batch, spq, seq, d, h, hd, seed=0):
    _, qkvo, _ = _args(dev, batch, spq, seq, d, h, hd, 4 * d, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 300)
    do = torch.randn((batch, spq, d), generator=g, device=dev).to(
        torch.bfloat16)
    return qkvo, (*qkvo[:6], do, *qkvo[7:])


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_kernels_match_plain_twins(dev, shape):
    """K6 forward and backward against their twins on every output (the
    twins run vitax's KV chunks, the kernel 64-key tiles: the bf16 rounding
    of p moves with the tile's running max, inside the bf16 band); two
    backward launches give the same bits."""
    qkvo, bwd = _flash_args(dev, *shape)
    ck.reset_launch_counts()
    with torch.no_grad():
        _assert_close(ck.fused_ln_qkvo_attention_flash(*qkvo),
                      ck.fused_ln_qkvo_attention_flash_ref(*qkvo))
        outs = ck.fused_ln_qkvo_attention_flash_bwd(*bwd)
        again = ck.fused_ln_qkvo_attention_flash_bwd(*bwd)
        torch.cuda.synchronize()
        refs = ck.fused_ln_qkvo_attention_flash_bwd_ref(*bwd)
    assert len(outs) == len(refs) == 7
    for out, ref, out2 in zip(outs, refs, again):
        _assert_close(out, ref)
        assert torch.equal(out, out2)
    assert {k: v for k, v in ck.launch_counts().items() if v} == {
        "fused_ln_qkvo_attention_flash": 1,
        "fused_ln_qkvo_attention_flash_bwd": 2}


def test_flash_kernels_match_the_whole_row_kernels(dev):
    """K6 and K1 compute one function up to the softmax's rounding: at
    ViT-B/16's b8 spq 200, forward and backward within the bf16 band."""
    qkvo, bwd = _flash_args(dev, 8, 200, 197, 768, 12, 64)
    with torch.no_grad():
        _assert_close(ck.fused_ln_qkvo_attention_flash(*qkvo),
                      ck.fused_ln_qkvo_attention(*qkvo))
        for out, ref in zip(ck.fused_ln_qkvo_attention_flash_bwd(*bwd),
                            ck.fused_ln_qkvo_attention_bwd(*bwd)):
            _assert_close(out, ref)


def test_flash_autograd_launches_both_kernels(dev):
    qkvo, _ = _flash_args(dev, 2, 264, 257, 1280, 16, 80)
    leaves = [t.detach().clone().requires_grad_() for t in qkvo[:7]]
    ck.reset_launch_counts()
    y = ck.fused_ln_qkvo_attention_flash(*leaves, *qkvo[7:])
    assert type(y.grad_fn).__name__ == "FusedLnQkvoAttentionFlashFnBackward"
    y.float().square().mean().backward()
    torch.cuda.synchronize()
    assert {k: v for k, v in ck.launch_counts().items() if v} == {
        "fused_ln_qkvo_attention_flash": 1,
        "fused_ln_qkvo_attention_flash_bwd": 1}
    for t in leaves:
        assert t.grad.dtype == t.dtype and torch.isfinite(t.grad.float()).all()


def test_flash_gates_take_h14_and_k1_does_not(dev):
    for spq in (736, 264):
        x = torch.empty((2, spq, 1280), dtype=torch.bfloat16, device=dev)
        w = torch.empty((1280, 3 * 1280), dtype=torch.bfloat16, device=dev)
        assert not ck.qkv_attention_supported(x, w, 16)
        assert ck.qkv_attention_flash_supported(x, w, 16)
        assert ck.qkv_attention_flash_bwd_supported(x, w, 16)
        assert not ck.qkv_attention_flash_supported(x.float(), w, 16)


# K2's backward at d > 1024 (the :1610 route): ViT-H/14's widths at b2 spq
# 264 and on a ragged row count
@pytest.mark.parametrize("rows", [264, 257])
def test_wide_mlp_backward_matches_twin(dev, rows):
    _, _, mlp = _args(dev, 2, rows, rows, 1280, 16, 80, 5120)
    g = torch.Generator(device=dev).manual_seed(400)
    do = torch.randn(mlp[0].shape, generator=g, device=dev).to(torch.bfloat16)
    args = (*mlp[:6], do, EPS)
    ck.reset_launch_counts()
    with torch.no_grad():
        outs = ck.fused_ln_mlp_bwd(*args)
        torch.cuda.synchronize()
        refs = ck.fused_ln_mlp_bwd_wide_ref(*args)
    for out, ref in zip(outs, refs):
        _assert_close(out, ref)
    assert {k: v for k, v in ck.launch_counts().items() if v} == {
        "fused_ln_mlp_bwd_wide": 1}


# K13, the standalone attention core: (batch, heads, seq, head_dim, memory
# layout). ViT's b32 seq 197 in both layouts the port meets (the einsums'
# [B, S, H, Hd] memory and vitax's [B, H, S, Hd]), eval_cli's b8 seq 577,
# H/14's hd 80 at seq 730, seq 1024 at hd 128, the padded head dims 40 and
# 24 and the other multiples of 16, and ragged seqs
K13_SHAPES = [(32, 12, 197, 64, "bshd"), (32, 12, 197, 64, "bhsd"),
              (8, 12, 577, 64, "bshd"), (4, 16, 730, 80, "bshd"),
              (1, 2, 1024, 128, "bhsd"), (3, 4, 77, 40, "bshd"),
              (3, 4, 77, 48, "bhsd"), (2, 3, 21, 24, "bshd"),
              (2, 3, 33, 16, "bhsd"), (2, 3, 50, 96, "bshd"),
              (2, 3, 50, 112, "bhsd"), (2, 5, 21, 8, "bshd")]


def _k13_args(dev, b, h, s, hd, layout, seed=0):
    """q, k, v, do as [B, H, S, Hd] views of bf16 memory in `layout`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (b, s, h, hd) if layout == "bshd" else (b, h, s, hd)
    ts = [torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
          for _ in range(4)]
    return [t.transpose(1, 2) if layout == "bshd" else t for t in ts]


@pytest.mark.parametrize("shape", K13_SHAPES)
def test_attention_core_kernels_match_twins(dev, shape):
    """K13 forward and backward against their twins (vitax's whole-row
    softmax rounds the normalised p, the kernel's 64-key tiles the
    unnormalised p: inside the bf16 band); the grads come back in q's
    layout; two backward launches give the same bits."""
    q, k, v, do = _k13_args(dev, *shape)
    ck.reset_launch_counts()
    with torch.no_grad():
        out = ck.flash_attention_bhsd(q, k, v)
        grads = ck.flash_attention_bwd(q, k, v, out, do)
        again = ck.flash_attention_bwd(q, k, v, out, do)
        torch.cuda.synchronize()
        _assert_close(out, ck.flash_attention_bhsd_ref(q, k, v))
        refs = ck.flash_attention_bwd_ref(q, k, v, out, do)
    for g, ref, g2 in zip(grads, refs, again):
        _assert_close(g, ref)
        assert torch.equal(g, g2)
        assert g.stride() == q.stride() or shape[3] % 16
    assert {k: v for k, v in ck.launch_counts().items() if v} == {
        "flash_attention": 1, "flash_attention_bwd": 2}


def _guarded(n, dev, fill):
    """A bf16 buffer of n values followed by 4096 guard values `fill`."""
    return torch.full((n + 4096,), fill, dtype=torch.bfloat16, device=dev)


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_attention_core_stays_inside_ragged_tensors(dev, layout):
    """Unpadded rows (seq 21: the last 16-row query tile and 64-key tile
    run past the tensor's end): inputs that end right before NaN guard
    memory give finite outputs equal to the twin's, and the guard after
    each output is untouched. Run it under compute-sanitizer where that
    works: `compute-sanitizer python -m pytest --noconftest
    tests/test_torch_cuda_kernels.py -k ragged_tensors`."""
    from vitax_torch.kernels import build
    b, h, s, hd = 2, 3, 21, 64
    n = b * h * s * hd
    shape = (b, s, h, hd) if layout == "bshd" else (b, h, s, hd)
    images, heads = (b, h) if layout == "bshd" else (b * h, 1)
    src = _k13_args(dev, b, h, s, hd, layout, seed=3)
    bufs = []
    for t in src:
        buf = _guarded(n, dev, float("nan"))
        buf[:n].view(shape).copy_(t.transpose(1, 2) if layout == "bshd"
                                  else t)
        bufs.append(buf)
    outs = [_guarded(n, dev, 7.0) for _ in range(4)]
    L = (s + 15) // 16 * 16
    p, ds = (torch.empty(images * heads * L * L, dtype=torch.bfloat16,
                         device=dev) for _ in range(2))
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    scale = hd ** -0.5
    rc = lib.vitax_attention_core_fwd(*(t.data_ptr() for t in bufs[:3]),
                                      outs[0].data_ptr(), images, s, heads,
                                      hd, scale, stream)
    build.check(rc, "vitax_attention_core_fwd")
    out_buf = _guarded(n, dev, float("nan"))
    out_buf[:n].copy_(outs[0][:n])
    rc = lib.vitax_attention_core_bwd(
        *(t.data_ptr() for t in bufs[:3]), out_buf.data_ptr(),
        bufs[3].data_ptr(), *(t.data_ptr() for t in outs[1:]), p.data_ptr(),
        ds.data_ptr(), images, s, heads, hd, scale, stream)
    build.check(rc, "vitax_attention_core_bwd")
    torch.cuda.synchronize()

    def view(buf):
        t = buf[:n].view(shape)
        return t.transpose(1, 2) if layout == "bshd" else t

    q, k, v, do = src
    ref = ck.flash_attention_bhsd_ref(q, k, v)
    _assert_close(view(outs[0]), ref)
    for g, r in zip(map(view, outs[1:]),
                    ck.flash_attention_bwd_ref(q, k, v, view(out_buf), do)):
        _assert_close(g, r)
    for buf in outs:
        assert torch.all(buf[n:] == 7.0)


def test_attention_dispatch_runs_k13_on_bf16_and_raises_on_fp32(dev):
    """multi_head_attention{,_bhsd} on the card: K13's two kernels under
    autograd (no mha_ref, no library call); an fp32 input raises naming
    its queue item; outside vitax's gate (seq 1025) the plain version."""
    from vitax_torch.ops import attention as att
    q, k, v, do = _k13_args(dev, 2, 4, 65, 64, "bshd", seed=5)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ck.reset_launch_counts()
    y = att.multi_head_attention_bhsd(*leaves)
    assert type(y.grad_fn).__name__ == "FlashAttentionFnBackward"
    y.backward(do)
    y2 = att.multi_head_attention(*(t.transpose(1, 2) for t in (q, k, v)))
    torch.cuda.synchronize()
    assert {k: v for k, v in ck.launch_counts().items() if v} == {
        "flash_attention": 2, "flash_attention_bwd": 1}
    _assert_close(y2.transpose(1, 2), y.detach())
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        att.multi_head_attention_bhsd(q.float(), k.float(), v.float())
    long = torch.randn((1, 2, 1025, 64), device=dev).to(torch.bfloat16)
    ck.reset_launch_counts()
    _assert_close(att.multi_head_attention_bhsd(long, long, long),
                  att.mha_ref_bhsd(long, long, long))
    assert not any(ck.launch_counts().values())


# K7's int8 tier: Res-ViT b16 serving (b64) and training (b32) at spq 200
# with 4 kv heads, and the test config with one
INT8_GQA_SHAPES = [(64, 200, 197, 768, 12, 4, 64),
                   (32, 200, 197, 768, 12, 4, 64), (2, 16, 10, 128, 2, 1, 64)]
INT8_GQA = ("fused_ln_qkvo_attention_int8_gqa",
            "fused_ln_qkvo_attention_int8_gqa_bwd",
            "fused_ln_qkvo_attention_int8_gqa_dw_bwd")


@pytest.mark.parametrize("shape", INT8_GQA_SHAPES)
def test_int8_gqa_kernels_match_twins(dev, shape):
    """K7's int8 tier, forward, int8_grad and int8_dw backwards, through
    the K3 wrappers with kv_heads: every output within the bf16 band of
    its twin, the weights' codes the same bits, the activation codes
    within CODE_BAND."""
    args = _gqa_bwd_args(dev, *shape)
    fwd = (*args[:6], torch.zeros(shape[3], device=dev), *args[7:-1])
    hkv = args[-1]
    ck.reset_launch_counts()
    calls = (("fused_ln_qkvo_attention_int8", fwd),
             ("fused_ln_qkvo_attention_int8_bwd", args[:-1]),
             ("fused_ln_qkvo_attention_int8_dw_bwd", args[:-1]))
    for name, a in calls:
        sk, st = {}, {}
        with torch.no_grad():
            outs = getattr(ck, name)(*a, kv_heads=hkv, scratch=sk)
            torch.cuda.synchronize()
            refs = getattr(ck, name + "_ref")(*a, hkv, scratch=st)
        if not isinstance(outs, tuple):
            outs, refs = (outs,), (refs,)
        for out, ref in zip(outs, refs):
            _assert_close(out, ref)
        _codes_within_band(name, sk, st)
    assert {k: v for k, v in ck.launch_counts().items() if v} == \
        dict.fromkeys(INT8_GQA, 1)


@pytest.mark.parametrize("int8_dw", [False, True])
def test_int8_gqa_autograd_launches_its_backward(dev, int8_dw):
    args = _gqa_bwd_args(dev, 2, 200, 197, 768, 12, 4, 64)
    bo = torch.zeros(768, device=dev, requires_grad=True)
    leaves = [t.detach().clone().requires_grad_() for t in args[:6]]
    ck.reset_launch_counts()
    y = ck.fused_ln_qkvo_attention_int8(*leaves, bo, *args[7:-1],
                                        int8_grad=True, int8_dw=int8_dw,
                                        kv_heads=args[-1])
    y.float().square().mean().backward()
    torch.cuda.synchronize()
    assert {k: v for k, v in ck.launch_counts().items() if v} == {
        INT8_GQA[0]: 1, INT8_GQA[2 if int8_dw else 1]: 1}
    for t in leaves + [bo]:
        assert t.grad.dtype == t.dtype and torch.isfinite(t.grad.float()).all()


# ---------------------------------------------------------------------------
# K12, the save-acts pair, bf16 and int8: each save forward's out is K2's or
# K4's to the bit (the same launches compute it); every output within the
# tolerance of the twins on the same inputs, the backwards taking the
# kernel's saved tensors; the int8 codes within their bands (gpq, like h1q,
# quantizes a function of a1; doc, like h1c, the column codes of a folded
# operand).

CODE_BAND.update({"gpq": (1, 1e-3), "doc": (2, 1e-3)})
SAVE_NAMES = ("fused_ln_mlp_save", "fused_ln_mlp_bwd_fast",
              "fused_ln_mlp_int8_save", "fused_ln_mlp_int8_save_bwd",
              "fused_ln_mlp_int8_save_dw_bwd")
# (batch, spq, seq_len, rows): train_cli's b32, b8 on ragged rows (8 x 197),
# the drop phase's b32 spq 104
SAVE_SHAPES = [(32, 200, 197, None), (8, 200, 197, 197), (32, 104, 99, None)]


@pytest.mark.parametrize("shape", SAVE_SHAPES)
def test_save_kernels_match_twins(dev, shape):
    args = _int8_args(dev, *shape)
    mlp = args["fused_ln_mlp_int8"]
    x, gamma, beta, w1, _, w2, _, eps = mlp
    do = args["fused_ln_mlp_int8_bwd"][6]
    ck.reset_launch_counts()
    with torch.no_grad():
        saved = ck.fused_ln_mlp_save(*mlp)
        torch.cuda.synchronize()
        assert torch.equal(saved[0], ck.fused_ln_mlp(*mlp))
        for out, ref in zip(saved, ck.fused_ln_mlp_save_ref(*mlp)):
            _assert_close(out, ref)
        b = (x, gamma, beta, w1, w2, *saved[1:], do, eps)
        for out, ref in zip(ck.fused_ln_mlp_bwd_fast(*b),
                            ck.fused_ln_mlp_bwd_fast_ref(*b)):
            _assert_close(out, ref)
        sk, st = {}, {}
        saved = ck.fused_ln_mlp_int8_save(*mlp, scratch=sk)
        assert torch.equal(saved[0], ck.fused_ln_mlp_int8(*mlp))
        ref = ck.fused_ln_mlp_int8_save_ref(*mlp, scratch=st)
        _assert_close(saved[0], ref[0])
        _codes_within_band("fused_ln_mlp_int8_save", sk, st)
        b = (x, gamma, beta, w1, w2, *saved[1:], do, eps)
        for name in SAVE_NAMES[3:]:
            sk, st = {}, {}
            outs = getattr(ck, name)(*b, scratch=sk)
            refs = getattr(ck, name + "_ref")(*b, scratch=st)
            for out, ref in zip(outs, refs):
                _assert_close(out, ref)
            _codes_within_band(name, sk, st)
    assert {k: v for k, v in ck.launch_counts().items() if v} == {
        **dict.fromkeys(SAVE_NAMES, 1), "fused_ln_mlp": 1,
        "fused_ln_mlp_int8": 1}


def test_save_backward_kernels_are_deterministic(dev):
    args = _int8_args(dev, 8, 200, 197, None)
    mlp = args["fused_ln_mlp_int8"]
    x, gamma, beta, w1, _, w2, _, eps = mlp
    do = args["fused_ln_mlp_int8_bwd"][6]
    with torch.no_grad():
        b16 = (x, gamma, beta, w1, w2, *ck.fused_ln_mlp_save(*mlp)[1:], do,
               eps)
        b8 = (x, gamma, beta, w1, w2, *ck.fused_ln_mlp_int8_save(*mlp)[1:],
              do, eps)
        for name, b in zip(SAVE_NAMES[1::2] + SAVE_NAMES[4:], (b16, b8, b8)):
            for u, v in zip(getattr(ck, name)(*b), getattr(ck, name)(*b)):
                assert torch.equal(u, v), name


@pytest.mark.parametrize("tier", ["bf16", "int8", "int8-grad", "int8-dw"])
def test_save_acts_autograd_launches_its_pair(dev, tier):
    """save_acts under autograd: the save pair of its tier; `--int8` alone
    keeps K4 and K2's backward (vitax's dispatch); no grad, K2's forward."""
    mlp = _int8_args(dev, 2, 200, 197, None)["fused_ln_mlp_int8"]
    leaves = [t.detach().clone().requires_grad_() for t in mlp[:7]]
    ck.reset_launch_counts()
    if tier == "bf16":
        y = ck.fused_ln_mlp(*leaves, EPS, save_acts=True)
    else:
        y = ck.fused_ln_mlp_int8(*leaves, EPS, int8_grad=tier != "int8",
                                 int8_dw=tier == "int8-dw", save_acts=True)
    y.float().square().mean().backward()
    with torch.no_grad():
        ck.fused_ln_mlp(*mlp, save_acts=True)
    torch.cuda.synchronize()
    expect = {"bf16": SAVE_NAMES[:2], "int8": ("fused_ln_mlp_int8",
                                               "fused_ln_mlp_bwd"),
              "int8-grad": SAVE_NAMES[2:4],
              "int8-dw": SAVE_NAMES[2:3] + SAVE_NAMES[4:]}[tier]
    assert {k: v for k, v in ck.launch_counts().items() if v} == {
        **dict.fromkeys(expect, 1), "fused_ln_mlp": 1}
    for t in leaves:
        assert t.grad.dtype == t.dtype and torch.isfinite(t.grad.float()).all()


# ---------------------------------------------------------------------------
# K11, the A4W4 tiers (int4 codes in int8, limit 7): each kernel against its
# twin on every output, by its relative distance ‖k − t‖/‖t‖ <= 2e-2 (one
# moved int4 code moves its row's product by 1/7 of a term, past the bf16
# max-abs tolerance above, so the norm is the measure, as in chip_smoke.py);
# its codes against the twin's: the weights' and do's the same bits (do is
# the same bf16 input), each int4 activation code tensor within 1e-3 of its
# codes moved, each by one step (a step is 1/7 of a row's largest value, so
# an ulp moves a code only next to a .5 tie); the int8_dw column codes
# within the int8 bands, but attn's and dqkv's up to 3 steps: one moved xq
# code of K11-D's recompute moves the keys and values of its whole image
# (one of 2.6e6 at b32 spq 104 moved 1.6e-3 of atc's codes, 1.7e-3 of
# dqc's).

INT4_FWD = ("fused_ln_qkvo_attention_int4", "fused_ln_mlp_int4")
INT4_BWD = ("fused_ln_qkvo_attention_int4_bwd", "fused_ln_mlp_int4_bwd",
            "fused_ln_qkvo_attention_int4_dw_bwd", "fused_ln_mlp_int4_dw_bwd")
INT4_REL = 2e-2
INT4_CODE_BAND = {"xq": (1, 1e-3), "h1q": (1, 1e-3), "dh1q": (1, 1e-3),
                  "aq": (1, 1e-3), "dqq": (1, 1e-3), "h1c": (2, 1e-3),
                  "xnc": (2, 1e-3), "dh1c": (2, 1e-3), "atc": (4, 5e-3),
                  "dqc": (4, 5e-3)}
# (batch, spq, seq_len, rows): train_cli's b32 spq 200, the drop phase's
# spq 104, K11-A/B on ragged rows (3 x 197; the int8_dw rows padded to
# vitax's groups: 591 rows in 5 groups of 128)
INT4_SHAPES = [(32, 200, 197, None), (32, 104, 99, None), (3, 200, 197, 197)]


def _int4_args(dev, batch, spq, seq, rows):
    a = _int8_args(dev, batch, spq, seq, rows)
    return {n: a[n.replace("int4", "int8").replace("_dw", "")]
            for n in INT4_FWD + INT4_BWD}


@pytest.mark.parametrize("shape", INT4_SHAPES)
def test_int4_kernels_match_plain_twins(dev, shape):
    args = _int4_args(dev, *shape)
    names = INT4_FWD + INT4_BWD
    if shape[3] is not None:  # ragged rows are the MLP half's
        names = names[1::2]
    ck.reset_launch_counts()
    for name in names:
        sk, st = {}, {}
        with torch.no_grad():
            outs = getattr(ck, name)(*args[name], scratch=sk)
            torch.cuda.synchronize()
            refs = getattr(ck, name + "_ref")(*args[name], scratch=st)
        if not isinstance(outs, tuple):
            outs, refs = (outs,), (refs,)
        assert len(outs) == len(refs) and sk.keys() == st.keys(), name
        moves = {}
        for key, (q, s) in st.items():
            qk, s_k = sk[key]
            assert qk.dtype == torch.int8 and qk.shape == q.shape, (name, key)
            if key.startswith("w") or key in ("doq", "doc"):
                assert torch.equal(qk, q) and torch.equal(s_k, s), (name, key)
                continue
            d = (qk.long() - q.long()).abs()
            moves[key] = (d.max().item(), d.float().mean().item())
        print(f"{name} {shape}: codes moved (max step, share) {moves}")
        for key, (top, share) in moves.items():
            max_step, max_share = INT4_CODE_BAND[key]
            assert top <= max_step and share <= max_share, (name, key)
        for i, (out, ref) in enumerate(zip(outs, refs)):
            assert out.shape == ref.shape and out.dtype == ref.dtype
            assert torch.isfinite(out).all()
            rel = ((out.float() - ref.float()).norm()
                   / ref.float().norm().clamp_min(1e-30)).item()
            print(f"{name} output {i}: ‖k − t‖/‖t‖ {rel:.2e}")
            assert rel <= INT4_REL, (name, i)
        del outs, refs
    assert {k: v for k, v in ck.launch_counts().items() if v} == \
        dict.fromkeys(names, 1)


def test_int4_backward_kernels_are_deterministic(dev):
    args = _int4_args(dev, 8, 200, 197, None)
    for name in INT4_BWD:
        with torch.no_grad():
            a = getattr(ck, name)(*args[name])
            b = getattr(ck, name)(*args[name])
        for u, v in zip(a, b):
            assert torch.equal(u, v), name


# (half, flags of the int4 wrapper, the backward kernel vitax's dispatch
# picks): the MLP's K11-B under int4_grad, else K4's under int8_grad, else
# K2's; the attention half's K11-D only under int8_grad and int4_grad
INT4_TIERS = [
    ("mlp", {}, "fused_ln_mlp_bwd"),
    ("mlp", dict(int8_grad=True), "fused_ln_mlp_int8_bwd"),
    ("mlp", dict(int4_grad=True), "fused_ln_mlp_int4_bwd"),
    ("mlp", dict(int4_grad=True, int8_dw=True), "fused_ln_mlp_int4_dw_bwd"),
    ("attn", {}, "fused_ln_qkvo_attention_bwd"),
    ("attn", dict(int4_grad=True), "fused_ln_qkvo_attention_bwd"),
    ("attn", dict(int8_grad=True, int4_grad=True),
     "fused_ln_qkvo_attention_int4_bwd"),
    ("attn", dict(int8_grad=True, int4_grad=True, int8_dw=True),
     "fused_ln_qkvo_attention_int4_dw_bwd"),
]


@pytest.mark.parametrize("half,flags,bwd", INT4_TIERS)
def test_int4_autograd_picks_the_backward_of_its_tier(dev, half, flags, bwd):
    name = "fused_ln_mlp_int4" if half == "mlp" else \
        "fused_ln_qkvo_attention_int4"
    args = _int4_args(dev, 2, 200, 197, None)[name]
    ck.reset_launch_counts()
    a = [t.detach().clone().requires_grad_() if torch.is_tensor(t) else t
         for t in args]
    y = getattr(ck, name)(*a, **flags)
    y.float().square().mean().backward()
    torch.cuda.synchronize()
    for t in a:
        if torch.is_tensor(t):
            assert t.grad.dtype == t.dtype
            assert torch.isfinite(t.grad.float()).all()
    assert {k: v for k, v in ck.launch_counts().items() if v} == {name: 1,
                                                                  bwd: 1}


# ---------------------------------------------------------------------------
# Res-ViT's int4: R-F, R-B and R-B dw (the rect half, ln_qkvo_attention_rect_
# int8{,_bwd}.cu at L = 7) and G-F, G-B (K11's kv_heads branches): each
# against its twin as K11's are held (codes; ‖k − t‖/‖t‖ <= INT4_REL). xqk
# and dkvq quantize x's rows as xq and dqq do xc's; dkvc is dK/dV's column
# pack, as dqc is dqkv's.
RESVIT_INT4_CODE_BAND = dict(INT4_CODE_BAND, xqk=(1, 1e-3), dkvq=(1, 1e-3),
                             xnk=(2, 1e-3), dkvc=(4, 5e-3))
RECT_INT4 = ("fused_ln_qkvo_attention_rect_int4",
             "fused_ln_qkvo_attention_rect_int4_bwd",
             "fused_ln_qkvo_attention_rect_int4_dw_bwd")
GQA_INT4 = ("fused_ln_qkvo_attention_int4_gqa",
            "fused_ln_qkvo_attention_int4_gqa_bwd",
            "fused_ln_qkvo_attention_int4_gqa_dw_bwd")


def _hold_int4(name, args, kv=()):
    sk, st = {}, {}
    with torch.no_grad():
        outs = getattr(ck, name)(*args, *kv, scratch=sk)
        again = getattr(ck, name)(*args, *kv)
        torch.cuda.synchronize()
        refs = getattr(ck, name + "_ref")(*args, *kv, scratch=st)
    if not isinstance(outs, tuple):
        outs, refs, again = (outs,), (refs,), (again,)
    assert len(outs) == len(refs) and sk.keys() == st.keys(), name
    for key, (q, s) in st.items():
        qk, s_k = sk[key]
        assert qk.dtype == torch.int8 and qk.shape == q.shape, (name, key)
        if key.startswith("w") or key in ("doq", "doc"):
            assert torch.equal(qk, q) and torch.equal(s_k, s), (name, key)
            continue
        d = (qk.long() - q.long()).abs()
        max_step, max_share = RESVIT_INT4_CODE_BAND[key]
        print(f"{name} {key}: {d.float().mean().item():.2e} moved, max "
              f"{d.max().item()}")
        assert d.max().item() <= max_step, (name, key)
        assert d.float().mean().item() <= max_share, (name, key)
    for i, (out, ref, out2) in enumerate(zip(outs, refs, again)):
        assert out.shape == ref.shape and out.dtype == ref.dtype
        assert torch.isfinite(out).all() and torch.equal(out, out2)
        rel = ((out.float() - ref.float()).norm()
               / ref.float().norm().clamp_min(1e-30)).item()
        print(f"{name} output {i}: ‖k − t‖/‖t‖ {rel:.2e}")
        assert rel <= INT4_REL, (name, i)


@pytest.mark.parametrize("shape", RECT_BWD_SHAPES)
def test_rect_int4_kernels_match_twins(dev, shape):
    args, _ = _rect_bwd_args(dev, *shape)
    fwd = (*args[:7], torch.zeros(768, device=dev), *args[8:])
    ck.reset_launch_counts()
    _hold_int4(RECT_INT4[0], fwd)
    for name in RECT_INT4[1:]:
        _hold_int4(name, args)
    assert {k: v for k, v in ck.launch_counts().items() if v} == \
        dict.fromkeys(RECT_INT4, 2)


@pytest.mark.parametrize("shape", INT8_GQA_SHAPES[1:])
def test_int4_gqa_kernels_match_twins(dev, shape):
    args = _gqa_bwd_args(dev, *shape)
    hkv = args[-1]
    fwd = (*args[:6], torch.zeros(shape[3], device=dev), *args[7:-1])
    ck.reset_launch_counts()
    _hold_int4(GQA_INT4[0], fwd, (hkv,))
    for name in GQA_INT4[1:]:
        _hold_int4(name, args[:-1], (hkv,))
    assert {k: v for k, v in ck.launch_counts().items() if v} == \
        dict.fromkeys(GQA_INT4, 2)


# (flags, the backward vitax's dispatch picks): R-B / G-B only under
# int8_grad and int4_grad, K8's / K7's int8 backward under int8_grad alone
RESVIT_INT4_TIERS = [({}, "bwd"), (dict(int4_grad=True), "bwd"),
                     (dict(int8_grad=True), "int8_bwd"),
                     (dict(int8_grad=True, int4_grad=True), "int4_bwd"),
                     (dict(int8_grad=True, int4_grad=True, int8_dw=True),
                      "int4_dw_bwd")]


@pytest.mark.parametrize("half", ["rect", "gqa"])
@pytest.mark.parametrize("flags,bwd", RESVIT_INT4_TIERS)
def test_resvit_int4_autograd_picks_the_backward_of_its_tier(dev, half,
                                                             flags, bwd):
    if half == "rect":
        args, _ = _rect_bwd_args(dev, 2, 200, 197, 37)
        leaves, tail, kw = args[:7], args[8:], {}
        fwd, name = ck.fused_ln_qkvo_attention_rect_int4, RECT_INT4[0]
        bwd = "fused_ln_qkvo_attention_rect_" + bwd
    else:
        args = _gqa_bwd_args(dev, 2, 200, 197, 768, 12, 4, 64)
        leaves, tail, kw = args[:6], args[7:-1], dict(kv_heads=args[-1])
        fwd, name = ck.fused_ln_qkvo_attention_int4, GQA_INT4[0]
        bwd = "fused_ln_qkvo_attention_" + {
            "bwd": "gqa_bwd", "int8_bwd": "int8_gqa_bwd",
            "int4_bwd": "int4_gqa_bwd", "int4_dw_bwd": "int4_gqa_dw_bwd"}[bwd]
    leaves = [t.detach().clone().requires_grad_() for t in leaves]
    bo = torch.zeros(768, device=dev, requires_grad=True)
    ck.reset_launch_counts()
    y = fwd(*leaves, bo, *tail, **flags, **kw)
    y.float().square().mean().backward()
    torch.cuda.synchronize()
    assert {k: v for k, v in ck.launch_counts().items() if v} == {name: 1,
                                                                  bwd: 1}
    for t in leaves + [bo]:
        assert t.grad.dtype == t.dtype and torch.isfinite(t.grad.float()).all()


# ---------------------------------------------------------------- K10
# (batch, spq, seq_len, D, heads, head_dim): Res-ViT serving's b64 spq 200
# and training's b32, a ragged seq in a small spq, and the head_dim 32 / 128
# instantiations of the core
K10_SHAPES = [(64, 200, 197, 768, 12, 64), (32, 200, 197, 768, 12, 64),
              (2, 24, 17, 128, 4, 32), (3, 200, 197, 768, 6, 128)]


def _k10_args(dev, batch, spq, seq, d, h, hd, seed=0):
    """x̂ (the LN output: zero pad rows past seq), wqkv, bqkv, do (zero on
    the pad rows, as the model's row cut leaves it), seq_len, heads,
    head_dim."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((batch, spq, d), generator=g, device=dev)
    x[:, seq:] = 0
    wqkv = torch.randn((d, 3 * h * hd), generator=g, device=dev) * d ** -0.5
    bqkv = 0.1 * torch.randn(3 * h * hd, generator=g, device=dev)
    do = torch.randn((batch, spq, h * hd), generator=g, device=dev)
    do[:, seq:] = 0
    bf = torch.bfloat16
    return x.to(bf), wqkv.to(bf), bqkv, do.to(bf), seq, h, hd


@pytest.mark.parametrize("shape", K10_SHAPES)
def test_k10_kernels_match_twins(dev, shape):
    """K10's forward and every output of its backward against the twins;
    two backward launches give the same bits (no atomics)."""
    x, w, b, do, *meta = _k10_args(dev, *shape)
    ck.reset_launch_counts()
    with torch.no_grad():
        out = ck.fused_qkv_attention(x, w, b, *meta)
        grads = ck.fused_qkv_attention_bwd(x, w, b, do, *meta)
        again = ck.fused_qkv_attention_bwd(x, w, b, do, *meta)
        torch.cuda.synchronize()
        _assert_close(out, ck.fused_qkv_attention_ref(x, w, b, *meta))
        refs = ck.fused_qkv_attention_bwd_ref(x, w, b, do, *meta)
    assert len(grads) == len(refs) == 3
    for g, r, g2 in zip(grads, refs, again):
        _assert_close(g, r)
        assert torch.equal(g, g2)
    assert {k: v for k, v in ck.launch_counts().items() if v} == {
        "fused_qkv_attention": 1, "fused_qkv_attention_bwd": 2}


def test_k10_autograd_launches_both_kernels_and_fp32_raises(dev):
    """Under autograd K10 runs its forward and backward kernels, dW comes
    back in W's dtype and db in fp32; an fp32 input raises Queue 1 item 9's
    message; shapes outside the gate raise."""
    x, w, b, do, *meta = _k10_args(dev, 2, 200, 197, 768, 12, 64)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    ck.reset_launch_counts()
    ck.fused_qkv_attention(*leaves, *meta).backward(do)
    torch.cuda.synchronize()
    assert {k: v for k, v in ck.launch_counts().items() if v} == {
        "fused_qkv_attention": 1, "fused_qkv_attention_bwd": 1}
    for t in leaves:
        assert t.grad.dtype == t.dtype and torch.isfinite(t.grad.float()).all()
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        ck.fused_qkv_attention(x.float(), w.float(), b, *meta)
    with pytest.raises(ValueError, match="unsupported shapes"):
        ck.fused_qkv_attention(x[:, :196].contiguous(), w, b, *meta)


# K9: (batch, spq, seq_len, D, heads, head_dim): Res-ViT serving's b64 spq
# 200 and training's b32, a ragged seq in a small spq, the TP shard width
# (6 heads of a 768 model: wqkv [768, 1152], wo [384, 768]) and the
# head_dim 32 / 128 instantiations of the core
K9_SHAPES = [(64, 200, 197, 768, 12, 64), (32, 200, 197, 768, 12, 64),
             (2, 24, 17, 128, 4, 32), (32, 200, 197, 768, 6, 64),
             (3, 200, 197, 768, 6, 128)]


def _k9_args(dev, batch, spq, seq, d, h, hd, seed=0):
    """x̂ (the LN output: zero pad rows past seq), wqkv, bqkv, wo [H·Hd, D],
    bo, dY (zero on the pad rows), seq_len, heads, head_dim."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((batch, spq, d), generator=g, device=dev)
    x[:, seq:] = 0
    hhd = h * hd
    wqkv = torch.randn((d, 3 * hhd), generator=g, device=dev) * d ** -0.5
    bqkv = 0.1 * torch.randn(3 * hhd, generator=g, device=dev)
    wo = torch.randn((hhd, d), generator=g, device=dev) * hhd ** -0.5
    bo = 0.1 * torch.randn(d, generator=g, device=dev)
    do = torch.randn((batch, spq, d), generator=g, device=dev)
    do[:, seq:] = 0
    bf = torch.bfloat16
    return (x.to(bf), wqkv.to(bf), bqkv, wo.to(bf), bo, do.to(bf), seq, h,
            hd)


@pytest.mark.parametrize("shape", K9_SHAPES)
def test_k9_kernels_match_twins(dev, shape):
    """K9's forward and every output of its backward (dx, dW, db, dWo, dbo)
    against the twins; two backward launches give the same bits."""
    x, w, b, wo, bo, do, *meta = _k9_args(dev, *shape)
    ck.reset_launch_counts()
    with torch.no_grad():
        out = ck.fused_qkvo_attention(x, w, b, wo, bo, *meta)
        grads = ck.fused_qkvo_attention_bwd(x, w, b, wo, do, *meta)
        again = ck.fused_qkvo_attention_bwd(x, w, b, wo, do, *meta)
        torch.cuda.synchronize()
        _assert_close(out, ck.fused_qkvo_attention_ref(x, w, b, wo, bo,
                                                       *meta))
        refs = ck.fused_qkvo_attention_bwd_ref(x, w, b, wo, do, *meta)
    assert len(grads) == len(refs) == 5
    for g, r, g2 in zip(grads, refs, again):
        _assert_close(g, r)
        assert torch.equal(g, g2)
    assert {k: v for k, v in ck.launch_counts().items() if v} == {
        "fused_qkvo_attention": 1, "fused_qkvo_attention_bwd": 2}


def test_k9_autograd_launches_both_kernels_and_fp32_raises(dev):
    """Under autograd K9 runs its forward and backward kernels, dW and dWo
    come back in their weights' dtype, db and dbo in fp32; an fp32 input
    raises Queue 1 item 9's message; shapes outside the gate raise."""
    x, w, b, wo, bo, do, *meta = _k9_args(dev, 2, 200, 197, 768, 12, 64)
    leaves = [t.clone().requires_grad_() for t in (x, w, b, wo, bo)]
    ck.reset_launch_counts()
    ck.fused_qkvo_attention(*leaves, *meta).backward(do)
    torch.cuda.synchronize()
    assert {k: v for k, v in ck.launch_counts().items() if v} == {
        "fused_qkvo_attention": 1, "fused_qkvo_attention_bwd": 1}
    for t in leaves:
        assert t.grad.dtype == t.dtype and torch.isfinite(t.grad.float()).all()
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        ck.fused_qkvo_attention(x.float(), w.float(), b, wo.float(), bo,
                                *meta)
    with pytest.raises(ValueError, match="unsupported shapes"):
        ck.fused_qkvo_attention(x[:, :196].contiguous(), w, b, wo, bo, *meta)


# K2 without its residual: ViT-B/16's b32 spq 200 at M 3072 and at the TP
# shard width M 1536, and a ragged row count
PARTIAL_SHAPES = [(32, 200, 3072, None), (32, 200, 1536, None),
                  (3, 200, 1536, 197)]


@pytest.mark.parametrize("shape", PARTIAL_SHAPES)
def test_ln_mlp_partial_kernels_match_twins(dev, shape):
    """K2's `residual=False` forward and backward against their twins and
    against the residual kernels (out + x, dx + do: the same bits), counted
    as fused_ln_mlp_partial{,_bwd}; under autograd both run."""
    batch, spq, m, rows = shape
    _, _, mlp = _args(dev, batch, spq, 197, 768, 12, 64, m)
    x, rest = mlp[0], mlp[1:]
    if rows is not None:
        x = x[:, :rows].contiguous()
    do = torch.randn(x.shape, device=dev).to(torch.bfloat16)
    ck.reset_launch_counts()
    with torch.no_grad():
        out = ck.fused_ln_mlp(x, *rest, residual=False)
        grads = ck.fused_ln_mlp_bwd(x, *rest[:5], do, EPS, residual=False)
        torch.cuda.synchronize()
        _assert_close(out, ck.fused_ln_mlp_partial_ref(x, *rest))
        refs = ck.fused_ln_mlp_partial_bwd_ref(x, *rest[:5], do, EPS)
        for g, r in zip(grads, refs):
            _assert_close(g, r)
        full = ck.fused_ln_mlp(x, *rest)
        assert torch.equal(x + out, full)
        full_grads = ck.fused_ln_mlp_bwd(x, *rest[:5], do, EPS)
        assert torch.equal(do + grads[0], full_grads[0])
        for g, f in zip(grads[1:], full_grads[1:]):
            assert torch.equal(g, f)
    leaves = [t.clone().requires_grad_() for t in (x, *rest[:6])]
    ck.fused_ln_mlp(*leaves, EPS, residual=False).backward(do)
    torch.cuda.synchronize()
    assert {k: v for k, v in ck.launch_counts().items() if v} == {
        "fused_ln_mlp_partial": 2, "fused_ln_mlp_partial_bwd": 2,
        "fused_ln_mlp": 1, "fused_ln_mlp_bwd": 1}


# The residual=False branches of K4, K11-A/B and K12 (the int8, int4 and
# save-acts MLP halves per model shard) and of K2's wide backward, at
# ViT-B/16's b32 spq 200 (M 3072 and the TP shard's 1536) and h14's D 1280
# on a shard's M 2560: each output against the twin's (‖k − t‖/‖t‖ within
# 5e-3 for int8, 2e-2 for int4, as chip_smoke.py's INT8_REL and INT4_REL;
# the bf16 outputs within the TOL band), and against the residual kernel
# on the same inputs: its output bf16(x + partial) and its dx
# bf16(do + dx_partial) to the bit, every other output the same bits.
PARTIAL_TIER_SHAPES = [(32, 200, 768, 3072), (32, 200, 768, 1536),
                       (8, 264, 1280, 2560)]
PARTIAL_TIERS = {"fused_ln_mlp_int8": 5e-3, "fused_ln_mlp_int4": 2e-2,
                 "fused_ln_mlp_save": None, "fused_ln_mlp_int8_save": 5e-3,
                 "fused_ln_mlp_int8_bwd": 5e-3,
                 "fused_ln_mlp_int8_dw_bwd": 5e-3,
                 "fused_ln_mlp_int4_bwd": 2e-2,
                 "fused_ln_mlp_int4_dw_bwd": 2e-2,
                 "fused_ln_mlp_bwd_fast": None,
                 "fused_ln_mlp_int8_save_bwd": 5e-3,
                 "fused_ln_mlp_int8_save_dw_bwd": 5e-3,
                 "fused_ln_mlp_bwd_wide": None}
# the counters of the backwards' residual=False launches (the forwards',
# the fast and the wide backward's: the name + "_partial")
PARTIAL_COUNTERS = {
    "fused_ln_mlp_int8_bwd": "fused_ln_mlp_int8_partial_bwd",
    "fused_ln_mlp_int8_dw_bwd": "fused_ln_mlp_int8_partial_dw_bwd",
    "fused_ln_mlp_int4_bwd": "fused_ln_mlp_int4_partial_bwd",
    "fused_ln_mlp_int4_dw_bwd": "fused_ln_mlp_int4_partial_dw_bwd",
    "fused_ln_mlp_int8_save_bwd": "fused_ln_mlp_int8_save_partial_bwd",
    "fused_ln_mlp_int8_save_dw_bwd": "fused_ln_mlp_int8_save_partial_dw_bwd"}


def _backward(name):
    return name.endswith(("_bwd", "_fast", "_wide"))


def _partial_args(dev, name, batch, spq, d, m):
    """The wrapper's arguments (x, do bf16 [batch, spq, d]; fp32 vectors)."""
    g = torch.Generator(device="cpu").manual_seed(17)

    def n(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g) * scale).to(dev, dtype)
    x, do = n(batch, spq, d), n(batch, spq, d)
    gamma = 1 + n(d, scale=0.1, dtype=torch.float32)
    beta, b2 = (n(d, scale=0.1, dtype=torch.float32) for _ in range(2))
    w1, w2 = n(d, m, scale=d ** -0.5), n(m, d, scale=m ** -0.5)
    b1 = n(m, scale=0.1, dtype=torch.float32)
    mlp = (x, gamma, beta, w1, b1, w2)
    if not _backward(name):
        return mlp + (b2, EPS)
    if name.endswith("fast"):
        _, h1, gp = ck.fused_ln_mlp_save(*mlp, b2, EPS)
        return (x, gamma, beta, w1, w2, h1, gp, do, EPS)
    if "save" in name:
        _, *codes = ck.fused_ln_mlp_int8_save(*mlp, b2, EPS)
        return (x, gamma, beta, w1, w2, *codes, do, EPS)
    return mlp + (do, EPS)


@pytest.mark.parametrize("shape", PARTIAL_TIER_SHAPES)
@pytest.mark.parametrize("name", sorted(PARTIAL_TIERS))
def test_partial_tier_kernels_match_twins_and_residual_kernels(dev, name,
                                                               shape):
    batch, spq, d, m = shape
    if (d > 1024) != name.endswith("wide"):
        pytest.skip("the wide backward runs at d > 1024 only, the others "
                    "at d <= 1024")
    args = _partial_args(dev, name, batch, spq, d, m)
    fn = getattr(ck, name)
    twin = getattr(ck, name + "_ref")
    band = PARTIAL_TIERS[name]
    ck.reset_launch_counts()
    with torch.no_grad():
        part = fn(*args, residual=False)
        full = fn(*args)
        ref = twin(*args, residual=False)
        torch.cuda.synchronize()
    part, full, ref = (o if isinstance(o, tuple) else (o,)
                       for o in (part, full, ref))
    for k, t in zip(part, ref):
        if band is None:
            _assert_close(k, t)
        else:
            k, t = k.double(), t.double()
            assert float((k - t).norm() / t.norm().clamp_min(1e-30)) <= band
    residual = args[-2] if _backward(name) else args[0]
    assert torch.equal(full[0], residual + part[0])
    for a, b in zip(full[1:], part[1:]):
        assert torch.equal(a, b)
    counts = {k: v for k, v in ck.launch_counts().items() if v}
    assert counts[PARTIAL_COUNTERS.get(name, name + "_partial")] == 1, counts
