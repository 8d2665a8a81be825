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
from vitax_torch.ops import gates  # noqa: E402

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


# gemm_sm90.cuh, the wgmma GEMM of K1's and K2's forwards and backwards,
# alone: each layout and epilogue at ViT-B/16's widths against fp32 products
# of the same bf16 inputs, on 1, 216, 3328 (b32 at keep 0.5) and 6400 (b32)
# rows, K ragged for kTN (the rows), and a 96-wide case whose N and K are no
# whole tile; two runs give the same bits. The forwards' epilogues at fc1's
# (768 -> 3072) and fc2's (3072 -> 768) widths. (kind, k, n)
GEMM_CASES = [("nn_bias", 768, 2304), ("nt_store", 768, 768),
              ("nt_f32", 2304, 768), ("tn_f32", 768, 2304),
              ("gelu_pair", 768, 3072), ("nn_bias_gelu", 768, 3072),
              ("nn_bias_gelu_save", 768, 3072),
              ("nn_bias_residual", 3072, 768), ("nn_bias", 96, 96),
              ("nt_f32", 96, 96), ("tn_f32", 96, 96), ("gelu_pair", 96, 96),
              ("nn_bias_gelu", 96, 96), ("nn_bias_gelu_save", 96, 96),
              ("nn_bias_residual", 96, 96)]


def _gemm_inputs(dev, kind, rows, k, n, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    if kind == "tn_f32":  # a [rows, k] as A[K, M], b [rows, n] as B[K, N]
        return dict(a=r(rows, k), b=r(rows, n))
    b = r(n, k, scale=k ** -0.5) if kind.startswith("nt") else \
        r(k, n, scale=k ** -0.5)
    out = dict(a=r(rows, k), b=b)
    if kind.startswith("nn_bias") or kind == "gelu_pair":
        out["bias"] = 0.1 * torch.randn(n, generator=g, device=dev)
    if kind == "gelu_pair":
        out.update(a2=r(rows, k), b2=r(n, k, scale=k ** -0.5))
    if kind == "nn_bias_residual":
        out["residual"] = r(rows, n)
    return out


@pytest.mark.parametrize("rows", [1, 216, 3328, 6400])
@pytest.mark.parametrize("case", GEMM_CASES)
def test_gemm_sm90_matches_fp32_products(dev, case, rows):
    kind, k, n = case
    inputs = _gemm_inputs(dev, kind, rows, k, n)
    with torch.no_grad():
        outs = ck.gemm_sm90(kind, **inputs)
        again = ck.gemm_sm90(kind, **inputs)
        torch.cuda.synchronize()
        refs = ck.gemm_sm90_ref(kind, **inputs)
    if kind not in ("gelu_pair", "nn_bias_gelu_save"):
        outs, again, refs = (outs,), (again,), (refs,)
    for out, out2, ref in zip(outs, again, refs):
        # fp32 outputs: the same products summed in another order
        _assert_close(out, ref, 2e-2 if ref.dtype == torch.bfloat16 else 1e-3)
        assert torch.equal(out, out2), kind


# K1's forward on its Hopper design (gemm_sm90.cuh's qkv and out-projection,
# K13's core on the packed qkv rows): the serving b64 spq 200, b8 at spq 584
# (@384) and one image; two launches give the same bits.
# (batch, spq, seq_len, D, heads, head_dim)
K1_FWD_SHAPES = [(64, 200, 197, 768, 12, 64), (8, 584, 577, 768, 12, 64),
                 (1, 200, 197, 768, 12, 64)]


@pytest.mark.parametrize("shape", K1_FWD_SHAPES)
def test_k1_forward_matches_twin_and_keeps_its_bits(dev, shape):
    b, spq, seq, d, h, hd = shape
    _, qkvo, _ = _args(dev, b, spq, seq, d, h, hd, 4 * d)
    ck.reset_launch_counts()
    with torch.inference_mode():
        out = ck.fused_ln_qkvo_attention(*qkvo)
        again = ck.fused_ln_qkvo_attention(*qkvo)
        torch.cuda.synchronize()
        _assert_close(out, ck.fused_ln_qkvo_attention_ref(*qkvo))
    assert torch.equal(out, again)
    assert {k: v for k, v in ck.launch_counts().items() if v} == {
        "fused_ln_qkvo_attention": 2}


# K2's forward on gemm_sm90.cuh (fc1 with bias + GELU, fc2 with bias +
# residual, or bias alone for the partial) at the serving b64, on the ragged
# 3 x 197 rows and at ViT-H/14's D 1280, M 5120: both branches against their
# twins, x + partial the full output to the bit, two launches the same bits.
# (batch, spq, rows, D, M)
K2_FWD_SHAPES = [(64, 200, None, 768, 3072), (3, 200, 197, 768, 3072),
                 (8, 264, None, 1280, 5120)]


@pytest.mark.parametrize("shape", K2_FWD_SHAPES)
def test_k2_forward_and_partial_match_twins(dev, shape):
    b, spq, rows, d, m = shape
    _, _, mlp = _args(dev, b, spq, spq - 3, d, d // 64, 64, m)
    x, rest = mlp[0], mlp[1:]
    if rows is not None:
        x = x[:, :rows].contiguous()
    ck.reset_launch_counts()
    with torch.inference_mode():
        full = ck.fused_ln_mlp(x, *rest)
        again = ck.fused_ln_mlp(x, *rest)
        part = ck.fused_ln_mlp(x, *rest, residual=False)
        torch.cuda.synchronize()
        _assert_close(full, ck.fused_ln_mlp_ref(x, *rest))
        _assert_close(part, ck.fused_ln_mlp_partial_ref(x, *rest))
    assert torch.equal(full, again)
    assert torch.equal(x + part, full)
    assert {k: v for k, v in ck.launch_counts().items() if v} == {
        "fused_ln_mlp": 2, "fused_ln_mlp_partial": 1}


# K1's backward (K13's core on the packed qkv rows, gemm_sm90.cuh) across
# its geometries: spq 200, 104, 584 and 72 (seq_len 197, 101, 577 and 65:
# keys masked inside the last 64-row tile, pad query rows past it), garbage
# pad rows of x and a nonzero do everywhere, head dims 32, 64 and 128, one
# image and 32. (batch, spq, seq_len, D, heads, head_dim)
K1_BWD_SHAPES = [(32, 200, 197, 768, 12, 64), (1, 104, 101, 768, 12, 64),
                 (2, 584, 577, 768, 12, 64), (32, 72, 65, 256, 8, 32),
                 (1, 72, 65, 256, 2, 128), (3, 200, 197, 512, 4, 128),
                 (1, 200, 197, 256, 8, 32)]


@pytest.mark.parametrize("shape", K1_BWD_SHAPES)
def test_k1_backward_matches_twin_across_geometries(dev, shape):
    b, spq, seq, d, h, hd = shape
    args = _bwd_args(dev, b, spq, seq, d, h, hd, 4 * d)[
        "fused_ln_qkvo_attention_bwd"]
    ck.reset_launch_counts()
    with torch.no_grad():
        outs = ck.fused_ln_qkvo_attention_bwd(*args)
        torch.cuda.synchronize()
        refs = ck.fused_ln_qkvo_attention_bwd_ref(*args)
    for out, ref in zip(outs, refs):
        _assert_close(out, ref)
    assert {k: v for k, v in ck.launch_counts().items() if v} == {
        "fused_ln_qkvo_attention_bwd": 1}


# K2's backward (the dual product keeping a1 in registers) at ViT-B/16's,
# ViT-L/16's and ViT-H/14's widths (the last the :1610 route), with and
# without the residual, on 3 x 197 rows
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("d,m", [(768, 3072), (1024, 4096), (1280, 5120)])
def test_k2_backward_matches_twin_at_model_widths(dev, d, m, residual):
    _, _, mlp = _args(dev, 3, 197, 197, d, 8, 64, m, seed=3)
    g = torch.Generator(device=dev).manual_seed(303)
    do = torch.randn(mlp[0].shape, generator=g, device=dev).to(torch.bfloat16)
    args = (*mlp[:6], do, EPS)
    ck.reset_launch_counts()
    with torch.no_grad():
        outs = ck.fused_ln_mlp_bwd(*args, residual=residual)
        torch.cuda.synchronize()
        refs = ck.fused_ln_mlp_bwd_ref(*args, residual=residual)
    for out, ref in zip(outs, refs):
        _assert_close(out, ref)
    name = {(False, True): "fused_ln_mlp_bwd",
            (False, False): "fused_ln_mlp_partial_bwd",
            (True, True): "fused_ln_mlp_bwd_wide",
            (True, False): "fused_ln_mlp_bwd_wide_partial"}[
        (d > ck.MLP_MONO_MAX_D, residual)]
    assert {k: v for k, v in ck.launch_counts().items() if v} == {name: 1}


def _peak_bytes(fn):
    """Device memory a call allocates at its peak, above what was live."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base, out


def test_k1_and_k2_backwards_keep_p_ds_and_a1_out_of_device_memory(dev):
    """At b32 spq 200 the K1 backward allocates no bf16 P and ds (2·b·H·
    208² bf16, 66 MB) and K2's no fp32 a1 ([n, M], 79 MB): each call's
    peak stays under its outputs and remaining scratch plus a third of what
    those would add."""
    b, spq, d, h, hd, m = 32, 200, 768, 12, 64, 3072
    n, w, hhd = b * spq, 3 * h * hd, h * hd
    args = _bwd_args(dev, b, spq, 197, d, h, hd, m)
    k1, _ = _peak_bytes(lambda: ck.fused_ln_qkvo_attention_bwd(
        *args["fused_ln_qkvo_attention_bwd"]))
    lib = ck.build.load()
    k1_rest = (2 * n * d + 4 * (2 * d + d * w + w + hhd * d + d)  # outputs
               + 2 * (n * d + 2 * n * w + 2 * n * hhd) + 4 * n * d  # scratch
               + 4 * lib.vitax_ln_qkvo_attention_bwd_ws(n, d, hhd, w)
               + 4 * lib.vitax_attention_core_bwd_ws(b, spq, h))
    rows = (spq + 15) // 16 * 16
    assert k1 <= k1_rest + 2 * 2 * b * h * rows * rows / 3, (k1, k1_rest)
    k2, _ = _peak_bytes(lambda: ck.fused_ln_mlp_bwd(*args["fused_ln_mlp_bwd"]))
    k2_rest = (2 * n * d + 4 * (2 * d + 2 * d * m + m + d)
               + 2 * (n * d + 2 * n * m) + 4 * n * d
               + 4 * lib.vitax_ln_mlp_bwd_ws(n, d, m))
    assert k2 <= k2_rest + 4 * n * m / 3, (k2, k2_rest)


def test_k6_backward_keeps_p_ds_out_of_device_memory(dev):
    """At ViT-H/14's b32 spq 264 the K6 backward allocates no bf16 P and ds
    (2·b·H·272² bf16, 151 MB): the call's peak stays under its outputs and
    remaining scratch plus a third of what those would add."""
    b, spq, d, h, hd = 32, 264, 1280, 16, 80
    n, w, hhd = b * spq, 3 * h * hd, h * hd
    _, bwd = _flash_args(dev, b, spq, 257, d, h, hd)
    peak, _ = _peak_bytes(lambda: ck.fused_ln_qkvo_attention_flash_bwd(*bwd))
    lib = ck.build.load()
    rest = (2 * n * d + 4 * (2 * d + d * w + w + hhd * d + d)  # outputs
            + 2 * (n * d + 2 * n * w + 2 * n * hhd) + 4 * n * d  # scratch
            + 4 * lib.vitax_ln_qkvo_attention_bwd_ws(n, d, hhd, w)
            + 4 * lib.vitax_attention_core_bwd_ws(b, spq, h))
    rows = (spq + 15) // 16 * 16
    assert peak <= rest + 2 * 2 * b * h * rows * rows / 3, (peak, rest)


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



# the LN pair: the register path (ViT-B/L/H widths) and the loop form (2048,
# 8192); rows fewer than a block's warps (1, 7), ragged (591 = 3 x 197) and
# more than the grid's resident warps walk at once (6400, 12800)
LN_ROWS = (1, 7, 591, 6400, 12800)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [768, 1024, 1280, 2048, 8192])
def test_layer_norm_pair_at_widths_and_row_counts(dev, d, dtype):
    dt = getattr(torch, dtype)
    tol_fwd, tol_bwd = (2e-2, 2e-2) if dt == torch.bfloat16 else (1e-5, 1e-4)
    g = torch.Generator(device=dev).manual_seed(d)
    gamma = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
    beta = 0.1 * torch.randn(d, generator=g, device=dev)
    for n in LN_ROWS:
        x = (torch.randn(n, d, generator=g, device=dev) * 1.5 + 0.3).to(dt)
        dy = torch.randn(n, d, generator=g, device=dev).to(dt)
        with torch.no_grad():
            y = ck.layer_norm(x, gamma, beta, EPS)
            _assert_close(y, ck.layer_norm_ref(x, gamma, beta, EPS), tol_fwd)
            assert torch.equal(y, ck.layer_norm(x, gamma, beta, EPS)), n
            outs = ck.layer_norm_bwd(x, gamma, dy, EPS)
            for out, ref in zip(outs, ck.layer_norm_bwd_ref(x, gamma, dy,
                                                            EPS)):
                _assert_close(out, ref, tol_bwd)
            # dx, dγ and dβ: the same bits in a second run
            for a, b in zip(outs, ck.layer_norm_bwd(x, gamma, dy, EPS)):
                assert torch.equal(a, b), n


@pytest.mark.parametrize("residual", [True, False])
def test_ln_tails_of_k2_backward_across_row_counts(dev, residual):
    """The LN backward's fused form (fp32 dy from the dx product; with
    residual, K2's R added in bf16) at every LN_ROWS count, twice."""
    for rows in LN_ROWS:
        _, _, mlp = _args(dev, 1, rows, rows, 768, 12, 64, 3072, seed=rows)
        g = torch.Generator(device=dev).manual_seed(rows + 1)
        do = torch.randn((1, rows, 768), generator=g,
                         device=dev).to(torch.bfloat16)
        args = (*mlp[:6], do, EPS, residual)
        with torch.no_grad():
            outs = ck.fused_ln_mlp_bwd(*args)
            torch.cuda.synchronize()
            for out, ref in zip(outs, ck.fused_ln_mlp_bwd_ref(*args)):
                _assert_close(out, ref)
            for a, b in zip(outs, ck.fused_ln_mlp_bwd(*args)):
                assert torch.equal(a, b), rows


@pytest.mark.parametrize("batch", [1, 32, 64])
def test_ln_tail_of_k1_backward_across_batches(dev, batch):
    """K1's LN tail (fp32 dy, no R) on 200, 6400 and 12800 rows, twice."""
    args = _bwd_args(dev, batch, 200, 197, 768, 12, 64, 3072,
                     seed=batch)["fused_ln_qkvo_attention_bwd"]
    with torch.no_grad():
        outs = ck.fused_ln_qkvo_attention_bwd(*args)
        torch.cuda.synchronize()
        for out, ref in zip(outs, ck.fused_ln_qkvo_attention_bwd_ref(*args)):
            _assert_close(out, ref)
        for a, b in zip(outs, ck.fused_ln_qkvo_attention_bwd(*args)):
            assert torch.equal(a, b)

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


def _int8_args(dev, batch, spq, seq, rows, seed=0, d=768, h=12, hd=64):
    _, qkvo, mlp = _args(dev, batch, spq, seq, d, h, hd, 4 * d, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    do = torch.randn((batch, spq, d), generator=g, device=dev).to(
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


# (batch, spq, seq_len): the drop phase's b32 spq 104, b8 spq 200, a ragged
# batch, and b16@416's spq 680 (seq 677, past the whole-row core)
HO_SHAPES = [(32, 104, 99), (8, 200, 197), (3, 104, 99), (2, 680, 677)]


@pytest.mark.parametrize("shape", HO_SHAPES)
@pytest.mark.parametrize("pack", [True, False])
def test_handoff_kernels_match_plain_twins(dev, shape, pack):
    """K5's two kernels on their Hopper design (gemm_sm90.cuh's s8 path and
    K13's core, no gemm.cuh product and no whole-row core): the attention
    half packing its own input (the first block) or taking the twin's pack,
    then the MLP half on the twin's attention outputs; r1 within the
    tolerance and INT8_REL of the twin, qkv the twin's bits from the
    kernel's own codes; the MLP half's r2 and h1q the twin's bits from the
    same packed input; the packed codes within their band, every scratch
    code as K3's/K4's."""
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
        xq, sx = sk["xq"]
        w8, sw = sk["w8"]
        qkv_t = ck._dequant(ck.int_mm(xq, w8), sx.reshape(-1, 1), sw,
                            attn[8]).to(torch.bfloat16)
    _assert_close(r1, r1_t)
    x = attn[0].double()
    rel = ((r1.double() - r1_t.double()).norm()
           / (r1_t.double() - x).norm()).item()
    assert rel <= INT8_REL, rel
    assert torch.equal(sk["qkv"], qkv_t)
    _codes_within_band("fused_ln_qkvo_attention_int8_ho",
                       {k: v for k, v in sk.items() if k != "qkv"}, st)
    # the MLP half on the same input: the twin's packed r1
    mlp = (r1_t, xq2_t, sx2_t, attn[5], attn[6], w1, b1, w2, b2, EPS)
    sk, st = {}, {}
    with torch.no_grad():
        r2, _, _ = ck.fused_ln_mlp_int8_ho(*mlp, scratch=sk)
        torch.cuda.synchronize()
        r2_t, _, _ = ck.fused_ln_mlp_int8_ho_ref(*mlp, scratch=st)
    assert torch.equal(r2, r2_t)
    assert all(map(torch.equal, sk["h1q"], st["h1q"]))
    _codes_within_band("fused_ln_mlp_int8_ho", sk, st)
    assert {k: v for k, v in ck.launch_counts().items() if v} == \
        dict.fromkeys(HO_NAMES, 1)
    assert ck.s8_launch_counts() == {
        "gemm_sm90_s8:s8_bf16": 1, "gemm_sm90_s8:s8_f32": 0,
        "gemm_sm90_s8:s8_gelu_pair": 0, "gemm_sm90_s8:s8_group": 0,
        "gemm_sm90_s8:s8_gelu_q_f32": 1, "gemm_sm90_s8:s8_residual": 0,
        "gemm_sm90_s8:s8_residual_f32": 2,
        "gemm_sm90_s8:s8_group_rc": 0}
    assert ck.first_design_launch_counts() == dict.fromkeys(
        ck.FIRST_DESIGN_PIECES, 0)


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
# 197, cpq 128) and 0.5 (99, cpq 104), a ragged small case, and
# ft_resvit_fast.sh's drop geometry (keep 0.5: 99 of spq 104, C 0.625: 62,
# cpq 64) at its b192
RECT_SHAPES = [(64, 200, 197, 124), (64, 200, 197, 99), (3, 200, 197, 37),
               (192, 104, 99, 62)]


@pytest.mark.parametrize("shape", RECT_SHAPES)
@pytest.mark.parametrize("int8", [False, True])
def test_rect_kernel_matches_twin_and_square_gather(dev, shape, int8):
    """K8 against its twin, and against the square kernel (K1, K3) on all
    rows followed by the row gather, to the bit on the kept rows in both
    tiers: each runs its square kernel's launches, each per row, on the two
    row sets (vitax's contract, pallas_kernels.py:3944-3946, :4418-4419)."""
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


# The bf16 K8 on its Hopper design (K1's launches on the two row sets,
# K13's core in the rect geometry) at the shapes that the K1 family's gate
# takes and the whole-row core did not (ops/gates.py): b16@416 (spq 680,
# seq 677, 400 kept rows) and head dim 80 (D 640, 8 heads).
# (batch, spq, seq_len, cap, D, heads, head_dim)
RECT_K13_SHAPES = [(4, 680, 677, 400, 768, 12, 64),
                   (4, 200, 197, 124, 640, 8, 80)]


def _rect_bf16_args(dev, batch, spq, seq, cap, d, h, hd, seed=3):
    """K8's forward and backward arguments at width d, h heads of hd: xc
    the first `cap` rows of a random choice of each image's first seq rows,
    zero-padded to round_up(cap, 8), do zero on those pad rows."""
    _, qkvo, _ = _args(dev, batch, spq, seq, d, h, hd, 4 * d, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    idx = torch.stack([torch.randperm(seq, generator=g, device=dev)[:cap]
                       for _ in range(batch)])
    x = qkvo[0]
    xc = torch.zeros((batch, (cap + 7) // 8 * 8, d), dtype=x.dtype,
                     device=dev)
    xc[:, :cap] = torch.gather(x, 1, idx[..., None].expand(-1, -1, d))
    do = torch.randn(xc.shape, generator=g, device=dev).to(torch.bfloat16)
    do[:, cap:] = 0
    return (xc, *qkvo), (xc, *qkvo[:6], do, *qkvo[7:])


@pytest.mark.parametrize("shape", RECT_K13_SHAPES)
def test_rect_bf16_runs_k13_shapes_the_whole_row_core_cannot(dev, shape):
    """The bf16 K8, forward and backward, where the whole-row core cannot
    take the shapes: within the kernel band of the twins on every output,
    two launches the same bits, and no first-design piece launched."""
    b, spq, seq, cap, d, h, hd = shape
    fwd, bwd = _rect_bf16_args(dev, b, spq, seq, cap, d, h, hd)
    assert not ck._core_fits(fwd[1], fwd[4], h, backward=True)
    assert ck.qkv_attention_rect_supported(fwd[0], fwd[1], fwd[4], h)
    ck.reset_launch_counts()
    for name, args in (("fused_ln_qkvo_attention_rect", fwd),
                       ("fused_ln_qkvo_attention_rect_bwd", bwd)):
        with torch.no_grad():
            outs = getattr(ck, name)(*args)
            again = getattr(ck, name)(*args)
            torch.cuda.synchronize()
            refs = getattr(ck, name + "_ref")(*args)
        if name == "fused_ln_qkvo_attention_rect":
            outs, again, refs = (outs,), (again,), (refs,)
        for i, (out, out2, ref) in enumerate(zip(outs, again, refs)):
            _assert_close(out, ref)
            assert torch.equal(out, out2), (name, i)
        del outs, again, refs
    assert {k: v for k, v in ck.launch_counts().items() if v} == {
        "fused_ln_qkvo_attention_rect": 2,
        "fused_ln_qkvo_attention_rect_bwd": 2}
    assert ck.first_design_launch_counts() == dict.fromkeys(
        ck.FIRST_DESIGN_PIECES, 0)


def test_rect_bf16_backward_writes_zero_grads_on_masked_keys(dev):
    """The key pass in the rect geometry writes dk and dv as 0 on the key
    rows seq_len..spq (vitax's p is exactly 0 there): dxn is 0 on those rows
    of x, so is dx, exactly."""
    args, _ = _rect_bwd_args(dev, 4, 200, 150, 37)
    with torch.no_grad():
        dx = ck.fused_ln_qkvo_attention_rect_bwd(*args)[1]
    assert torch.isfinite(dx.float()).all()
    assert dx[:, 150:].abs().max().item() == 0
    assert dx[:, :150].abs().max().item() > 0


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


# K6's online core alone (ck.flash_online_core, its forward and its
# backward row pass): (batch, spq, seq_len, head_dim), heads filling
# ViT-H/14's 1280 columns: spq 736 and 264 and a ragged 40, a whole key
# tile past seq_len (spq 136, seq 100), at head_dim 64, 80 and 128
ONLINE_SHAPES = [(2, 736, 730, 64), (2, 736, 730, 80), (2, 264, 257, 80),
                 (2, 264, 257, 128), (3, 40, 37, 80), (3, 40, 37, 128),
                 (2, 136, 100, 64)]


@pytest.mark.parametrize("shape", ONLINE_SHAPES)
def test_online_core_matches_plain_version(dev, shape):
    """The head outputs and dd within the bf16 band of the plain version
    (the same 64-key tiles and rounding points), m·scale·log2e within
    1e-4·max(1, |m|) and 1/l within 1e-4 relative (ex2.approx, the order
    of the row sums); the row pass's out is the forward's, bit for bit, and
    its statistics past spq are 0."""
    b, spq, seq, hd = shape
    heads = 1280 // hd
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    qkv = torch.randn((b, spq, 3 * heads * hd), generator=g,
                      device=dev).to(torch.bfloat16)
    dattn = torch.randn((b, spq, heads * hd), generator=g,
                        device=dev).to(torch.bfloat16)
    args = (qkv, seq, heads, hd)
    with torch.no_grad():
        out = ck.flash_online_core(*args)
        out2, st = ck.flash_online_core(*args, dattn=dattn)
        torch.cuda.synchronize()
        ref = ck.flash_online_rows_ref(*args)
        _, st_ref = ck.flash_online_rows_ref(*args, dattn=dattn)
    _assert_close(out, ref)
    assert torch.equal(out, out2)
    assert st.shape == st_ref.shape == (b, heads, 3, (spq + 63) // 64 * 64)
    _assert_close(st[:, :, 2], st_ref[:, :, 2])
    m, m_ref = st[:, :, 0], st_ref[:, :, 0]
    assert ((m - m_ref).abs() <= 1e-4 * m_ref.abs().clamp_min(1.0)).all()
    il, il_ref = st[:, :, 1], st_ref[:, :, 1]
    assert ((il - il_ref).abs() <= 1e-4 * il_ref.abs()).all()
    assert not st[..., spq:].any()


def test_flash_gates_take_h14_and_k1_does_not(dev):
    for spq in (736, 264):
        x = torch.empty((2, spq, 1280), dtype=torch.bfloat16, device=dev)
        w = torch.empty((1280, 3 * 1280), dtype=torch.bfloat16, device=dev)
        # the K1 family's own gate takes them (K13's core); vitax's does
        # not (d > 1024), so the model picks K6 (ops/gates.py)
        assert not (gates.qkv_attention_supported(x, w)
                    and ck.qkv_attention_supported(x, w, 16))
        assert ck.qkv_attention_flash_supported(x, w, 16)
        assert ck.qkv_attention_flash_bwd_supported(x, w, 16)
        assert not ck.qkv_attention_flash_supported(x.float(), w, 16)
    for hd in ck.FLASH_HEAD_DIMS:  # every instance of the online core fits
        assert ck.online_core_smem_bytes(hd, backward=True) <= ck.SMEM_LIMIT


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
# 24 and the other multiples of 16, and ragged seqs: 65 and 577 leave one
# key in the last 64-key tile (and 65 one query tile of one row)
K13_SHAPES = [(32, 12, 197, 64, "bshd"), (32, 12, 197, 64, "bhsd"),
              (8, 12, 577, 64, "bshd"), (4, 16, 730, 80, "bshd"),
              (1, 2, 1024, 128, "bhsd"), (3, 4, 77, 40, "bshd"),
              (3, 4, 77, 48, "bhsd"), (2, 3, 21, 24, "bshd"),
              (2, 3, 33, 16, "bhsd"), (2, 3, 50, 96, "bshd"),
              (2, 3, 50, 112, "bhsd"), (2, 5, 21, 8, "bshd"),
              (3, 4, 65, 64, "bshd"), (3, 4, 65, 32, "bhsd")]


def _k13_args(dev, b, h, s, hd, layout, seed=0):
    """q, k, v, do as [B, H, S, Hd] views of bf16 memory in `layout`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (b, s, h, hd) if layout == "bshd" else (b, h, s, hd)
    ts = [torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
          for _ in range(4)]
    return [t.transpose(1, 2) if layout == "bshd" else t for t in ts]


@pytest.mark.parametrize("shape", K13_SHAPES)
def test_attention_core_kernels_match_twins(dev, shape):
    """K13 forward and backward against their twins: both normalise p in
    fp32 and round it to bf16 once, the kernel's row statistics by the
    online recurrence over 64-key tiles and its sums in another order
    (inside the bf16 band); the grads come back in q's layout; two backward
    launches give the same bits."""
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
    """Unpadded rows (seq 21: the 64-row query tile and 64-key tile run
    past the tensor's end): inputs that end right before NaN guard memory
    give finite outputs equal to the twin's, and the guard after each output
    and after the backward's row-statistics scratch is untouched. Run it
    under compute-sanitizer where that works: `compute-sanitizer python -m
    pytest --noconftest tests/test_torch_cuda_kernels.py -k
    ragged_tensors`."""
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
    lib = build.load()
    n_stats = lib.vitax_attention_core_bwd_ws(images, s, heads)
    stats = torch.full((n_stats + 4096,), 7.0, device=dev)
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
        bufs[3].data_ptr(), *(t.data_ptr() for t in outs[1:]),
        stats.data_ptr(), images, s, heads, hd, scale, stream)
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
    assert torch.all(stats[n_stats:] == 7.0)
    assert torch.isfinite(stats[:n_stats]).all()


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


# K7's int8 backward on its Hopper design (K3's sequence at the packed GQA
# width, K13's core in its GQA geometry), with int8_dw off and on: Res-ViT
# training's b32 spq 200 with 4 kv heads and the shapes that the K1
# family's gate takes and the whole-row core did not, b16@416 (spq 680,
# seq 677) and head dim 80 (D 640, 8 heads), with 4 kv heads; every output
# within the bf16 tolerance and INT8_REL of the twin, the codes within their
# bands, two launches the same bits, its s8 products counted and no
# first-design piece launched. (batch, spq, seq_len, D, heads, kv_heads,
# head_dim)
K7_INT8_BWD_SHAPES = [(32, 200, 197, 768, 12, 4, 64),
                      (4, 680, 677, 768, 12, 4, 64),
                      (4, 200, 197, 640, 8, 4, 80)]


@pytest.mark.parametrize("int8_dw", [False, True])
@pytest.mark.parametrize("shape", K7_INT8_BWD_SHAPES)
def test_k7_int8_backward_on_hopper_matches_twins_and_keeps_its_bits(
        dev, shape, int8_dw):
    args = _gqa_bwd_args(dev, *shape)
    h, hkv = shape[4], shape[5]
    if shape[1] == 680 or shape[6] == 80:
        assert not ck._core_fits(args[0], args[3], h, hkv, backward=True)
    assert ck.qkv_attention_supported(args[0], args[3], h, hkv)
    name = ("fused_ln_qkvo_attention_int8_gqa_dw_bwd" if int8_dw
            else "fused_ln_qkvo_attention_int8_gqa_bwd")
    ck.reset_launch_counts()
    sk, st = {}, {}
    with torch.no_grad():
        outs = getattr(ck, name)(*args, scratch=sk)
        again = getattr(ck, name)(*args)
        torch.cuda.synchronize()
        refs = getattr(ck, name + "_ref")(*args, scratch=st)
    for i, (out, out2, ref) in enumerate(zip(outs, again, refs)):
        _assert_close(out, ref)
        assert torch.equal(out, out2), (name, i)
        rel = ((out.double() - ref.double()).norm()
               / ref.double().norm().clamp_min(1e-30)).item()
        assert rel <= INT8_REL, (name, i, rel)
    _codes_within_band(name, sk, st)
    assert {k: v for k, v in ck.launch_counts().items() if v} == {name: 2}
    assert ck.s8_launch_counts() == {
        "gemm_sm90_s8:s8_bf16": 4, "gemm_sm90_s8:s8_f32": 2,
        "gemm_sm90_s8:s8_gelu_pair": 0,
        "gemm_sm90_s8:s8_group": 4 if int8_dw else 0,
        "gemm_sm90_s8:s8_gelu_q_f32": 0, "gemm_sm90_s8:s8_residual": 0,
        "gemm_sm90_s8:s8_residual_f32": 0,
        "gemm_sm90_s8:s8_group_rc": 0}
    assert ck.first_design_launch_counts() == dict.fromkeys(
        ck.FIRST_DESIGN_PIECES, 0)


@pytest.mark.parametrize("int8_dw", [False, True])
def test_k7_int8_backward_writes_zero_grads_on_masked_keys(dev, int8_dw):
    """The key pass in the GQA geometry writes dk and dv as 0 on the key
    rows seq_len..spq (vitax's p is exactly 0 there) under a cotangent that
    is nonzero on those rows: their row codes in dqkv's k and v columns are
    0, while the pad query rows' dq is not."""
    b, spq, seq, d, h, hkv, hd = 4, 200, 150, 768, 12, 4, 64
    args = _gqa_bwd_args(dev, b, spq, seq, d, h, hkv, hd)
    assert args[6][:, seq:].abs().amax().item() > 0
    name = ("fused_ln_qkvo_attention_int8_gqa_dw_bwd" if int8_dw
            else "fused_ln_qkvo_attention_int8_gqa_bwd")
    sk = {}
    with torch.no_grad():
        dx = getattr(ck, name)(*args, scratch=sk)[0]
    assert torch.isfinite(dx.float()).all()
    codes = sk["dqq"][0].view(b, spq, -1)
    assert codes[:, seq:, h * hd:].abs().max().item() == 0
    assert codes[:, :seq, h * hd:].abs().max().item() > 0
    assert codes[:, seq:, :h * hd].abs().max().item() > 0


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


@pytest.mark.parametrize("shape", RECT_K13_SHAPES)
def test_rect_int4_backward_runs_k13_shapes_the_whole_row_core_cannot(
        dev, shape):
    """R-B and R-B dw, K8's int8 sequence at L = 7 on K13's core in its rect
    geometry, where the whole-row core cannot take the shapes (B/16 @416,
    head dim 80): each against its twin (the codes in their bands,
    INT4_REL, two launches the same bits), their s8 products counted, no
    first-design piece launched."""
    b, spq, seq, cap, d, h, hd = shape
    _, bwd = _rect_bf16_args(dev, b, spq, seq, cap, d, h, hd)
    assert not ck._core_fits(bwd[1], bwd[4], h, backward=True)
    assert ck.qkv_attention_rect_supported(bwd[0], bwd[1], bwd[4], h)
    ck.reset_launch_counts()
    for name in RECT_INT4[1:]:
        _hold_int4(name, bwd)
    assert {k: v for k, v in ck.launch_counts().items() if v} == \
        dict.fromkeys(RECT_INT4[1:], 2)
    # four launches: q, kv and dattn, dxnc and dxn; the two int8_dw ones
    # three two-scale folds
    assert ck.s8_launch_counts() == {
        "gemm_sm90_s8:s8_bf16": 3 * 4, "gemm_sm90_s8:s8_f32": 2 * 4,
        "gemm_sm90_s8:s8_gelu_pair": 0, "gemm_sm90_s8:s8_group": 0,
        "gemm_sm90_s8:s8_gelu_q_f32": 0, "gemm_sm90_s8:s8_residual": 0,
        "gemm_sm90_s8:s8_residual_f32": 0, "gemm_sm90_s8:s8_group_rc": 3 * 2}
    assert ck.first_design_launch_counts() == dict.fromkeys(
        ck.FIRST_DESIGN_PIECES, 0)


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


# The A4W4 attention half on K3's Hopper sequences at L = 7 (K11-C, K11-D
# with int8_dw off and on; G-F, G-B with 4 kv heads, K13's core in its GQA
# geometry) at the shapes that the K1 family's gate takes and the whole-row
# core does not: b16@416 (spq 680, seq 677) and head dim 80 (D 640, 8
# heads). Each against its twin (INT4_REL, the codes in their bands), two
# launches the same bits, its s8 products counted and no first-design piece
# launched. (batch, spq, seq_len, D, heads, kv_heads, head_dim)
INT4_K13_SHAPES = [(4, 680, 677, 768, 12, 12, 64),
                   (4, 680, 677, 768, 12, 4, 64),
                   (4, 200, 197, 640, 8, 4, 80)]
MHA_INT4 = ("fused_ln_qkvo_attention_int4", "fused_ln_qkvo_attention_int4_bwd",
            "fused_ln_qkvo_attention_int4_dw_bwd")


@pytest.mark.parametrize("shape", INT4_K13_SHAPES)
def test_int4_attention_runs_k13_shapes_the_whole_row_core_cannot(dev,
                                                                  shape):
    args = _gqa_bwd_args(dev, *shape)
    h, hkv = shape[4], shape[5]
    x, wqkv = args[0], args[3]
    assert not ck._core_fits(x, wqkv, h, hkv)
    assert ck.qkv_attention_supported(x, wqkv, h, hkv)
    names, kv = (GQA_INT4, (hkv,)) if hkv < h else (MHA_INT4, ())
    fwd = (*args[:6], torch.zeros(shape[3], device=dev), *args[7:-1])
    ck.reset_launch_counts()
    _hold_int4(names[0], fwd, kv)
    for name in names[1:]:
        _hold_int4(name, args[:-1], kv)
    assert {k: v for k, v in ck.launch_counts().items() if v} == \
        dict.fromkeys(names, 2)
    # two launches each: the forward's qkv and out, the backwards' qkv,
    # dattn and dxn, the int8_dw backward's two two-scale folds
    assert ck.s8_launch_counts() == {
        "gemm_sm90_s8:s8_bf16": 2 * 2 + 2 * 2 * 2, "gemm_sm90_s8:s8_f32": 4,
        "gemm_sm90_s8:s8_gelu_pair": 0, "gemm_sm90_s8:s8_group": 0,
        "gemm_sm90_s8:s8_gelu_q_f32": 0, "gemm_sm90_s8:s8_residual": 0,
        "gemm_sm90_s8:s8_residual_f32": 0, "gemm_sm90_s8:s8_group_rc": 4}
    assert ck.first_design_launch_counts() == dict.fromkeys(
        ck.FIRST_DESIGN_PIECES, 0)


def _fold_first_design(a, b, sa, sb, gp):
    """gemm.cuh's two-scale group fold (kS8GroupF32RC) on the same
    operands, launched alone (csrc/gemm_sm90_s8.cu)."""
    f = torch.empty((a.shape[0], b.shape[0]), dtype=torch.float32,
                    device=a.device)
    lib = ck.build.load()
    rc = lib.vitax_gemm_s8_groups_rc(
        a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(),
        f.data_ptr(), a.shape[0], b.shape[0], a.shape[1], gp,
        torch.cuda.current_stream().cuda_stream)
    ck.build.check(rc, "vitax_gemm_s8_groups_rc")
    return f


# (m, n, groups, group rows in gp): K11-D's b32 dWo and dWqkv (16 groups
# of 400 rows in 512), a ragged one
GROUP_RC_CASES = [(768, 768, 16, 512), (768, 2304, 16, 512), (100, 24, 3, 256)]


@pytest.mark.parametrize("case", GROUP_RC_CASES)
def test_s8_group_rc_is_the_first_design_fold_to_the_bit(dev, case):
    """kEpiS8GroupRC (gemm_sm90.cuh) against its twin and gemm.cuh's
    kS8GroupF32RC on the same packs (each group's rows zero-padded, 25/32
    of them codes): F += (f32(acc)·sa)·sb, groups in order, in both, so the
    same bits; two launches the same bits."""
    m, n, groups, gp = case
    inputs = ck.gemm_sm90_s8_inputs("s8_group_rc", m, n, groups * gp, gp,
                                    seed=11, device=dev)
    with torch.no_grad():
        out = ck.gemm_sm90_s8("s8_group_rc", **inputs)
        again = ck.gemm_sm90_s8("s8_group_rc", **inputs)
        first = _fold_first_design(inputs["a"], inputs["b"], inputs["sr"],
                                   inputs["sc"], gp)
        torch.cuda.synchronize()
        ref = ck.gemm_sm90_s8_ref("s8_group_rc", **inputs)
    assert torch.equal(out, again)
    assert torch.equal(out, ref)
    assert torch.equal(out, first)


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
# and training's b32, a ragged seq in a small spq, the head_dim 32 / 128
# instantiations of the core, and two shapes only K13's core takes (the
# first design refused them): B/16 @416 (seq 677 in spq 680) and head dim
# 80 (d 640 with 8 heads)
K10_SHAPES = [(64, 200, 197, 768, 12, 64), (32, 200, 197, 768, 12, 64),
              (2, 24, 17, 128, 4, 32), (3, 200, 197, 768, 6, 128),
              (8, 680, 677, 768, 12, 64), (32, 200, 197, 640, 8, 80)]


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


@pytest.mark.parametrize("shape", [(32, 200, 197, 768, 12, 64),
                                   (8, 680, 677, 768, 12, 64),
                                   (4, 200, 197, 640, 8, 80)])
def test_k10_is_k9_with_an_identity_out_projection(dev, shape):
    """K10's forward is the first two launches of K9's (qkvo_sm90.cuh's
    `qkv_core`): with Wo = I and bo = 0 at d = H·Hd, K9's out-projection
    is exact (each bf16 head output times 1, plus 0, rounded once), so K9's
    output is K10's to the bit."""
    x, w, b, _, *meta = _k10_args(dev, *shape, seed=3)
    d = x.shape[-1]
    assert d == meta[1] * meta[2]
    eye = torch.eye(d, device=dev, dtype=torch.bfloat16)
    zero = torch.zeros(d, device=dev)
    with torch.no_grad():
        k10 = ck.fused_qkv_attention(x, w, b, *meta)
        k9 = ck.fused_qkvo_attention(x, w, b, eye, zero, *meta)
        torch.cuda.synchronize()
    assert torch.equal(k10, k9)


def test_k10_launches_no_first_design_piece(dev):
    """K10's forward and backward, alone and under autograd, launch none of
    the first design's pieces (gemm.cuh's products, the whole-row core and
    its backward), at B/16 @416's spq 680 and at head dim 80 too."""
    for shape in ((32, 200, 197, 768, 12, 64), (8, 680, 677, 768, 12, 64),
                  (4, 200, 197, 640, 8, 80)):
        x, w, b, do, *meta = _k10_args(dev, *shape)
        ck.reset_launch_counts()
        with torch.no_grad():
            ck.fused_qkv_attention(x, w, b, *meta)
            ck.fused_qkv_attention_bwd(x, w, b, do, *meta)
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        ck.fused_qkv_attention(*leaves, *meta).backward(do)
        torch.cuda.synchronize()
        assert {k: v for k, v in ck.launch_counts().items() if v} == {
            "fused_qkv_attention": 2, "fused_qkv_attention_bwd": 2}, shape
        assert ck.first_design_launch_counts() == dict.fromkeys(
            ck.FIRST_DESIGN_PIECES, 0), shape


# K9: (batch, spq, seq_len, D, heads, head_dim): Res-ViT serving's b64 spq
# 200 and training's b32, a ragged seq in a small spq, the TP shard width
# (6 heads of a 768 model: wqkv [768, 1152], wo [384, 768]), the head_dim
# 32 / 128 instantiations of the core, and two shapes only K13's core takes
# (the first design refused them): B/16 @416 (seq 677 in spq 680) and head
# dim 80 (d 640 with 8 heads)
K9_SHAPES = [(64, 200, 197, 768, 12, 64), (32, 200, 197, 768, 12, 64),
             (2, 24, 17, 128, 4, 32), (32, 200, 197, 768, 6, 64),
             (3, 200, 197, 768, 6, 128), (8, 680, 677, 768, 12, 64),
             (32, 200, 197, 640, 8, 80)]


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


@pytest.mark.parametrize("shape", [(32, 200, 197, 768, 12, 64),
                                   (32, 200, 197, 768, 6, 64)])
def test_k9_on_layer_norm_is_k1_to_the_bit(dev, shape):
    """K9 runs K1's Hopper launches after its LN (qkvo_sm90.cuh): on x̂ =
    `ck.layer_norm(x)` its forward output is K1's on x, and its backward's
    dWqkv, dbqkv, dWo and dbo are K1's backward's, to the bit (b32 spq 200
    at 12 heads and at the TP shard width of 6)."""
    batch, spq, seq, d, h, hd = shape
    _, qkvo, _ = _args(dev, batch, spq, seq, d, h, hd, 4 * d, seed=9)
    x, gamma, beta, w, b, wo, bo = qkvo[:7]
    g = torch.Generator(device=dev).manual_seed(19)
    do = torch.randn((batch, spq, d), generator=g,
                     device=dev).to(torch.bfloat16)
    with torch.no_grad():
        xh = ck.layer_norm(x, gamma, beta, EPS)
        assert torch.equal(ck.fused_qkvo_attention(xh, w, b, wo, bo, seq, h,
                                                   hd),
                           ck.fused_ln_qkvo_attention(*qkvo))
        k9 = ck.fused_qkvo_attention_bwd(xh, w, b, wo, do, seq, h, hd)
        k1 = ck.fused_ln_qkvo_attention_bwd(*qkvo[:6], do, EPS, seq, h, hd)
        torch.cuda.synchronize()
    for name, a, r in zip(("dwqkv", "dbqkv", "dwo", "dbo"), k9[1:], k1[3:]):
        assert torch.equal(a, r), name


def test_k9_launches_no_first_design_piece(dev):
    """K9's forward and backward, alone and under autograd, launch none of
    the first design's pieces (gemm.cuh's products, the whole-row core and
    its backward), at B/16 @416's spq 680 and at head dim 80 too."""
    for shape in ((32, 200, 197, 768, 12, 64), (8, 680, 677, 768, 12, 64),
                  (4, 200, 197, 640, 8, 80)):
        x, w, b, wo, bo, do, *meta = _k9_args(dev, *shape)
        ck.reset_launch_counts()
        with torch.no_grad():
            ck.fused_qkvo_attention(x, w, b, wo, bo, *meta)
            ck.fused_qkvo_attention_bwd(x, w, b, wo, do, *meta)
        leaves = [t.clone().requires_grad_() for t in (x, w, b, wo, bo)]
        ck.fused_qkvo_attention(*leaves, *meta).backward(do)
        torch.cuda.synchronize()
        assert {k: v for k, v in ck.launch_counts().items() if v} == {
            "fused_qkvo_attention": 2, "fused_qkvo_attention_bwd": 2}, shape
        assert ck.first_design_launch_counts() == dict.fromkeys(
            ck.FIRST_DESIGN_PIECES, 0), shape


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


# ---------------------------------------------------------------------------
# The s8 wgmma path of gemm_sm90.cuh (K3's backward with kv_heads == heads,
# K4's): each epilogue launched alone against exact int32 products
# dequantized by its twin, on ragged M, N and K; the group fold over groups
# whose rows do not fill the 128-code K tile (K3's 400-row groups padded to
# 512, zero past the rows, as dw_int8.cuh packs them). Every output is the
# twin's bits: the int32 sums are exact, the epilogues round where the twin
# rounds (the bias add fused as its addcmul), and their GELUs' expf and
# rsqrtf gave torch's exp and rsqrt bits on the card. K4's forward rests on
# this to give its twin's bits.

@pytest.mark.parametrize("case", ck.GEMM_SM90_S8_CASES)
def test_gemm_sm90_s8_matches_exact_products(dev, case):
    kind, m, n, k, extra = case
    inputs = ck.gemm_sm90_s8_inputs(kind, m, n, k, extra, device=dev)
    with torch.no_grad():
        outs = ck.gemm_sm90_s8(kind, **inputs)
        again = ck.gemm_sm90_s8(kind, **inputs)
        torch.cuda.synchronize()
        refs = ck.gemm_sm90_s8_ref(kind, **inputs)
    if kind != "s8_gelu_pair":
        outs, again, refs = (outs,), (again,), (refs,)
    for out, out2, ref in zip(outs, again, refs):
        assert out.shape == ref.shape and out.dtype == ref.dtype, kind
        assert torch.equal(out, out2), kind
        print(f"{kind} {m}x{n}x{k}: the twin's bits "
              f"{torch.equal(out, ref)}, max|k - t| "
              f"{(out.float() - ref.float()).abs().max().item():.3e}")
        assert torch.equal(out, ref), kind


def test_gemm_sm90_s8_rejects_what_it_does_not_take(dev):
    a = torch.zeros(64, 100, dtype=torch.int8, device=dev)  # k % 16 != 0
    s = torch.ones(64, device=dev)
    with pytest.raises(RuntimeError):
        ck.gemm_sm90_s8("s8_f32", a, a, s, s)
    b = torch.zeros(60, 128, dtype=torch.int8, device=dev)  # n % 8 != 0
    with pytest.raises(RuntimeError):
        ck.gemm_sm90_s8("s8_f32", b[:, :128].contiguous(), b,
                        torch.ones(60, device=dev), torch.ones(60, device=dev))
    c = torch.zeros(64, 256, dtype=torch.int8, device=dev)  # group % 128
    with pytest.raises(RuntimeError):
        ck.gemm_sm90_s8("s8_group", c, c, torch.ones(4, 64, device=dev),
                        group=64)


# K3's and K4's int8 backwards on their Hopper design, with int8_dw off and
# on: train_cli's b32 spq 200, the drop phase's b32 spq 104 and one image;
# every output within the bf16 tolerance and INT8_REL (chip_smoke.py's) of
# the twin, the codes within their bands, the s8 products counted, and two
# launches the same bits.
HOPPER_INT8_SHAPES = [(32, 200, 197), (32, 104, 99), (1, 200, 197)]
INT8_REL = 5e-3


@pytest.mark.parametrize("int8_dw", [False, True])
@pytest.mark.parametrize("shape", HOPPER_INT8_SHAPES)
def test_int8_backwards_on_hopper_match_twins_and_keep_their_bits(dev, shape,
                                                                  int8_dw):
    args = _int8_args(dev, *shape, None)
    ck.reset_launch_counts()
    for base in INT8_BWD:
        name = base.replace("_bwd", "_dw_bwd") if int8_dw else base
        sk, st = {}, {}
        with torch.no_grad():
            outs = getattr(ck, name)(*args[base], scratch=sk)
            again = getattr(ck, name)(*args[base])
            torch.cuda.synchronize()
            refs = getattr(ck, name + "_ref")(*args[base], scratch=st)
        for i, (out, out2, ref) in enumerate(zip(outs, again, refs)):
            _assert_close(out, ref)
            assert torch.equal(out, out2), (name, i)
            rel = ((out.double() - ref.double()).norm()
                   / ref.double().norm().clamp_min(1e-30)).item()
            assert rel <= INT8_REL, (name, i, rel)
        _codes_within_band(name, sk, st)
    names = [n.replace("_bwd", "_dw_bwd") if int8_dw else n for n in INT8_BWD]
    assert {k: v for k, v in ck.launch_counts().items() if v} == \
        dict.fromkeys(names, 2)
    assert ck.s8_launch_counts() == {
        "gemm_sm90_s8:s8_bf16": 4, "gemm_sm90_s8:s8_f32": 4,
        "gemm_sm90_s8:s8_gelu_pair": 2,
        "gemm_sm90_s8:s8_group": 8 if int8_dw else 0,
        "gemm_sm90_s8:s8_gelu_q_f32": 0, "gemm_sm90_s8:s8_residual": 0,
        "gemm_sm90_s8:s8_residual_f32": 0,
        "gemm_sm90_s8:s8_group_rc": 0}


# K3's and K4's int8 forwards on their Hopper design: LN-quant, the s8
# wgmma products (K3: two s8_bf16; K4: s8_gelu_q_f32 and s8_residual, or
# s8_bf16 without the residual) and K13's core with an fp32 out, no gemm.cuh
# s8 product and no whole-row core; at b32 and b64 spq 200, ragged rows
# (K4) and b16@416's spq 680 (K3: seq 677, past the whole-row core); every
# output within INT8_REL of the twin, two launches the same bits; K4's out,
# with and without the residual, and its h1q codes the twin's bits from the
# kernel's own LN codes.
HOPPER_FWD_SHAPES = [(32, 200, 197, None), (64, 200, 197, None),
                     (3, 200, 197, 197), (4, 680, 677, None)]


@pytest.mark.parametrize("shape", HOPPER_FWD_SHAPES)
def test_int8_forwards_on_hopper_launch_their_products(dev, shape):
    args = _int8_args(dev, *shape)
    names = INT8_FWD if shape[3] is None else INT8_FWD[1:]
    ck.reset_launch_counts()
    for name in names:
        with torch.no_grad():
            out = getattr(ck, name)(*args[name])
            again = getattr(ck, name)(*args[name])
            torch.cuda.synchronize()
            ref = getattr(ck, name + "_ref")(*args[name])
        _assert_close(out, ref)
        assert torch.equal(out, again), name
        rel = ((out.double() - ref.double()).norm()
               / ref.double().norm().clamp_min(1e-30)).item()
        print(f"{name} {shape}: ‖k − t‖/‖t‖ {rel:.3e}, the twin's bits "
              f"{torch.equal(out, ref)}")
        assert rel <= INT8_REL, (name, rel)
    k3 = 2 * (names == INT8_FWD)
    assert ck.s8_launch_counts() == {
        "gemm_sm90_s8:s8_bf16": 2 * k3, "gemm_sm90_s8:s8_f32": 0,
        "gemm_sm90_s8:s8_gelu_pair": 0, "gemm_sm90_s8:s8_group": 0,
        "gemm_sm90_s8:s8_gelu_q_f32": 2, "gemm_sm90_s8:s8_residual": 2,
        "gemm_sm90_s8:s8_residual_f32": 0,
        "gemm_sm90_s8:s8_group_rc": 0}
    assert ck.first_design_launch_counts() == dict.fromkeys(
        ck.FIRST_DESIGN_PIECES, 0)
    ck.reset_launch_counts()
    mlp = args["fused_ln_mlp_int8"]
    for residual in (True, False):
        sk, st = {}, {}
        with torch.no_grad():
            out = ck.fused_ln_mlp_int8(*mlp, residual=residual, scratch=sk)
            torch.cuda.synchronize()
            ref = ck.fused_ln_mlp_int8_from_codes_ref(
                mlp[0], *sk["xq"], *mlp[3:7], residual=residual, scratch=st)
        for key in ("w1q", "w2q", "h1q"):
            assert all(map(torch.equal, sk[key], st[key])), (residual, key)
        assert torch.equal(out, ref), residual
    assert ck.s8_launch_counts() == {
        "gemm_sm90_s8:s8_bf16": 1, "gemm_sm90_s8:s8_f32": 0,
        "gemm_sm90_s8:s8_gelu_pair": 0, "gemm_sm90_s8:s8_group": 0,
        "gemm_sm90_s8:s8_gelu_q_f32": 2, "gemm_sm90_s8:s8_residual": 1,
        "gemm_sm90_s8:s8_residual_f32": 0,
        "gemm_sm90_s8:s8_group_rc": 0}


# K8's int8 tier on its Hopper design (K3's launches on the two row sets,
# K13's core in the rect geometry): the forward and both backward branches
# at Res-ViT's b32 C 0.625 (cpq 128 of spq 200), ft_resvit_fast.sh's b192
# drop geometry (cpq 64 of spq 104, cap 62), a ragged b3 cap 37 and b16@416
# (spq 680, seq 677: past the whole-row core); every output within the
# bf16 tolerance and INT8_REL of the twin, the codes within their bands,
# two launches the same bits, dk = dv = 0 on the keys >= seq_len (dbkv's
# share of them), the s8 products by kind and no first-design piece.
RECT_HOPPER_SHAPES = [(32, 200, 197, 124), (192, 104, 99, 62),
                      (3, 200, 197, 37), (4, 680, 677, 400)]
RECT_INT8 = ("fused_ln_qkvo_attention_rect_int8",
             "fused_ln_qkvo_attention_rect_int8_bwd",
             "fused_ln_qkvo_attention_rect_int8_dw_bwd")


@pytest.mark.parametrize("shape", RECT_HOPPER_SHAPES)
def test_rect_int8_on_hopper_launch_their_products(dev, shape):
    args, _ = _rect_bwd_args(dev, *shape)
    fwd_args = (*args[:7], torch.zeros(768, device=dev) + 0.01, *args[8:])
    ck.reset_launch_counts()
    for name in RECT_INT8:
        a = fwd_args if name == RECT_INT8[0] else args
        sk, st = {}, {}
        with torch.no_grad():
            outs = getattr(ck, name)(*a, scratch=sk)
            again = getattr(ck, name)(*a)
            torch.cuda.synchronize()
            refs = getattr(ck, name + "_ref")(*a, scratch=st)
        if name == RECT_INT8[0]:
            outs, again, refs = (outs,), (again,), (refs,)
        for i, (out, out2, ref) in enumerate(zip(outs, again, refs)):
            _assert_close(out, ref)
            assert torch.equal(out, out2), (name, i)
            rel = ((out.double() - ref.double()).norm()
                   / ref.double().norm().clamp_min(1e-30)).item()
            assert rel <= INT8_REL, (name, i, rel)
        _codes_within_band(name, sk, st)
        del outs, again, refs
    counts = ck.s8_launch_counts()
    assert {k: v for k, v in ck.launch_counts().items() if v} == \
        dict.fromkeys(RECT_INT8, 2)
    assert counts == {
        "gemm_sm90_s8:s8_bf16": 2 * 3 + 2 * 3 * 2, "gemm_sm90_s8:s8_f32": 8,
        "gemm_sm90_s8:s8_gelu_pair": 0, "gemm_sm90_s8:s8_group": 6,
        "gemm_sm90_s8:s8_gelu_q_f32": 0, "gemm_sm90_s8:s8_residual": 0,
        "gemm_sm90_s8:s8_residual_f32": 0,
        "gemm_sm90_s8:s8_group_rc": 0}
    assert ck.first_design_launch_counts() == dict.fromkeys(
        ck.FIRST_DESIGN_PIECES, 0)


@pytest.mark.parametrize("int8_dw", [False, True])
def test_rect_int8_backward_writes_zero_grads_on_masked_keys(dev, int8_dw):
    """The key pass in the rect geometry writes dk and dv as 0 on the key
    rows seq_len..spq (vitax's p is exactly 0 there): their row codes are
    0, so is dxn, and dx on those rows of x is exactly 0."""
    args, _ = _rect_bwd_args(dev, 4, 200, 150, 37)
    name = ("fused_ln_qkvo_attention_rect_int8_dw_bwd" if int8_dw
            else "fused_ln_qkvo_attention_rect_int8_bwd")
    sk = {}
    with torch.no_grad():
        dx = getattr(ck, name)(*args, scratch=sk)[1]
    assert torch.isfinite(dx.float()).all()
    assert dx[:, 150:].abs().max().item() == 0
    codes = sk["dkvq"][0].view(4, 200, -1)
    assert codes[:, 150:].abs().max().item() == 0


# The shapes that K13's limits admit to the K1 family and the whole-row
# core did not (ops/gates.py): b16@416's seq 677 (spq 680), head dim 80
# (D 640, 8 heads) and 128 (D 1024, 8 heads, seq 530). K1's forward and
# backward against their twins; K3's int8 forward, and its backward with
# and without int8_dw, within INT8_REL of theirs, the codes in their bands,
# on the s8 wgmma path and K13's core only.
# (batch, spq, seq_len, D, heads, head_dim)
K13_GATE_SHAPES = [(8, 680, 677, 768, 12, 64), (4, 200, 197, 640, 8, 80),
                   (2, 536, 530, 1024, 8, 128)]


@pytest.mark.parametrize("shape", K13_GATE_SHAPES)
def test_k1_family_runs_k13_shapes_the_whole_row_core_cannot(dev, shape):
    b, spq, seq, d, h, hd = shape
    bf = _bwd_args(dev, b, spq, seq, d, h, hd, 4 * d)[
        "fused_ln_qkvo_attention_bwd"]
    x, w = bf[0], bf[3]
    assert not ck._core_fits(x, w, h, backward=True)
    assert ck.qkv_attention_supported(x, w, h)
    qkvo = _args(dev, b, spq, seq, d, h, hd, 4 * d)[1]
    ck.reset_launch_counts()
    with torch.no_grad():
        _assert_close(ck.fused_ln_qkvo_attention(*qkvo),
                      ck.fused_ln_qkvo_attention_ref(*qkvo))
        outs = ck.fused_ln_qkvo_attention_bwd(*bf)
        torch.cuda.synchronize()
        refs = ck.fused_ln_qkvo_attention_bwd_ref(*bf)
    for out, ref in zip(outs, refs):
        _assert_close(out, ref)
    del outs, refs
    args = _int8_args(dev, b, spq, seq, None, d=d, h=h, hd=hd)
    fwd = "fused_ln_qkvo_attention_int8"
    names = (fwd, fwd + "_bwd", fwd + "_dw_bwd")
    for name in names:
        sk, st = {}, {}
        with torch.no_grad():
            outs = getattr(ck, name)(*args[fwd if name == fwd else
                                          fwd + "_bwd"], scratch=sk)
            torch.cuda.synchronize()
            refs = getattr(ck, name + "_ref")(
                *args[fwd if name == fwd else fwd + "_bwd"], scratch=st)
        if name == fwd:
            outs, refs = (outs,), (refs,)
        for i, (out, ref) in enumerate(zip(outs, refs)):
            _assert_close(out, ref)
            rel = ((out.double() - ref.double()).norm()
                   / ref.double().norm().clamp_min(1e-30)).item()
            assert rel <= INT8_REL, (name, i, rel)
        _codes_within_band(name, sk, st)
        del outs, refs
    assert {k: v for k, v in ck.launch_counts().items() if v} == {
        "fused_ln_qkvo_attention": 1, "fused_ln_qkvo_attention_bwd": 1,
        **dict.fromkeys(names, 1)}
    assert ck.s8_launch_counts() == {
        "gemm_sm90_s8:s8_bf16": 2 + 2 + 2, "gemm_sm90_s8:s8_f32": 2,
        "gemm_sm90_s8:s8_gelu_pair": 0, "gemm_sm90_s8:s8_group": 2,
        "gemm_sm90_s8:s8_gelu_q_f32": 0, "gemm_sm90_s8:s8_residual": 0,
        "gemm_sm90_s8:s8_residual_f32": 0,
        "gemm_sm90_s8:s8_group_rc": 0}
    assert ck.first_design_launch_counts() == dict.fromkeys(
        ck.FIRST_DESIGN_PIECES, 0)


def test_k3_and_k4_int8_backwards_keep_p_ds_and_a1_out_of_device_memory(dev):
    """At b32 spq 200 K3's int8 backward allocates no bf16 P and ds
    (2·b·H·208² bf16, 66 MB) and K4's no fp32 a1 ([n, M], 79 MB): each
    call's peak stays under its outputs and scratch plus a third of what
    those would add."""
    b, spq, d, h, hd, m = 32, 200, 768, 12, 64, 3072
    n, w, hhd = b * spq, 3 * h * hd, h * hd
    args = _int8_args(dev, b, spq, 197, None)
    lib = ck.build.load()
    k3, _ = _peak_bytes(lambda: ck.fused_ln_qkvo_attention_int8_bwd(
        *args["fused_ln_qkvo_attention_int8_bwd"]))
    k3_rest = (2 * n * d + 4 * (2 * d + d * w + w + hhd * d + d)  # outputs
               + 2 * d * w + hhd * d + 4 * (w + d + hhd)  # the weights' codes
               + 2 * n * d + 2 * n * w + 2 * 2 * n * hhd  # xn, qkv, attn, dattn
               + 2 * n * w + 4 * n * d  # dqkv, dxn
               + 2 * n * d + n * w + 4 * 3 * n  # xq, doq, dqq, their scales
               + 4 * lib.vitax_ln_qkvo_attention_bwd_ws(n, d, hhd, w)
               + 4 * lib.vitax_attention_core_bwd_ws(b, spq, h))
    rows = (spq + 15) // 16 * 16
    assert k3 <= k3_rest + 2 * 2 * b * h * rows * rows / 3, (k3, k3_rest)
    k4, _ = _peak_bytes(lambda: ck.fused_ln_mlp_int8_bwd(
        *args["fused_ln_mlp_int8_bwd"]))
    k4_rest = (2 * n * d + 4 * (2 * d + 2 * d * m + m + d)  # outputs
               + 3 * d * m + 4 * (2 * m + d)  # the weights' codes
               + 2 * n * d + 2 * n * d + 4 * n * 3  # xn, xq, doq, scales
               + 2 * 2 * n * m + 4 * n * m + n * m  # h1, dh1, dh1_32, dh1q
               + 4 * n * d + 4 * lib.vitax_ln_mlp_bwd_ws(n, d, m))
    assert k4 <= k4_rest + 4 * n * m / 3, (k4, k4_rest)
