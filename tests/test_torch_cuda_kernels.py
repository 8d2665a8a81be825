"""The Hopper kernels of vitax_torch on a CUDA card: each against its plain
twin, and the wrappers' argument checks. Needs torch only (no jax), so it
runs on a machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Where there is no card every test skips (the CUDA kernels have no CPU mode).
Tolerance: max|kernel - twin| <= 2e-2 * max(1, max|twin|) in bf16 (ulp 2^-8,
same rounding points, sums in another order); 1e-5 for the fp32 LN.
"""

import pytest

torch = pytest.importorskip("torch")

from vitax_torch.ops import cuda_kernels as ck  # noqa: E402

pytestmark = pytest.mark.cuda
EPS = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
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
    assert ck.launch_counts() == {"layer_norm": 1,
                                  "fused_ln_qkvo_attention": 1,
                                  "fused_ln_mlp": 1}


def test_fp32_layer_norm_and_ragged_rows(dev):
    x = torch.randn(3, 197, 768, device=dev)
    g, b = torch.rand(768, device=dev) + 0.5, torch.randn(768, device=dev)
    _assert_close(ck.layer_norm(x, g, b, EPS), ck.layer_norm_ref(x, g, b, EPS),
                  tol=1e-5)
    ln, _, mlp = _args(dev, 3, 197, 197, 768, 12, 64, 3072)
    with torch.inference_mode():
        _assert_close(ck.layer_norm(*ln), ck.layer_norm_ref(*ln))
        _assert_close(ck.fused_ln_mlp(*mlp), ck.fused_ln_mlp_ref(*mlp))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    ln, qkvo, mlp = _args(dev, 2, 16, 10, 128, 2, 64, 256)
    x = qkvo[0]
    with pytest.raises(RuntimeError, match="forward-only"):
        ck.fused_ln_mlp(x.clone().requires_grad_(), *mlp[1:])
    with pytest.raises(ValueError, match="contiguous"):
        ck.layer_norm(x.transpose(0, 1), *ln[1:])
    with pytest.raises(TypeError):
        ck.fused_ln_mlp(x.float(), *mlp[1:])
    with pytest.raises(ValueError):
        ck.fused_ln_qkvo_attention(x[:, :10].contiguous(), *qkvo[1:])
    with pytest.raises(ValueError, match="not CUDA"):
        ck.fused_ln_mlp(x, *mlp[1:3], mlp[3].cpu(), *mlp[4:])
