"""K10 (the QKV projection and the attention core without LN or
out-projection, Res-ViT's `attention` without fused_qkvo) composed from
plain versions in the order its Hopper entry points launch them on the card
(csrc/qkv_attention.cu, csrc/qkv_attention_bwd.cu), on CPU tensors.

- The forward: qkv on `gemm_sm90_ref("nn_bias")`, K13's core on the packed
  rows (p from the row statistics in exp2, rounded to bf16 once; the head
  outputs rounded to bf16 once): qkvo_sm90.cuh's `qkv_core`, K9's first two
  launches. Against the twin (`fused_qkv_attention_ref`) and vitax's
  `fused_qkv_attention` under `jax.jit` in interpret mode within 2e-2, and
  against K9's composed head outputs to the bit.
- The backward: the qkv recompute, K13's row pass in its kRowsFwdStats mode
  (the forward's two passes; dd = Σ fp32(dO)·o from the fp32 head outputs,
  as vitax's K10 takes it, :2263-2268), K13's key and query passes, dx
  (`nt_store`: one rounding), dWqkv (`tn_f32`), dbqkv. Against the twin and
  vitax's VJP (`_fused_qkv_attention_bwd`) under `jax.jit` in interpret
  mode within 2e-2, with dO nonzero on the pad rows (vitax computes those
  query rows too).
- A source check that K10's entry points run Hopper pieces only: no
  whole-row core, no gemm.cuh product, no P, ds or fp32 head outputs.

Tiny widths: D 128, 2 heads of 64, spq 24 with seq_len 21, bf16, 2 images.
"""

import functools
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tests import torch_int8_compose as compose  # noqa: E402
from tests.test_torch_k9_decomposition import k9_fwd_composed  # noqa: E402
from vitax.ops import pallas_kernels as pk  # noqa: E402
from vitax_torch.kernels import build  # noqa: E402
from vitax_torch.ops import cuda_kernels as ck  # noqa: E402

D, H, HD, SPQ, SEQ = 128, 2, 64, 24, 21
HHD = H * HD
B = 2
BF = torch.bfloat16
TOL = 2e-2
NAMES = ("dx", "dwqkv", "dbqkv")
_MATS = ("xh", "do", "wqkv", "wo")


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _arrays(seed):
    """x̂ [B, SPQ, D] at an LN output's scale, the QKV weights, dO [B, SPQ,
    H·Hd] nonzero on the pad rows too, and an out-projection (K9's
    composition takes one; its head outputs do not depend on it)."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(xh=n(B, SPQ, D), do=n(B, SPQ, HHD),
                wqkv=n(D, 3 * HHD, scale=D ** -0.5),
                bqkv=n(3 * HHD, scale=0.1), wo=n(HHD, D, scale=HHD ** -0.5),
                bo=n(D, scale=0.1))


def _torch(arrays):
    return {k: torch.from_numpy(v).to(BF if k in _MATS else torch.float32)
            for k, v in arrays.items()}


def _jax(arrays):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in _MATS else jnp.float32)
            for k, v in arrays.items()}


def _heads(qkv):
    return tuple(ck._split_heads(qkv.view(B, SPQ, -1)[..., i * HHD:
                                                      (i + 1) * HHD], H)
                 for i in range(3))


def k10_fwd_composed(t):
    """K10's forward in its launch order: the heads' outputs [B, SPQ, H·Hd]
    in bf16."""
    qkv = ck.gemm_sm90_ref("nn_bias", t["xh"].reshape(-1, D), t["wqkv"],
                           t["bqkv"])
    o = compose.k13_core_f32(*_heads(qkv), SEQ).to(BF)
    return ck._heads_to_rows(o).view(B, SPQ, HHD)


def k10_bwd_composed(t):
    """K10's backward in its launch order: (dx, dWqkv, dbqkv), and the
    core's dk, dv [B, H, SPQ, HD]. The row pass's dd takes the fp32 head
    outputs, never rounded (kRowsFwdStats)."""
    x2 = t["xh"].reshape(-1, D)
    qkv = ck.gemm_sm90_ref("nn_bias", x2, t["wqkv"], t["bqkv"])
    q, k, v = _heads(qkv)
    o32 = compose.k13_core_f32(q, k, v, SEQ)
    assert o32.dtype == torch.float32
    d_o = ck._split_heads(t["do"], H)
    dq, dk, dv = compose.k13_core_grads(q, k, v, o32, d_o, SEQ)
    dqkv = torch.cat([ck._heads_to_rows(g) for g in (dq, dk, dv)], dim=1)
    dx = ck.gemm_sm90_ref("nt_store", dqkv, t["wqkv"])
    dw = ck.gemm_sm90_ref("tn_f32", x2, dqkv)
    return (dx.view(B, SPQ, D), dw, dqkv.float().sum(dim=0)), dk, dv


def _close(out, ref, what):
    ref = np.asarray(ref, np.float32)
    out = out.float().numpy().reshape(ref.shape)
    bound = TOL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= bound, f"{what}: max error {err:.3e} > {bound:.3e}"


def _k10_args(t):
    return (t["xh"], t["wqkv"], t["bqkv"])


def test_forward_launch_order_matches_its_twin_and_vitax_under_jit():
    arrays = _arrays(281)
    j, t = _jax(arrays), _torch(arrays)
    out = k10_fwd_composed(t)
    twin = ck.fused_qkv_attention_ref(*_k10_args(t), SEQ, H, HD)
    assert out.dtype == BF and out.shape == twin.shape == (B, SPQ, HHD)
    _close(out, twin.float().numpy(), "K10 out vs its twin")
    fn = jax.jit(lambda *a: pk.fused_qkv_attention(*a, SEQ, H, HD))
    ref = fn(j["xh"], j["wqkv"], j["bqkv"])
    # vitax's pad query rows attend as the port's do; every row is held
    _close(out, jnp.asarray(ref, jnp.float32), "K10 vs vitax")


def test_backward_launch_order_matches_its_twin_and_vitax_under_jit():
    arrays = _arrays(282)
    j, t = _jax(arrays), _torch(arrays)
    outs, dk, dv = k10_bwd_composed(t)
    # the key pass's masked keys, and the pad rows, whose dO is nonzero
    assert not dk[:, :, SEQ:].any() and not dv[:, :, SEQ:].any()
    assert dk[:, :, :SEQ].any() and t["do"][:, SEQ:].any()
    twin = ck.fused_qkv_attention_bwd_ref(*_k10_args(t), t["do"], SEQ, H, HD)
    fn = jax.jit(functools.partial(pk._fused_qkv_attention_bwd, SEQ, H, HD))
    refs = fn((j["xh"], j["wqkv"], j["bqkv"]), j["do"])
    for name, o, r, v in zip(NAMES, outs, twin, refs):
        assert o.dtype == r.dtype and o.shape == r.shape, name
        _close(o, r.float().numpy(), name)
        _close(o, jnp.asarray(v, jnp.float32), f"{name} vs vitax")


def test_k10_forward_is_k9s_head_outputs_to_the_bit():
    """K10's forward is qkvo_sm90.cuh's `qkv_core`, the launches before K9's
    out-projection: on the same x̂ its output is the head outputs K9
    projects, to the bit."""
    arrays = _arrays(283)
    t = _torch(arrays)
    _, (_, _, _, o) = k9_fwd_composed(t["xh"], t)
    assert torch.equal(k10_fwd_composed(t), ck._heads_to_rows(o).view(
        B, SPQ, HHD))


def _body(src, name):
    """The text of the function `name` of a source, up to its closing
    brace at column 0."""
    start = re.search(rf"^\S.* {name}\(", src, re.M).start()
    return src[start:src.index("\n}\n", start)]


_FIRST_DESIGN = ('#include "attention.cuh"', '#include "attention_bwd.cuh"',
                 '#include "gemm.cuh"', "vitax::launch_gemm",
                 "launch_gemm_nt", "launch_gemm_tn",
                 "launch_attention_core_geom", "launch_attention_bwd",
                 "AttnGeom", "o32")


@pytest.mark.parametrize("source,entry,calls", [
    ("qkv_attention.cu", "vitax_qkv_attention_fwd",
     ("vitax::qkvo::qkv_core(",)),
    ("qkv_attention_bwd.cu", "vitax_qkv_attention_bwd",
     ("sm90::gemm_nn<sm90::kEpiBias>(",
      "k13::launch_core_rows<k13::kRowsFwdStats>(",
      "k13::launch_core_bwd_passes(", "vitax::qkvo::proj_bwd(")),
])
def test_k10_runs_hopper_pieces_only(source, entry, calls):
    """K10's two entry points launch gemm_sm90.cuh's products, K13's core
    (its forward, or the kRowsFwdStats row pass and the key and query
    passes) and colsum.cuh's sums only, through qkvo_sm90.cuh's `qkv_core`
    and `proj_bwd`, which K9's and K1's sequence calls too; the sources
    include no first-design header, and no entry point takes P, ds or the
    fp32 head outputs."""
    src = (build.CSRC / source).read_text()
    body = _body(src, entry)
    for call in calls:
        assert call in body, call
    assert "void* p," not in body and "void* ds," not in body
    for first_design in _FIRST_DESIGN:
        assert first_design not in src, first_design
    shared = (build.CSRC / "qkvo_sm90.cuh").read_text()
    assert "return proj_bwd(" in _body(shared, "bwd")
    for launch in ("sm90::gemm_nt<sm90::kEpiStore>(", "sm90::gemm_tn(",
                   "launch_colsum("):
        assert launch in _body(shared, "proj_bwd"), launch
    core = (build.CSRC / "attention_core.cuh").read_text()
    assert "kRowsFwdStats = 5" in core
