"""Two checkouts of the port in turns on one CUDA card: the main paths end
to end, and the bits of kernels that a change must not move.

    PYTHONPATH=<checkout> python vitax_torch/scripts/turns.py <tag>

With the `vitax_torch` found first on the path (that checkout's, which this
file need not belong to), it prints under `tag`:

- checksums (`checksums`): sha256 prefixes of the outputs of K6's forward
  and backward at ViT-H/14's widths, and of K1's forward, K2's forward,
  K7's backward (4 kv heads), K3's backward (`--int8-grad`), K13's
  forward and backward, the bf16 K8's forward and backward (cpq 128 of
  spq 200) and K9's and K10's forward and backward (on x̂ = LN(x) of K1's
  inputs) at ViT-B/16's, on inputs made from fixed seeds on the card;
  two checkouts give the same line where those kernels kept their bits;
- `int8_checksums`: the same of the int8 and int4 tiers: K3's and K4's
  forwards (K4's also without its residual; the LN-quant prologue's codes,
  scales and xn reach every output), the two halves of K5 output by output
  (r1, its pack, the codes it wrote, qkv where the checkout hands it over;
  r2, its pack, h1q), K3's and K4's backwards with and without int8_dw
  (K4's also without its residual) with the codes they wrote, K8's int8
  forward and backwards with and without int8_dw (cpq 128 of spq 200), and
  K7's int8 forward and backwards (4 kv heads), K11-A, K11-C, K11-B
  (also without its residual) and K11-D with and without int8_dw, G-F and
  G-B, R-F and R-B with and without int8_dw;
- `ln_checksums`: the same of the LN kernel pair alone (the standalone
  entry points, register path and loop form, bf16 and fp32): the forward,
  the backward's dx, and its dγ/dβ apart (their order of sums may change
  where dx keeps its bits);
- `repeat_checksums`: the same of K1's and K2's forwards and backwards,
  twice each, to show that two runs of each give the same bits;
- `ln_device_times`: device times (torch.profiler's kernel records, inputs
  rotated over four copies so that no call finds them in L2) of the LN
  forward at ViT-B/16's b64 and b32 spq 200 beside F.layer_norm, of its
  backward at b32 beside the autograd of F.layer_norm, of the fused
  backwards' LN tails (fp32 dy: K1's without R, K2's with its residual R)
  at b32, and of colsum.cuh's final pass a launch in K2's backward, each
  beside its bound;
- `kernel_times`: CUDA-event medians of 25 launches of K1's forward at
  ViT-B/16's b64 and b32 spq 200 and b8 spq 584, and of K2's and K12's
  forwards, each with and without the residual, at b64 and b32 spq 200;
  of K3's and K4's int8 backwards, with and without int8_dw, at b32 spq
  200 and the drop phase's spq 104; of K3's and K4's int8 forwards at b64
  and b32 spq 200; of K5's two halves at the drop phase's b32 spq 104;
- `k4_outputs`: K4's int8 forward at b32 spq 200 (out, out without the
  residual, the h1q codes and their row scales) and b64 (out, row scales),
  and at b32 the first-design forwards on gemm.cuh's s8 epilogue (K12-int8's
  out, K11-A's, K7's int8 forward with 4 kv heads),
  saved under `build/turns_k4/<tag>.pt` from the working directory, and
  the count of values that differ from each other tag's file there (a
  tag's earlier file first: two runs of one checkout compare too);
- `int8_bwd_device`: where K3's and K4's int8 backwards, with and without
  int8_dw, spend their device time at ViT-B/16's b32 spq 200: each
  call's device time and its kernels by name, with their launches a call
  (torch.profiler's kernel records over 5 calls); `int8_fwd_device` the
  same of K3's and K4's int8 forwards at b32 and b64 spq 200, `ho_device`
  of K5's two halves at spq 104, b32 and the fast recipe's b768;
- `rect_int8`: K8's int8 forward (b64 cpq 128 of spq 200, the b192 drop
  geometry cpq 64 of spq 104) and its backward with and without int8_dw
  (b32 cpq 128, b192 cpq 64): CUDA-event medians of 25 beside each call's
  device time and kernels (`_by_kernel`); `rect_bf16` the same of the
  bf16 K8's forward (b64 cpq 128 and cpq 104 of spq 200) and backward
  (b32 cpq 128); `rect_steps`: CUDA-event medians of 10 of the compacted
  bf16 and `--int8` serving forwards at b64 (phase 8), the compacted bf16
  step at b32 (phase 9 (b)) and ft_resvit_fast.sh's b192 step (phase 9
  (c));
- `gqa_int8_bwd`: K7's int8 backward with and without int8_dw (4 kv heads)
  at b64 and b32 spq 200: the CUDA-event median of 25, `device_ms` over four
  input copies and `_by_kernel`'s device time and kernels;
- `int4_attn`: the same of the A4W4 attention half at its chip_smoke.py
  shapes: K11-C at b32 spq 200, G-F at b64 with 4 kv heads, K11-D and G-B
  (4 kv heads) with and without int8_dw at b32; `int4_bwd` of the int4_grad
  backwards beside their int8 siblings: R-B and R-B dw beside K8's int8
  backwards at b32 cpq 128 of spq 200, K11-B (int8_dw off and on, with and
  without the residual) beside K4's at b32 spq 200;
- `k9`: K9's forward at ViT-B/16's b64 spq 200 and its backward at b32,
  beside K1's at the same shapes (K9 on x̂ = LN(x) of K1's x): the
  CUDA-event median of 25 and `device_ms` over four input copies; `k10`
  the same of K10's forward and backward beside K9's and K1's;
- CUDA-event medians of 10 on a resident Synthetic batch, random weights
  from seed 0: ViT-B/16 @224 train steps (forward, backward, SGD with
  momentum) at b32 in bf16, `--int8`, `--int8-grad`, `--int8-dw` and
  `--save-acts`, with the bf16 step's peak device memory; the fast
  recipe's (scripts/FT_CIFAR100_fast.sh) `--int8-dw` steps at its dense
  tail's b192 and its drop phase's b768 keep 0.5; the bf16 serving forward
  at b64 @224 and @384 (K1 at spq 584), and `--int8`'s at b64 @224; `--no-fused-qkv` (K13) forward b64 @384
  and step b32; Res-ViT's `scripts/ft_resvit.sh` (a) step at b32 (teacher
  and student forward, backward, AdamW); ViT-H/14 @224 step at b32 with
  its peak device memory, and the ViT-H/14 and ViT-L/16 serving forwards at
  b32 @384 (both on K6).

Run it for two checkouts in the order A, B, B, A in one call on the card
(each run builds its checkout's kernels into that checkout's `build/`).
Names after the tag run only those sections (`checksums`, `int8_checksums`,
`ln_checksums`, `repeat_checksums`, `ln_device_times`, `timings`,
`kernel_times`, `k4_outputs`, `int8_bwd_device`, `int8_fwd_device`,
`ho_device`, `rect_int8`, `rect_bf16`, `rect_steps`, `gqa_int8_bwd`,
`int4_attn`, `int4_bwd`, `k9`, `k10`), e.g.
`turns.py A int8_checksums kernel_times`.
"""

from __future__ import annotations

import hashlib
import statistics
import subprocess
import sys

import torch

H14_WIDTHS = (1280, 16, 80)  # D, heads, head_dim
B16_WIDTHS = (768, 12, 64, 3072)  # D, heads, head_dim, M
RESVIT_FLAGS = ["--model-arch", "b16", "--image-size", "224", "--use_lora",
                "True", "--lora_rank", "48", "--use_reslr", "True",
                "--block_size", "4", "--dynamic_start_layer", "1",
                "--dynamic_reserve_initials", "2", "--dynamic_active_target",
                "0.4", "--dataset", "Synthetic"]  # scripts/ft_resvit.sh's


def _digest(outs) -> str:
    torch.cuda.synchronize()
    return " ".join(hashlib.sha256(o.float().cpu().numpy().tobytes())
                    .hexdigest()[:12] for o in outs)


def _rnd(g):
    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(dtype)
    return rnd


def _half_inputs(seed, b, spq, d, width, hhd, m):
    """Seeded inputs of an attention half (x, γ, β, Wqkv, bqkv, Wo), its bo
    and do, and an MLP half's W1, b1, W2, b2."""
    rnd = _rnd(torch.Generator(device="cuda").manual_seed(seed))
    f32 = torch.float32
    head = (rnd(b, spq, d), 1 + rnd(d, scale=0.1, dtype=f32),
            rnd(d, scale=0.1, dtype=f32), rnd(d, width, scale=d ** -0.5),
            rnd(width, scale=0.02, dtype=f32), rnd(hhd, d, scale=hhd ** -0.5))
    mlp = (rnd(d, m, scale=d ** -0.5), rnd(m, scale=0.02, dtype=f32),
           rnd(m, d, scale=m ** -0.5), rnd(d, scale=0.02, dtype=f32))
    return head, rnd(d, scale=0.02, dtype=f32), rnd(b, spq, d), mlp


def k6_checksum() -> str:
    """sha256 prefixes of K6's forward output and of its backward's seven
    grads (dx, dγ, dβ, dWqkv, dbqkv, dWo, dbo) at b2 spq 264, seq 257, on
    inputs made from a fixed seed on the card."""
    from vitax_torch.ops import cuda_kernels as ck
    d, heads, hd = H14_WIDTHS
    head, bo, do, _ = _half_inputs(190, 2, 264, d, 3 * heads * hd,
                                   heads * hd, 4 * d)
    tail = (1e-5, 257, heads, hd)
    with torch.no_grad():
        return _digest((ck.fused_ln_qkvo_attention_flash(*head, bo, *tail),)
                       + tuple(ck.fused_ln_qkvo_attention_flash_bwd(
                           *head, do, *tail)))


def checksums() -> dict:
    """{kernel: sha256 prefixes of its outputs} of K6 forward and backward,
    K1 forward, K2 forward, K7 backward, K3 backward, K13 forward and
    backward, the bf16 K8's forward and backward and K9's and K10's
    forward and backward (b2, 12 heads of 64, seq 197; K8 on 124 rows of
    each image in cpq 128; K9 and K10 on LN(x) of K1's x, with K1's
    weights)."""
    from vitax_torch.ops import cuda_kernels as ck
    d, heads, hd, m = B16_WIDTHS
    hhd = heads * hd
    out = {"K6 fwd+bwd": k6_checksum()}
    head, bo, do, mlp = _half_inputs(191, 2, 200, d, 3 * hhd, hhd, m)
    tail = (1e-5, 197, heads, hd)
    with torch.no_grad():
        out["K1 fwd"] = _digest((ck.fused_ln_qkvo_attention(*head, bo,
                                                            *tail),))
        out["K2 fwd"] = _digest((ck.fused_ln_mlp(*head[:3], *mlp, 1e-5),))
        out["K3 bwd"] = _digest(ck.fused_ln_qkvo_attention_int8_bwd(
            *head, do, *tail))
        kv = 4
        gqa, _, do_g, _ = _half_inputs(192, 2, 200, d, (heads + 2 * kv) * hd,
                                       hhd, m)
        out["K7 bwd"] = _digest(ck.fused_ln_qkvo_attention_gqa_bwd(
            *gqa, do_g, *tail, kv))
        rnd = _rnd(torch.Generator(device="cuda").manual_seed(193))
        q, k, v, do_c = (rnd(2, heads, 197, hd) for _ in range(4))
        o = ck.flash_attention_bhsd(q, k, v)
        out["K13 fwd+bwd"] = _digest((o,) + tuple(ck.flash_attention_bwd(
            q, k, v, o, do_c)))
        # the bf16 K8 at Res-ViT's C 0.625: 124 of each image's rows in cpq
        # 128
        xc, rect_do = _rect_inputs(head[0], 197, 124, 128)
        out["K8 fwd"] = _digest((ck.fused_ln_qkvo_attention_rect(
            xc, *head, bo, *tail),))
        out["K8 bwd"] = _digest(ck.fused_ln_qkvo_attention_rect_bwd(
            xc, *head, rect_do, *tail))
        xh = ck.layer_norm(*head[:3], 1e-5)
        out["K9 fwd"] = _digest((ck.fused_qkvo_attention(
            xh, *head[3:], bo, *tail[1:]),))
        out["K9 bwd"] = _digest(ck.fused_qkvo_attention_bwd(
            xh, *head[3:], do, *tail[1:]))
        out["K10 fwd"] = _digest((ck.fused_qkv_attention(
            xh, *head[3:5], *tail[1:]),))
        out["K10 bwd"] = _digest(ck.fused_qkv_attention_bwd(
            xh, *head[3:5], do, *tail[1:]))
    return out


def _int8_inputs(seed, b, spq, kv=None):
    """Seeded inputs of the int8 halves at ViT-B/16's widths: the attention
    half's (x, γ, β, Wqkv, bqkv, Wo) with `kv` kv heads (GQA's packed
    layout; default all), bo, do and the MLP half's (W1, b1, W2, b2)."""
    d, heads, hd, m = B16_WIDTHS
    width = (heads + 2 * (kv or heads)) * hd
    return _half_inputs(seed, b, spq, d, width, heads * hd, m)


def int8_checksums() -> dict:
    """{kernel: sha256 prefixes} of the int8 and int4 tiers' outputs (and
    of the codes each backward wrote, from its scratch) at b2 spq 200, seq
    197: the kernels redesigned for Hopper (K3's and K4's backwards), what
    their new pieces feed (the LN-quant prologue of K3's, K4's and K5's
    forwards) and the branches kept on the first design."""
    from vitax_torch.ops import cuda_kernels as ck
    _, heads, hd, _ = B16_WIDTHS
    tail = (1e-5, 197, heads, hd)
    head, bo, do, mlp = _int8_inputs(196, 2, 200)
    ln = head[:3]
    out = {}

    def scratch_digest(outs, sk):
        return _digest(tuple(outs) + tuple(
            t for key in sorted(sk) for t in sk[key]))

    with torch.no_grad():
        out["K3 fwd"] = _digest((ck.fused_ln_qkvo_attention_int8(
            *head, bo, *tail),))
        out["K4 fwd"] = _digest((ck.fused_ln_mlp_int8(*ln, *mlp, 1e-5),))
        out["K4 partial fwd"] = _digest((ck.fused_ln_mlp_int8_partial(
            *ln, *mlp, 1e-5),))
        out["K11-A fwd"] = _digest((ck.fused_ln_mlp_int4(*ln, *mlp, 1e-5),))
        out["K11-C fwd"] = _digest((ck.fused_ln_qkvo_attention_int4(
            *head, bo, *tail),))
        # K5 output by output (and the codes it wrote), so that a change
        # shows which of them moved; qkv where the checkout hands it over
        sk = {}
        r1, *pack1 = ck.fused_ln_qkvo_attention_int8_ho(
            head[0], None, None, *ln[1:], *ln[1:], *head[3:], bo, 1e-5, 197,
            heads, hd, scratch=sk)
        out["K5 attn r1"] = _digest((r1,))
        out["K5 attn xq2 sx2"] = _digest(pack1)
        out["K5 attn xq sx aq sa"] = _digest((*sk["xq"], *sk["aq"]))
        out["K5 attn qkv"] = _digest((sk["qkv"],)) if "qkv" in sk else "-"
        sk = {}
        r2, *packn = ck.fused_ln_mlp_int8_ho(r1, *pack1, *ln[1:], *mlp, 1e-5,
                                             scratch=sk)
        out["K5 mlp r2"] = _digest((r2,))
        out["K5 mlp xqn sxn"] = _digest(packn)
        out["K5 mlp h1q sh"] = _digest(sk["h1q"])
        mlp_bwd = (*ln, mlp[0], mlp[1], mlp[2], do, 1e-5)
        for name, fn, args in (
                ("K3 bwd", ck.fused_ln_qkvo_attention_int8_bwd,
                 (*head, do, *tail)),
                ("K3 dw bwd", ck.fused_ln_qkvo_attention_int8_dw_bwd,
                 (*head, do, *tail)),
                ("K4 bwd", ck.fused_ln_mlp_int8_bwd, mlp_bwd),
                ("K4 dw bwd", ck.fused_ln_mlp_int8_dw_bwd, mlp_bwd),
                ("K4 partial bwd", ck.fused_ln_mlp_int8_partial_bwd, mlp_bwd),
                ("K4 partial dw bwd", ck.fused_ln_mlp_int8_partial_dw_bwd,
                 mlp_bwd),
                ("K11-B bwd", ck.fused_ln_mlp_int4_bwd, mlp_bwd),
                ("K11-B dw bwd", ck.fused_ln_mlp_int4_dw_bwd, mlp_bwd),
                ("K11-B partial bwd", ck.fused_ln_mlp_int4_partial_bwd,
                 mlp_bwd),
                ("K11-B partial dw bwd", ck.fused_ln_mlp_int4_partial_dw_bwd,
                 mlp_bwd),
                ("K11-D bwd", ck.fused_ln_qkvo_attention_int4_bwd,
                 (*head, do, *tail)),
                ("K11-D dw bwd", ck.fused_ln_qkvo_attention_int4_dw_bwd,
                 (*head, do, *tail))):
            sk = {}
            out[name] = scratch_digest(fn(*args, scratch=sk), sk)
        # K8's int8 tier and R-B (its Hopper design at L = 7) and R-F (the
        # first design) at Res-ViT's C 0.625: 124 of each image's rows in
        # cpq 128
        xc, rect_do = _rect_inputs(head[0], 197, 124, 128)
        rect = (xc, *head)
        for name, fn in (
                ("K8 int8 fwd", ck.fused_ln_qkvo_attention_rect_int8),
                ("R-F fwd", ck.fused_ln_qkvo_attention_rect_int4)):
            sk = {}
            out[name] = scratch_digest((fn(*rect, bo, *tail, scratch=sk),),
                                       sk)
        for name, fn in (
                ("K8 int8 bwd", ck.fused_ln_qkvo_attention_rect_int8_bwd),
                ("K8 int8 dw bwd",
                 ck.fused_ln_qkvo_attention_rect_int8_dw_bwd),
                ("R-B bwd", ck.fused_ln_qkvo_attention_rect_int4_bwd),
                ("R-B dw bwd", ck.fused_ln_qkvo_attention_rect_int4_dw_bwd)):
            sk = {}
            out[name] = scratch_digest(fn(*rect, rect_do, *tail, scratch=sk),
                                       sk)
        gqa, bo_g, do_g, _ = _int8_inputs(197, 2, 200, kv=4)
        out["K7 int8 fwd"] = _digest((ck.fused_ln_qkvo_attention_int8_gqa(
            *gqa, bo_g, *tail, 4),))
        out["G-F fwd"] = _digest((ck.fused_ln_qkvo_attention_int4_gqa(
            *gqa, bo_g, *tail, 4),))
        for name, fn in (
                ("K7 int8 bwd", ck.fused_ln_qkvo_attention_int8_gqa_bwd),
                ("K7 int8 dw bwd", ck.fused_ln_qkvo_attention_int8_gqa_dw_bwd),
                ("G-B bwd", ck.fused_ln_qkvo_attention_int4_gqa_bwd),
                ("G-B dw bwd", ck.fused_ln_qkvo_attention_int4_gqa_dw_bwd)):
            sk = {}
            out[name] = scratch_digest(fn(*gqa, do_g, *tail, 4, scratch=sk),
                                       sk)
    return out


def _rect_inputs(x, seq_len, cap, cpq, seed=201):
    """K8's compacted rows of x [B, spq, D]: `cap` of each image's first
    seq_len rows in a seeded random order, zero-padded to cpq rows, and a
    seeded cotangent on them, zero on the pad rows as the caller's cut
    leaves it."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, _, d = x.shape
    idx = torch.stack([torch.randperm(seq_len, generator=g, device="cuda")
                       [:cap] for _ in range(b)])
    xc = torch.zeros((b, cpq, d), dtype=x.dtype, device="cuda")
    xc[:, :cap] = torch.gather(x, 1, idx[..., None].expand(-1, -1, d))
    do = _rnd(g)(b, cpq, d)
    do[:, cap:] = 0
    return xc, do


def _device_records(calls, reps):
    """torch.profiler's device records, in start order, of `reps` rounds
    of the closures `calls` (after one warm-up round)."""
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for fn in calls:
                fn()
        torch.cuda.synchronize()
    return sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def device_ms(calls, reps=10, tail=None) -> float:
    """Device time of one call in ms, from torch.profiler's kernel records:
    the closures `calls` (the same work on distinct inputs, so that a call
    does not find its inputs in L2) run in turn `reps` times, and each
    call's kernels are summed, from the first whose name holds `tail` on
    when it is given (a fused backward's LN tail). Every call launches the
    same kernels. The profiler may drop a record: the records are cut into
    calls from the last one back, and a call whose kernel names differ
    from the last call's is left out (at most half of them)."""
    kernels = _device_records(calls, reps)
    n = reps * len(calls)
    per = round(len(kernels) / n)
    if per == 0:
        raise RuntimeError(f"device_ms: {len(kernels)} device records for "
                           f"{n} calls")
    groups = [kernels[len(kernels) - (i + 1) * per:len(kernels) - i * per]
              for i in range(len(kernels) // per)]
    names = [e.name for e in groups[0]]
    groups = [g for g in groups if [e.name for e in g] == names]
    if len(groups) < n // 2:
        raise RuntimeError(f"device_ms: {len(groups)} of {n} calls recorded "
                           f"whole")
    if tail is not None:
        start = next(j for j, name in enumerate(names) if tail in name)
        groups = [g[start:] for g in groups]
    return sum(e.time_range.elapsed_us() for g in groups
               for e in g) / len(groups) / 1e3


def _ln_inputs(seed, n, d, dtype, copies=1):
    """`copies` seeded (x, dy) row sets [n, d] and fp32 γ, β."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    f32 = torch.float32
    gamma = 1 + 0.1 * torch.randn(d, generator=g, device="cuda", dtype=f32)
    beta = 0.1 * torch.randn(d, generator=g, device="cuda", dtype=f32)
    rows = [((torch.randn(n, d, generator=g, device="cuda") * 1.5 + 0.3)
             .to(dtype), torch.randn(n, d, generator=g, device="cuda")
             .to(dtype)) for _ in range(copies)]
    return rows, gamma, beta


# (rows, width, dtype) of the LN checksums: ViT-B/16's b64 spq 200 rows,
# a ragged fp32 set, ViT-H/14's b32 spq 264 rows, and the loop form
LN_CHECK_CASES = ((12800, 768, torch.bfloat16), (591, 768, torch.float32),
                  (8448, 1280, torch.bfloat16), (591, 2048, torch.bfloat16))


def ln_checksums() -> dict:
    """sha256 prefixes of the LN pair's outputs on seeded inputs: the
    forward, the backward's dx, and its dγ and dβ."""
    from vitax_torch.ops import cuda_kernels as ck
    fwd, dx, dgb = [], [], []
    with torch.no_grad():
        for i, (n, d, dtype) in enumerate(LN_CHECK_CASES):
            [(x, dy)], gamma, beta = _ln_inputs(195 + i, n, d, dtype)
            fwd.append(_digest((ck.layer_norm(x, gamma, beta, 1e-5),)))
            outs = ck.layer_norm_bwd(x, gamma, dy, 1e-5)
            dx.append(_digest(outs[:1]))
            dgb.append(_digest(outs[1:]))
    return {"LN fwd": " ".join(fwd), "LN bwd dx": " ".join(dx),
            "LN bwd dγ dβ": " ".join(dgb)}


def repeat_checksums() -> str:
    """K1's and K2's forwards and backwards at ViT-B/16 b8 spq 200, each run
    twice: the two digests of each agree where the kernel is
    deterministic."""
    from vitax_torch.ops import cuda_kernels as ck
    d, heads, hd, m = B16_WIDTHS
    hhd = heads * hd
    head, bo, do, mlp = _half_inputs(193, 8, 200, d, 3 * hhd, hhd, m)
    runs = []
    with torch.no_grad():
        for _ in range(2):
            runs.append("K1 fwd " + _digest((ck.fused_ln_qkvo_attention(
                *head, bo, 1e-5, 197, heads, hd),)))
        for _ in range(2):
            runs.append("K2 fwd " + _digest((ck.fused_ln_mlp(
                *head[:3], *mlp, 1e-5),)))
        for _ in range(2):
            runs.append("K1 " + _digest(ck.fused_ln_qkvo_attention_bwd(
                *head, do, 1e-5, 197, heads, hd)))
        for _ in range(2):
            runs.append("K2 " + _digest(ck.fused_ln_mlp_bwd(
                *head[:3], *mlp[:3], do, 1e-5)))
    return " | ".join(runs)


def _median_ms(fn, warmup=2, iters=10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_times() -> dict:
    """{kernel and shape: median ms} of the forwards of K1, K2 and K12 (each
    MLP half with and without its residual), K3's and K4's int8 backwards
    and forwards and K5's two halves (b32 spq 104) at ViT-B/16's widths,
    and of K6's forward (b32 spq 736 and 264) and backward (b32 spq 264) at
    ViT-H/14's."""
    from vitax_torch.ops import cuda_kernels as ck
    d, heads, hd, m = B16_WIDTHS
    hhd = heads * hd
    out = {}
    for b, spq, seq in ((64, 200, 197), (32, 200, 197), (8, 584, 577)):
        head, bo, _, mlp = _half_inputs(194, b, spq, d, 3 * hhd, hhd, m)
        mlp = (*head[:3], *mlp, 1e-5)
        calls = {"K1 fwd": lambda: ck.fused_ln_qkvo_attention(
            *head, bo, 1e-5, seq, heads, hd)}
        if spq == 200:
            calls.update({
                "K2 fwd": lambda: ck.fused_ln_mlp(*mlp),
                "K2 partial": lambda: ck.fused_ln_mlp(*mlp, residual=False),
                "K12 fwd": lambda: ck.fused_ln_mlp_save(*mlp),
                "K12 partial": lambda: ck.fused_ln_mlp_save_partial(*mlp)})
        with torch.no_grad():
            for name, fn in calls.items():
                out[f"{name} b{b} spq{spq}"] = _median_ms(fn, 3, 25)
        del head, mlp
    for b, spq, seq in ((32, 200, 197), (32, 104, 99)):
        head, _, do, mlp = _int8_inputs(198, b, spq)
        tail = (1e-5, seq, heads, hd)
        mlp_bwd = (*head[:3], mlp[0], mlp[1], mlp[2], do, 1e-5)
        calls = {
            "K3 int8 bwd": lambda: ck.fused_ln_qkvo_attention_int8_bwd(
                *head, do, *tail),
            "K3 int8_dw bwd": lambda: ck.fused_ln_qkvo_attention_int8_dw_bwd(
                *head, do, *tail),
            "K4 int8 bwd": lambda: ck.fused_ln_mlp_int8_bwd(*mlp_bwd),
            "K4 int8_dw bwd": lambda: ck.fused_ln_mlp_int8_dw_bwd(*mlp_bwd)}
        with torch.no_grad():
            for name, fn in calls.items():
                out[f"{name} b{b} spq{spq}"] = _median_ms(fn, 3, 25)
        del head, do, mlp
        torch.cuda.empty_cache()
    for b in (64, 32):
        with torch.no_grad():
            for name, fn in _int8_fwd_calls(b).items():
                out[f"{name} b{b} spq200"] = _median_ms(fn, 3, 25)
        torch.cuda.empty_cache()
    with torch.no_grad():
        for name, fn in _ho_calls(32).items():
            out[f"{name} b32 spq104"] = _median_ms(fn, 3, 25)
    torch.cuda.empty_cache()
    d, heads, hd = H14_WIDTHS
    hhd = heads * hd
    for b, spq, seq in ((32, 736, 730), (32, 264, 257)):
        head, bo, do, _ = _half_inputs(195, b, spq, d, 3 * hhd, hhd, 4 * d)
        tail = (1e-5, seq, heads, hd)
        calls = {"K6 fwd": lambda: ck.fused_ln_qkvo_attention_flash(
            *head, bo, *tail)}
        if spq == 264:
            calls["K6 bwd"] = lambda: ck.fused_ln_qkvo_attention_flash_bwd(
                *head, do, *tail)
        with torch.no_grad():
            for name, fn in calls.items():
                out[f"{name} b{b} spq{spq}"] = _median_ms(fn, 3, 25)
        del head, do
        torch.cuda.empty_cache()
    return out


def k4_outputs(tag) -> dict:
    """{"<tag> vs <other tag> <output>": (values that differ, of)} of K4's
    int8 forward against every file `k4_outputs` saved before, then this
    run's outputs saved as build/turns_k4/<tag>.pt."""
    from pathlib import Path
    from vitax_torch.ops import cuda_kernels as ck
    out = {}
    with torch.no_grad():
        for b in (32, 64):
            head, _, _, mlp = _int8_inputs(199, b, 200)
            args, sk = (*head[:3], *mlp, 1e-5), {}
            out[f"b{b} out"] = ck.fused_ln_mlp_int8(*args, scratch=sk).cpu()
            out[f"b{b} sh"] = sk["h1q"][1].cpu()
            if b == 32:
                out["b32 h1q"] = sk["h1q"][0].cpu()
                out["b32 out without the residual"] = \
                    ck.fused_ln_mlp_int8_partial(*args).cpu()
                out["b32 K12-int8 out"] = ck.fused_ln_mlp_int8_save(
                    *args)[0].cpu()
                out["b32 K11-A out"] = ck.fused_ln_mlp_int4(*args).cpu()
            del head, mlp, sk
        _, heads, hd, _ = B16_WIDTHS
        gqa, bo, _, _ = _int8_inputs(199, 32, 200, kv=4)
        out["b32 K7 int8 fwd"] = ck.fused_ln_qkvo_attention_int8_gqa(
            *gqa, bo, 1e-5, 197, heads, hd, 4).cpu()
        del gqa
    folder = Path("build/turns_k4")
    folder.mkdir(parents=True, exist_ok=True)
    diffs = {}
    for other in sorted(folder.glob("*.pt")):
        saved = torch.load(other)
        for key, t in out.items():
            if key not in saved:
                continue
            diffs[f"{tag} vs {other.stem} {key}"] = (
                int((saved[key] != t).sum()), t.numel())
    torch.save(out, folder / f"{tag}.pt")
    return diffs


def _int8_fwd_calls(b) -> dict:
    """K3's and K4's int8 forwards at ViT-B/16's b`b` spq 200, seq 197."""
    from vitax_torch.ops import cuda_kernels as ck
    _, heads, hd, _ = B16_WIDTHS
    head, bo, _, mlp = _int8_inputs(199, b, 200)
    return {"K3 int8 fwd": lambda: ck.fused_ln_qkvo_attention_int8(
                *head, bo, 1e-5, 197, heads, hd),
            "K4 int8 fwd": lambda: ck.fused_ln_mlp_int8(*head[:3], *mlp,
                                                        1e-5)}


def _by_kernel(calls, label) -> dict:
    """{name label: (device ms a call, [(kernel, ms a call, launches a
    call)], largest first)} of each closure in `calls`, from
    torch.profiler's kernel records over 5 calls."""
    reps, out = 5, {}
    with torch.no_grad():
        for name, fn in calls.items():
            per = {}
            for e in _device_records([fn], reps):
                ms, n = per.get(e.name, (0.0, 0))
                per[e.name] = (ms + e.time_range.elapsed_us() / 1e3 / reps,
                               n + 1)
            rows = sorted(((k, ms, n / reps) for k, (ms, n) in per.items()),
                          key=lambda r: -r[1])
            out[f"{name} {label}"] = (sum(r[1] for r in rows), rows)
    return out


def int8_bwd_device() -> dict:
    """`_by_kernel` of K3's and K4's int8 backwards, with and without
    int8_dw, at ViT-B/16's b32 spq 200."""
    from vitax_torch.ops import cuda_kernels as ck
    _, heads, hd, _ = B16_WIDTHS
    head, _, do, mlp = _int8_inputs(198, 32, 200)
    tail = (1e-5, 197, heads, hd)
    mlp_bwd = (*head[:3], mlp[0], mlp[1], mlp[2], do, 1e-5)
    return _by_kernel({
        "K3 int8 bwd": lambda: ck.fused_ln_qkvo_attention_int8_bwd(
            *head, do, *tail),
        "K3 int8_dw bwd": lambda: ck.fused_ln_qkvo_attention_int8_dw_bwd(
            *head, do, *tail),
        "K4 int8 bwd": lambda: ck.fused_ln_mlp_int8_bwd(*mlp_bwd),
        "K4 int8_dw bwd": lambda: ck.fused_ln_mlp_int8_dw_bwd(*mlp_bwd)},
        "b32 spq200")


def int8_fwd_device() -> dict:
    """`_by_kernel` of K3's and K4's int8 forwards at ViT-B/16's b32 and
    b64 spq 200."""
    out = {}
    for b in (32, 64):
        out.update(_by_kernel(_int8_fwd_calls(b), f"b{b} spq200"))
        torch.cuda.empty_cache()
    return out


def _ho_calls(b) -> dict:
    """K5's two halves at ViT-B/16's b`b` spq 104 (seq 99), the fast
    recipe's drop phase: a later block's attention half (its input packed)
    and the MLP half on that half's outputs."""
    from vitax_torch.ops import cuda_kernels as ck
    _, heads, hd, _ = B16_WIDTHS
    head, bo, _, mlp = _int8_inputs(200, b, 104)
    x, g1, be1 = head[:3]
    with torch.no_grad():
        xq, sx = ck.pack_rows(x, g1, be1, 1e-5)
        attn = (x, xq, sx, g1, be1, g1, be1, *head[3:], bo, 1e-5, 99, heads,
                hd)
        r1, xq2, sx2 = ck.fused_ln_qkvo_attention_int8_ho(*attn)
    return {"K5 attn": lambda: ck.fused_ln_qkvo_attention_int8_ho(*attn),
            "K5 mlp": lambda: ck.fused_ln_mlp_int8_ho(r1, xq2, sx2, g1, be1,
                                                      *mlp, 1e-5)}


# K8's int8 tier at its two training and serving geometries: (b, spq,
# seq_len, cap, cpq). Serving C 0.625 b64 and training b32 (cpq 128 of spq
# 200), and ft_resvit_fast.sh's b192 drop geometry (keep 0.5: 99 of spq 104,
# C 0.625: 62 in cpq 64)
RECT_GEOMETRIES = {"fwd": ((64, 200, 197, 124, 128), (192, 104, 99, 62, 64)),
                   "bwd": ((32, 200, 197, 124, 128), (192, 104, 99, 62, 64))}


def _rect_times(geometries, calls_of) -> dict:
    """{kernel and shape: (CUDA-event median ms of 25, device ms a call, its
    kernels)} of the closures `calls_of(kind, xc, head, bo, do, tail)`
    gives at each of `geometries` ({kind: ((b, spq, seq_len, cap, cpq),
    ...)}); the device time and kernels are `_by_kernel`'s."""
    out = {}
    for kind, shapes in geometries.items():
        for b, spq, seq, cap, cpq in shapes:
            head, bo, _, _ = _int8_inputs(202, b, spq)
            xc, do = _rect_inputs(head[0], seq, cap, cpq)
            calls = calls_of(kind, xc, head, bo, do,
                             (1e-5, seq) + B16_WIDTHS[1:3])
            label = f"b{b} cpq{cpq} spq{spq}"
            device = _by_kernel(calls, label)
            with torch.no_grad():
                for name, fn in calls.items():
                    out[f"{name} {label}"] = (_median_ms(fn, 3, 25),
                                              *device[f"{name} {label}"])
            del head, xc, do, calls
            torch.cuda.empty_cache()
    return out


def rect_int8() -> dict:
    """`_rect_times` of K8's int8 forward and of its backward with and
    without int8_dw at `RECT_GEOMETRIES`."""
    from vitax_torch.ops import cuda_kernels as ck
    fwd = ck.fused_ln_qkvo_attention_rect_int8
    bwd = ck.fused_ln_qkvo_attention_rect_int8_bwd
    dw_bwd = ck.fused_ln_qkvo_attention_rect_int8_dw_bwd
    return _rect_times(RECT_GEOMETRIES, lambda kind, xc, head, bo, do, tail: (
        {"K8 int8 fwd": lambda: fwd(xc, *head, bo, *tail)} if kind == "fwd"
        else {"K8 int8 bwd": lambda: bwd(xc, *head, do, *tail),
              "K8 int8_dw bwd": lambda: dw_bwd(xc, *head, do, *tail)}))


def gqa_int8_bwd() -> dict:
    """{K7's int8 backward, with and without int8_dw, at b`b` spq 200 with 4
    kv heads: (CUDA-event median ms of 25, `device_ms` over four input
    copies, `_by_kernel`'s device ms a call and its kernels)} at ViT-B/16's
    widths (Res-ViT training, `--n_kv_heads 4`), b64 and b32."""
    from vitax_torch.ops import cuda_kernels as ck
    _, heads, hd, _ = B16_WIDTHS
    tail = (1e-5, 197, heads, hd, 4)
    out = {}
    for b in (64, 32):
        copies = [_int8_inputs(203 + i, b, 200, kv=4) for i in range(4)]
        label = f"b{b} spq200 kv4"
        for name, fn in (("K7 int8 bwd",
                          ck.fused_ln_qkvo_attention_int8_gqa_bwd),
                         ("K7 int8_dw bwd",
                          ck.fused_ln_qkvo_attention_int8_gqa_dw_bwd)):
            calls = [lambda c=c, fn=fn: fn(*c[0], c[2], *tail)
                     for c in copies]
            with torch.no_grad():
                dev = device_ms(calls)
                ms, rows = _by_kernel({name: calls[0]}, label)[
                    f"{name} {label}"]
                out[f"{name} {label}"] = (_median_ms(calls[0], 3, 25), dev,
                                          ms, rows)
        del copies
        torch.cuda.empty_cache()
    return out


# The A4W4 attention half at chip_smoke.py's shapes (phases 13 and 14):
# (label, wrapper, batch, kv heads or None, backward)
INT4_ATTN = [("K11-C fwd", "fused_ln_qkvo_attention_int4", 32, None, False),
             ("G-F fwd", "fused_ln_qkvo_attention_int4_gqa", 64, 4, False),
             ("K11-D bwd", "fused_ln_qkvo_attention_int4_bwd", 32, None, True),
             ("K11-D dw bwd", "fused_ln_qkvo_attention_int4_dw_bwd", 32, None,
              True),
             ("G-B bwd", "fused_ln_qkvo_attention_int4_gqa_bwd", 32, 4, True),
             ("G-B dw bwd", "fused_ln_qkvo_attention_int4_gqa_dw_bwd", 32, 4,
              True)]


def int4_attn() -> dict:
    """{INT4_ATTN's label and shape: (CUDA-event median ms of 25,
    `device_ms` over four input copies, `_by_kernel`'s device ms a call and
    its kernels)} at ViT-B/16's widths, spq 200, seq 197."""
    from vitax_torch.ops import cuda_kernels as ck
    _, heads, hd, _ = B16_WIDTHS
    out = {}
    for name, wrapper, b, kv, bwd in INT4_ATTN:
        fn = getattr(ck, wrapper)
        tail = (1e-5, 197, heads, hd) + ((kv,) if kv else ())
        copies = [_int8_inputs(211 + i, b, 200, kv=kv) for i in range(4)]
        calls = [lambda c=c: fn(*c[0], c[2] if bwd else c[1], *tail)
                 for c in copies]
        label = f"b{b} spq200" + (f" kv{kv}" if kv else "")
        with torch.no_grad():
            dev = device_ms(calls)
            ms, rows = _by_kernel({name: calls[0]}, label)[f"{name} {label}"]
            out[f"{name} {label}"] = (_median_ms(calls[0], 3, 25), dev, ms,
                                      rows)
        del copies, calls
        torch.cuda.empty_cache()
    return out


# The int4_grad backwards at chip_smoke.py's shapes (phases 13 and 14), each
# beside its int8 sibling: R-B at Res-ViT training's b32 cpq 128 of spq 200
# (C 0.625), K11-B with both int8_dw branches and without the residual at
# ViT-B/16's b32 spq 200. (label, wrapper, rect)
INT4_BWD = [
    ("R-B bwd", "fused_ln_qkvo_attention_rect_int4_bwd", True),
    ("K8 int8 bwd", "fused_ln_qkvo_attention_rect_int8_bwd", True),
    ("R-B dw bwd", "fused_ln_qkvo_attention_rect_int4_dw_bwd", True),
    ("K8 int8 dw bwd", "fused_ln_qkvo_attention_rect_int8_dw_bwd", True),
    ("K11-B bwd", "fused_ln_mlp_int4_bwd", False),
    ("K4 int8 bwd", "fused_ln_mlp_int8_bwd", False),
    ("K11-B dw bwd", "fused_ln_mlp_int4_dw_bwd", False),
    ("K4 int8 dw bwd", "fused_ln_mlp_int8_dw_bwd", False),
    ("K11-B partial bwd", "fused_ln_mlp_int4_partial_bwd", False),
    ("K4 partial bwd", "fused_ln_mlp_int8_partial_bwd", False),
    ("K11-B partial dw bwd", "fused_ln_mlp_int4_partial_dw_bwd", False),
    ("K4 partial dw bwd", "fused_ln_mlp_int8_partial_dw_bwd", False)]


def int4_bwd() -> dict:
    """{INT4_BWD's label and shape: (CUDA-event median ms of 25,
    `device_ms` over four input copies, `_by_kernel`'s device ms a call and
    its kernels)} at ViT-B/16's widths, seq 197."""
    from vitax_torch.ops import cuda_kernels as ck
    _, heads, hd, _ = B16_WIDTHS
    out = {}
    for name, wrapper, rect in INT4_BWD:
        fn = getattr(ck, wrapper)
        copies = []
        for i in range(4):
            head, _, do, mlp = _int8_inputs(221 + i, 32, 200)
            if rect:
                xc, rect_do = _rect_inputs(head[0], 197, 124, 128)
                copies.append((xc, *head, rect_do, 1e-5, 197, heads, hd))
            else:
                copies.append((*head[:3], *mlp[:3], do, 1e-5))
        calls = [lambda c=c: fn(*c) for c in copies]
        label = "b32 cpq128 spq200" if rect else "b32 spq200"
        with torch.no_grad():
            dev = device_ms(calls)
            ms, rows = _by_kernel({name: calls[0]}, label)[f"{name} {label}"]
            out[f"{name} {label}"] = (_median_ms(calls[0], 3, 25), dev, ms,
                                      rows)
        del copies, calls
        torch.cuda.empty_cache()
    return out


# K9's forward at serving's b64 and its backward at training's b32, each
# beside K1's at the same shape: (label, batch, backward)
K9_TIMES = [("K9 fwd", 64, False), ("K1 fwd", 64, False),
            ("K9 bwd", 32, True), ("K1 bwd", 32, True)]


def _k9_call(label, bwd, head, bo, do):
    """One call of K9 or K10 (on x̂ = LN(x)) or K1 (on x) at ViT-B/16's
    widths, spq 200, seq 197 (K10's dO [b, spq, H·Hd] is K1's dY: D =
    H·Hd)."""
    from vitax_torch.ops import cuda_kernels as ck
    _, heads, hd, _ = B16_WIDTHS
    tail = (197, heads, hd)
    if label.startswith("K1 "):
        if bwd:
            return lambda: ck.fused_ln_qkvo_attention_bwd(*head, do, 1e-5,
                                                          *tail)
        return lambda: ck.fused_ln_qkvo_attention(*head, bo, 1e-5, *tail)
    xh = ck.layer_norm(*head[:3], 1e-5)
    if label.startswith("K10"):
        if bwd:
            return lambda: ck.fused_qkv_attention_bwd(xh, *head[3:5], do,
                                                      *tail)
        return lambda: ck.fused_qkv_attention(xh, *head[3:5], *tail)
    if bwd:
        return lambda: ck.fused_qkvo_attention_bwd(xh, *head[3:], do, *tail)
    return lambda: ck.fused_qkvo_attention(xh, *head[3:], bo, *tail)


# K10's forward at serving's b64 and its backward at training's b32, each
# beside K9's and K1's at the same shape: (label, batch, backward)
K10_TIMES = [("K10 fwd", 64, False), ("K9 fwd", 64, False),
             ("K1 fwd", 64, False), ("K10 bwd", 32, True),
             ("K9 bwd", 32, True), ("K1 bwd", 32, True)]


def k9(times=K9_TIMES) -> dict:
    """{`times`' label and shape: (CUDA-event median ms of 25,
    `device_ms` over four input copies)}."""
    d, heads, hd, m = B16_WIDTHS
    hhd = heads * hd
    out = {}
    for label, b, bwd in times:
        with torch.no_grad():
            calls = [_k9_call(label, bwd, head, bo, do) for head, bo, do, _ in
                     (_half_inputs(221 + i, b, 200, d, 3 * hhd, hhd, m)
                      for i in range(4))]
            dev = device_ms(calls)
            out[f"{label} b{b} spq200"] = (_median_ms(calls[0], 3, 25), dev)
        del calls
        torch.cuda.empty_cache()
    return out


# The bf16 K8 at Res-ViT's serving geometries, b64 C 0.625 (cpq 128 of spq
# 200) and C 0.5 (99 rows, cpq 104), and its backward at training's b32
# C 0.625: (b, spq, seq_len, cap, cpq)
RECT_BF16_GEOMETRIES = {"fwd": ((64, 200, 197, 124, 128),
                                (64, 200, 197, 99, 104)),
                        "bwd": ((32, 200, 197, 124, 128),)}


def rect_bf16() -> dict:
    """`_rect_times` of the bf16 K8's forward and backward at
    `RECT_BF16_GEOMETRIES`."""
    from vitax_torch.ops import cuda_kernels as ck
    fwd = ck.fused_ln_qkvo_attention_rect
    bwd = ck.fused_ln_qkvo_attention_rect_bwd
    return _rect_times(
        RECT_BF16_GEOMETRIES, lambda kind, xc, head, bo, do, tail: (
            {"K8 fwd": lambda: fwd(xc, *head, bo, *tail)} if kind == "fwd"
            else {"K8 bwd": lambda: bwd(xc, *head, do, *tail)}))


def rect_steps() -> dict:
    """{what: CUDA-event median ms} of the Res-ViT paths that run K8: the
    compacted serving forward at b64 in bf16 and with `--int8` (phase 8),
    the compacted bf16 step at b32 (phase 9 (b) past its warmup:
    `--compact-capacity 0.625`) and ft_resvit_fast.sh's step past its dense
    warmup (phase 9 (c): b192, `--int8-dw --compact-capacity 0.625
    --token-keep 0.5`), each step teacher and student forward, backward,
    AdamW, on profile_resvit's model (its recipe, the routers' biases
    randomized) and resident random images."""
    from vitax_torch.core.prng import set_seed
    from vitax_torch.models import resvit
    from vitax_torch.resvit_eval_cli import get_eval_config
    from vitax_torch.resvit_train_cli import config_to_model_args
    from vitax_torch.scripts import profile_resvit as pr
    from vitax_torch.train.resvit_steps import (Lambdas, create_state,
                                                make_adamw_for,
                                                make_train_step)
    cfg = config_to_model_args(get_eval_config(pr.RECIPE), "cuda")
    params = resvit.init_params(set_seed(0), cfg, "cuda")
    pr.randomize_router_biases(params)
    g = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    images = torch.randn((64, 224, 224, 3), generator=g, device="cuda",
                         dtype=torch.bfloat16)
    compact = cfg.replace(compact_capacity=0.625)
    int8 = compact.replace(int8_attn=True, int8_mlp=True, fused_mlp=True)
    with torch.inference_mode():
        for name, c in (("bf16", compact), ("--int8", int8)):
            out[f"Res-ViT compacted {name} forward b64"] = _median_ms(
                lambda c=c: resvit.apply(params, images, c))
    for label, config in (("(b)", "train-compact"), ("(c)", "train-fast")):
        batch, over = pr.TRAIN_CONFIGS[config]
        c = cfg.replace(**over)
        images = torch.randn((batch, 224, 224, 3), generator=g,
                             device="cuda", dtype=torch.bfloat16)
        labels = torch.randint(0, 10, (batch,), generator=g, device="cuda")
        tx = make_adamw_for(c, params, lambda s: 1e-4)
        state = create_state(params, tx,
                             torch.Generator(device="cuda").manual_seed(2))
        step = make_train_step(c, tx, Lambdas(1.0, 10.0, 1.0))
        out[f"Res-ViT {label} step b{batch}"] = _median_ms(
            lambda: step(state, images, labels))
        del state, tx, step
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return out


def ho_device() -> dict:
    """`_by_kernel` of K5's two halves at the drop phase's b32 spq 104 and
    at the fast recipe's b768 spq 104 (79872 rows)."""
    out = {}
    for b in (32, 768):
        out.update(_by_kernel(_ho_calls(b), f"b{b} spq104"))
        torch.cuda.empty_cache()
    return out


HBM_BYTES_PER_MS = 3.35e9  # the H100 SXM's 3.35 TB/s


def ln_device_times() -> dict:
    """{case: (device ms, bound ms)} of the LN pair, their library calls
    and the fused backwards' LN tails at ViT-B/16's widths, and of
    colsum.cuh's final pass a launch (bound: None)."""
    import torch.nn.functional as F
    from vitax_torch.ops import cuda_kernels as ck
    d, heads, hd, m = B16_WIDTHS
    eps, bf = 1e-5, torch.bfloat16
    out = {}
    for b in (64, 32):
        n = b * 200
        rows, gamma, beta = _ln_inputs(196, n, d, bf, copies=4)
        g, be = gamma.to(bf), beta.to(bf)
        bound = 2 * 2 * n * d / HBM_BYTES_PER_MS
        with torch.no_grad():
            out[f"LN fwd b{b}"] = (device_ms(
                [lambda x=x: ck.layer_norm(x, gamma, beta, eps)
                 for x, _ in rows]), bound)
            out[f"F.layer_norm b{b}"] = (device_ms(
                [lambda x=x: F.layer_norm(x, (d,), g, be, eps)
                 for x, _ in rows]), bound)
        if b == 32:
            with torch.no_grad():
                out["LN bwd b32 bf16"] = (device_ms(
                    [lambda x=x, dy=dy: ck.layer_norm_bwd(x, gamma, dy, eps)
                     for x, dy in rows]), 3 * 2 * n * d / HBM_BYTES_PER_MS)
            grads = []
            for x, dy in rows:
                xr = x.detach().requires_grad_()
                gr = g.detach().requires_grad_()
                br = be.detach().requires_grad_()
                y = F.layer_norm(xr, (d,), gr, br, eps)
                grads.append(lambda y=y, xr=xr, gr=gr, br=br, dy=dy:
                             torch.autograd.grad(y, (xr, gr, br), dy,
                                                 retain_graph=True))
            out["autograd F.layer_norm b32"] = (
                device_ms(grads), 3 * 2 * n * d / HBM_BYTES_PER_MS)
        del rows
    # the fused tails: x bf16, dy fp32 (the dx product's output), dx bf16,
    # and K2's residual R bf16
    n = 32 * 200
    calls_k1, calls_k2 = [], []
    for i in range(4):
        head, bo, do, mlp = _half_inputs(197 + i, 32, 200, d, 3 * heads * hd,
                                         heads * hd, m)
        calls_k1.append(lambda h=head, do=do: ck.fused_ln_qkvo_attention_bwd(
            *h, do, 1e-5, 197, heads, hd))
        calls_k2.append(lambda h=head, do=do, w=mlp: ck.fused_ln_mlp_bwd(
            *h[:3], *w[:3], do, 1e-5))
    with torch.no_grad():
        out["LN tail fp32 dy b32 (K1 bwd)"] = (
            device_ms(calls_k1, reps=5, tail="layer_norm_bwd"),
            8 * n * d / HBM_BYTES_PER_MS)
        out["LN tail fp32 dy + R b32 (K2 bwd)"] = (
            device_ms(calls_k2, reps=5, tail="layer_norm_bwd"),
            10 * n * d / HBM_BYTES_PER_MS)
        out["colsum final a launch (K2 bwd b32)"] = (
            _kernel_ms_per_launch(calls_k2, "colsum_final"), None)
    return out


def _kernel_ms_per_launch(calls, name, reps=5) -> float:
    """Mean device time of one launch of the kernels whose name holds
    `name` over `reps` rounds of `calls`."""
    hits = [e.time_range.elapsed_us() for e in _device_records(calls, reps)
            if name in e.name]
    if not hits:
        raise RuntimeError(f"no device record holds {name!r}")
    return sum(hits) / len(hits) / 1e3

def _images(image, batch, split="train"):
    from vitax_torch.data import get_dataloader
    data = next(iter(get_dataloader(
        "Synthetic", split=split, image_size=image, batch_size=batch,
        num_samples=2 * batch, seed=0)))
    return (torch.from_numpy(data.images).cuda().bfloat16(),
            torch.from_numpy(data.labels).cuda())


def _vit_step_ms(arch, image, batch, iters=10, **flags) -> tuple:
    """(median ms, peak device memory in MB) of a ViT train step (token
    drop: `token_keep` < 1, as the fast recipe's drop phase)."""
    from vitax_torch.core.config import arch_config
    from vitax_torch.core.prng import set_seed
    from vitax_torch.models import vit
    from vitax_torch.train import (create_train_state, make_train_step,
                                   param_leaves, sgd_momentum)
    cfg = arch_config(arch, image_size=image, num_classes=10,
                      dtype=torch.bfloat16, **flags)
    params = vit.init_params(set_seed(0), cfg, "cuda")
    images, labels = _images(image, batch)
    for p in param_leaves(params):
        p.requires_grad_(True)
    opt, sched = sgd_momentum(params, 0.03, 1000, 0.1)
    state = create_train_state(params, opt, sched, torch.Generator())
    step = make_train_step(cfg, opt, sched)
    step(state, images, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = _median_ms(lambda: step(state, images, labels), iters=iters)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    del state, params, opt
    torch.cuda.empty_cache()
    return ms, peak


def _vit_forward_ms(image, batch, arch="b16", **flags) -> float:
    from vitax_torch.core.config import arch_config
    from vitax_torch.core.prng import set_seed
    from vitax_torch.models import vit
    cfg = arch_config(arch, image_size=image, num_classes=10,
                      dtype=torch.bfloat16, **flags)
    params = vit.init_params(set_seed(0), cfg, "cuda")
    images, _ = _images(image, batch, "val")
    with torch.inference_mode():
        ms = _median_ms(lambda: vit.apply(params, images, cfg))
    del params
    torch.cuda.empty_cache()
    return ms


def _resvit_step_ms(batch=32) -> float:
    """ft_resvit.sh's (a) step: teacher and student forward, backward,
    AdamW (λc, λa, λd 1, 10, 1)."""
    from vitax_torch.core.prng import set_seed
    from vitax_torch.models import resvit
    from vitax_torch.resvit_train_cli import (config_to_model_args,
                                              get_train_config)
    from vitax_torch.train.optim import param_leaves, tree_leaves
    from vitax_torch.train.resvit_steps import (Lambdas, create_state,
                                                make_adamw_for,
                                                make_train_step)
    cfg = config_to_model_args(get_train_config(
        RESVIT_FLAGS + ["--exp-root", "build/turns"]), "cuda")
    params = resvit.init_params(set_seed(0), cfg, "cuda")
    for t, m in zip(param_leaves(params), tree_leaves(
            resvit.trainable_mask(params, cfg))):
        t.requires_grad_(m)
    images, labels = _images(224, batch)
    tx = make_adamw_for(cfg, params, lambda s: 1e-4)
    state = create_state(params, tx,
                         torch.Generator(device="cuda").manual_seed(3))
    step = make_train_step(cfg, tx, Lambdas(1.0, 10.0, 1.0))
    ms = _median_ms(lambda: step(state, images, labels))
    del state, params, tx
    torch.cuda.empty_cache()
    return ms


def timings() -> dict:
    fused = dict(fused_qkv=True, fused_mlp=True)
    int8 = dict(int8_mlp=True, int8_attn=True)
    out = {}
    ms, peak = _vit_step_ms("b16", 224, 32, **fused)
    out["B/16 step b32 bf16"] = ms
    out["B/16 step b32 bf16 peak MB"] = peak
    out["B/16 step b32 --int8"] = _vit_step_ms("b16", 224, 32, **fused,
                                               **int8)[0]
    out["B/16 step b32 --int8-grad"] = _vit_step_ms(
        "b16", 224, 32, **fused, **int8, int8_mlp_grad=True,
        int8_attn_grad=True)[0]
    int8_dw = dict(**int8, int8_mlp_grad=True, int8_attn_grad=True,
                   int8_dw=True)
    out["B/16 step b32 --int8-dw"] = _vit_step_ms("b16", 224, 32, **fused,
                                                  **int8_dw)[0]
    out["fast recipe step b192 dense --int8-dw"] = _vit_step_ms(
        "b16", 224, 192, **fused, **int8_dw)[0]
    out["fast recipe step b768 keep 0.5 --int8-dw"] = _vit_step_ms(
        "b16", 224, 768, iters=5, **fused, **int8_dw, token_keep=0.5)[0]
    out["B/16 step b32 --save-acts"] = _vit_step_ms(
        "b16", 224, 32, **fused, fused_mlp_save=True)[0]
    out["B/16 forward b64 bf16"] = _vit_forward_ms(224, 64, **fused)
    out["B/16 forward b64 bf16 @384"] = _vit_forward_ms(384, 64, **fused)
    out["B/16 forward b64 --int8"] = _vit_forward_ms(224, 64, **fused,
                                                     **int8)
    out["B/16 --no-fused-qkv forward b64 @384"] = _vit_forward_ms(
        384, 64, fused_qkv=False, fused_mlp=True)
    out["B/16 --no-fused-qkv step b32"] = _vit_step_ms(
        "b16", 224, 32, fused_qkv=False, fused_mlp=True)[0]
    out["Res-ViT (a) step b32"] = _resvit_step_ms()
    ms, peak = _vit_step_ms("h14", 224, 32, **fused)
    out["H/14 step b32 @224"] = ms
    out["H/14 step b32 @224 peak MB"] = peak
    out["H/14 forward b32 @384"] = _vit_forward_ms(384, 32, "h14", **fused)
    out["L/16 forward b32 @384"] = _vit_forward_ms(384, 32, "l16", **fused)
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("turns: needs a CUDA card")
    tag = argv[0] if argv else "run"
    import vitax_torch
    from vitax_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    build.load()
    print(f"{tag}: {vitax_torch.__file__} on "
          f"{smi.stdout.strip().splitlines()[0]}", flush=True)
    sections = set(argv[1:]) or set(SECTIONS)
    for section in SECTIONS:
        if section not in sections:
            continue
        if section in ("checksums", "int8_checksums", "ln_checksums"):
            for name, digest in globals()[section]().items():
                print(f"{tag}: checksum {name}: {digest}", flush=True)
        elif section == "repeat_checksums":
            print(f"{tag}: two runs of each: {repeat_checksums()}",
                  flush=True)
        elif section == "ln_device_times":
            for name, (ms, bound) in ln_device_times().items():
                print(f"{tag}: device {name} {ms:.4f} ms" + (
                    "" if bound is None else
                    f" (bound {bound:.4f}, x{ms / bound:.2f})"), flush=True)
        elif section == "k4_outputs":
            for name, (n, of) in k4_outputs(tag).items():
                print(f"{tag}: {name}: {n} of {of} values differ",
                      flush=True)
        elif section in ("int8_bwd_device", "int8_fwd_device", "ho_device"):
            for name, (ms, rows) in globals()[section]().items():
                print(f"{tag}: device {name} {ms:.4f} ms: " + "; ".join(
                    f"{k[:70]} {t:.4f} x{n:g}" for k, t, n in rows),
                    flush=True)
        elif section in ("rect_int8", "rect_bf16"):
            for name, (ms, dev, rows) in globals()[section]().items():
                print(f"{tag}: {name} {ms:.4f} ms, device {dev:.4f} ms: "
                      + "; ".join(f"{k[:70]} {t:.4f} x{n:g}"
                                  for k, t, n in rows), flush=True)
        elif section in ("gqa_int8_bwd", "int4_attn", "int4_bwd"):
            for name, (ms, dev, by, rows) in globals()[section]().items():
                print(f"{tag}: {name} {ms:.4f} ms, device {dev:.4f} ms "
                      f"(device_ms), {by:.4f} ms (_by_kernel): " + "; ".join(
                          f"{k[:70]} {t:.4f} x{n:g}" for k, t, n in rows),
                      flush=True)
        elif section in ("k9", "k10"):
            times = K9_TIMES if section == "k9" else K10_TIMES
            for name, (ms, dev) in k9(times).items():
                print(f"{tag}: {name} {ms:.4f} ms, device {dev:.4f} ms",
                      flush=True)
        elif section in ("timings", "rect_steps"):
            for name, value in globals()[section]().items():
                print(f"{tag}: {name} {value:.3f}"
                      + ("" if "MB" in name else " ms"), flush=True)
        else:
            for name, value in kernel_times().items():
                print(f"{tag}: {name} {value:.4f} ms", flush=True)
    return 0


SECTIONS = ("checksums", "int8_checksums", "ln_checksums", "repeat_checksums",
            "ln_device_times", "timings", "kernel_times", "k4_outputs",
            "int8_bwd_device", "int8_fwd_device", "ho_device", "rect_int8",
            "rect_bf16", "rect_steps", "gqa_int8_bwd", "int4_attn",
            "int4_bwd", "k9", "k10")


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
