#!/usr/bin/env python3
"""Bring-up check of the vitax_torch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises (non-zero exit):

1. device  — needs torch.cuda; prints the card's name and power limit
             (nvidia-smi) and turns TF32 off for the plain versions;
2. build   — compiles vitax_torch/csrc/*.cu with nvcc and loads the library;
3. kernels — each hand-written kernel against its plain PyTorch version on the
             card, in bf16, at the ViT-B/16 shapes of the serving path
             (batch 64 at spq 200, as eval_cli gives them), batch 8 at spq 200
             and 584, and a ragged row count; max error against the stated
             tolerance, then median CUDA-event times of kernel and plain;
4. slice   — `vitax_torch.eval_cli` at b16@224 bf16 on Synthetic data with
             random weights from --seed, with the launch counters set to 0
             just before and read just after (each kernel must have run, per
             layer for K1/K2 and once per forward for LN); then the same run
             on the plain path (no kernel may launch); then one batch through
             vit.apply with kernels, plain bf16 and plain fp32, with the
             kernel-vs-plain logit difference held to a stated bf16 band.

The line before the last is the JSON kernel table; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 2 and prints
no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time

# kernel -> (C++ source, TPU kernel it replaces)
KERNEL_INFO = {
    "layer_norm": ("vitax_torch/csrc/layernorm.cu",
                   "vitax/ops/pallas_kernels.py:267"),
    "fused_ln_qkvo_attention": ("vitax_torch/csrc/ln_qkvo_attention.cu",
                                "vitax/ops/pallas_kernels.py:2640"),
    "fused_ln_mlp": ("vitax_torch/csrc/ln_mlp.cu",
                     "vitax/ops/pallas_kernels.py:587"),
}

D, HEADS, HEAD_DIM, MLP = 768, 12, 64, 3072      # ViT-B/16
EPS = 1e-5
# kernel vs plain: |k - ref| <= TOL * max(1, max|ref|). bf16 keeps 8 bits
# (ulp 2^-8 relative); both sides round at the same points, so what is left
# is one-ulp flips from sums taken in another order.
TOL = 2e-2
# whole-model logits, kernel path vs plain bf16 path: 12 layers of such
# flips in the residual stream, then the final LN and the head.
LOGIT_BAND = 5e-2
EVAL_ARGS = ["--model-arch", "b16", "--image-size", "224",
             "--dataset", "Synthetic", "--synthetic-samples", "256",
             "--batch-size", "64", "--num-classes", "10", "--seed", "0"]
PLAIN_FLAGS = ["--no-pallas", "--no-fused-qkv", "--no-fused-mlp"]

# (label, batch, rows per image, seq_len); the first is the serving path's
CASES = [("b64 spq200 (eval_cli)", 64, 200, 197),
         ("b8 spq200", 8, 200, 197),
         ("b8 spq584", 8, 584, 577),
         ("ragged", 3, 200, 197)]


def _median_ms(fn, warmup=3, iters=25):
    import torch
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


def _inputs(batch, rows, seed):
    """bf16 activations and ViT-B/16-scaled weights made on the card."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf, f32 = torch.bfloat16, torch.float32

    def rnd(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)

    hhd = HEADS * HEAD_DIM
    return dict(
        x=rnd(batch, rows, D),
        gamma=1.0 + rnd(D, scale=0.1, dtype=f32),
        beta=rnd(D, scale=0.1, dtype=f32),
        wqkv=rnd(D, 3 * hhd, scale=D ** -0.5),
        bqkv=rnd(3 * hhd, scale=0.02, dtype=f32),
        wo=rnd(hhd, D, scale=hhd ** -0.5),
        bo=rnd(D, scale=0.02, dtype=f32),
        w1=rnd(D, MLP, scale=D ** -0.5),
        b1=rnd(MLP, scale=0.02, dtype=f32),
        w2=rnd(MLP, D, scale=MLP ** -0.5),
        b2=rnd(D, scale=0.02, dtype=f32),
    )


def _calls(ck, t, seq_len):
    """kernel name -> (kernel call, plain call) on inputs t."""
    ln = (t["x"], t["gamma"], t["beta"], EPS)
    qkvo = (t["x"], t["gamma"], t["beta"], t["wqkv"], t["bqkv"], t["wo"],
            t["bo"], EPS, seq_len, HEADS, HEAD_DIM)
    mlp = (t["x"], t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"], t["b2"],
           EPS)
    return {
        "layer_norm": (lambda: ck.layer_norm(*ln),
                       lambda: ck.layer_norm_ref(*ln)),
        "fused_ln_qkvo_attention": (
            lambda: ck.fused_ln_qkvo_attention(*qkvo),
            lambda: ck.fused_ln_qkvo_attention_ref(*qkvo)),
        "fused_ln_mlp": (lambda: ck.fused_ln_mlp(*mlp),
                         lambda: ck.fused_ln_mlp_ref(*mlp)),
    }


def check_kernels():
    """Phase 3: every kernel against its plain version; returns per-kernel
    {max_abs_err, ms, plain_ms} (times at the serving-path case)."""
    import torch
    from vitax_torch.ops import cuda_kernels as ck
    stats = {name: {"max_abs_err": 0.0} for name in KERNEL_INFO}
    for i, (label, batch, rows, seq_len) in enumerate(CASES):
        t = _inputs(batch, rows, seed=i)
        for name, (kern, plain) in _calls(ck, t, seq_len).items():
            if label == "ragged" and name != "fused_ln_qkvo_attention":
                # rows not a multiple of 8 per image: 3*197 = 591 rows
                t_r = dict(t, x=t["x"][:, :seq_len].contiguous())
                kern, plain = _calls(ck, t_r, seq_len)[name]
            with torch.inference_mode():
                out = kern()
                torch.cuda.synchronize()
                ref = plain()
            err = (out.float() - ref.float()).abs().max().item()
            bound = TOL * max(1.0, ref.float().abs().max().item())
            finite = bool(torch.isfinite(out).all())
            print(f"  {name:24s} {label:22s} {tuple(out.shape)} "
                  f"max|k-ref| {err:.3e} <= {bound:.3e}: "
                  f"{'ok' if err <= bound and finite else 'FAIL'}", flush=True)
            if not (finite and err <= bound):
                raise AssertionError(f"{name} {label}: max error {err} "
                                     f"exceeds {bound} (finite={finite})")
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            if i <= 2:
                with torch.inference_mode():
                    k_ms, p_ms = _median_ms(kern), _median_ms(plain)
                print(f"  {name:24s} {label:22s} kernel {k_ms:.4f} ms  "
                      f"plain {p_ms:.4f} ms (median of 25)", flush=True)
                if i == 0:
                    stats[name].update(ms=k_ms, plain_ms=p_ms)
        del t
        torch.cuda.empty_cache()
    return stats


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def _run_eval(args):
    from vitax_torch import eval_cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        result = eval_cli.main(args)
    m = re.search(r"\((\d+) images in ([\d.]+)s, (\d+) img/s\)",
                  buf.getvalue())
    if m is None:
        raise AssertionError("eval_cli printed no img/s line")
    for k in ("loss", "acc1", "acc5"):
        if not math.isfinite(result[k]):
            raise AssertionError(f"eval metric {k} = {result[k]}")
    return result, int(m.group(1)), float(m.group(3))


def run_slice():
    """Phase 4: the serving path through eval_cli, kernels then plain."""
    import torch
    from vitax_torch.core.config import arch_config
    from vitax_torch.core.prng import set_seed
    from vitax_torch.data import get_dataloader
    from vitax_torch.models import vit
    from vitax_torch.ops import cuda_kernels as ck

    ck.reset_launch_counts()
    result, n_img, rate = _run_eval(EVAL_ARGS)
    counts = ck.launch_counts()
    batches = math.ceil(256 / 64)
    expect = {"layer_norm": batches, "fused_ln_qkvo_attention": 12 * batches,
              "fused_ln_mlp": 12 * batches}
    print(f"slice: eval_cli kernels {result} {n_img} images {rate:.0f} img/s "
          f"launches {counts}", flush=True)
    if n_img != 256 or counts != expect:
        raise AssertionError(f"expected 256 images and launches {expect}")

    ck.reset_launch_counts()
    result_p, _, rate_p = _run_eval(EVAL_ARGS + PLAIN_FLAGS)
    print(f"slice: eval_cli plain {result_p} {rate_p:.0f} img/s "
          f"launches {ck.launch_counts()}", flush=True)
    if any(ck.launch_counts().values()):
        raise AssertionError("the plain path launched a kernel")

    cfg = arch_config("b16", image_size=224, num_classes=10,
                      dtype=torch.bfloat16, fused_qkv=True, fused_mlp=True)
    params = vit.init_params(set_seed(0), cfg, "cuda")
    batch = next(iter(get_dataloader("Synthetic", split="val", image_size=224,
                                     batch_size=64, num_samples=256, seed=0)))
    images = torch.from_numpy(batch.images).cuda()
    with torch.inference_mode():
        lk = vit.apply(params, images.bfloat16(), cfg)
        lp = vit.apply(params, images.bfloat16(),
                       cfg.replace(fused_qkv=False, fused_mlp=False,
                                   use_pallas=False))
        l32 = vit.apply(params, images,
                        cfg.replace(fused_qkv=False, fused_mlp=False,
                                    use_pallas=False, dtype=torch.float32))
    diff = (lk - lp).abs().max().item()
    band = LOGIT_BAND * max(1.0, lp.abs().max().item())
    print(f"slice: logits {tuple(lk.shape)} max|kernel-plain_bf16| {diff:.3e}"
          f" <= {band:.3e}; max|kernel-fp32| {(lk - l32).abs().max().item():.3e}"
          f" max|plain_bf16-fp32| {(lp - l32).abs().max().item():.3e}"
          f" max|fp32| {l32.abs().max().item():.3e}", flush=True)
    if not (torch.isfinite(lk).all() and diff <= band):
        raise AssertionError("kernel-path logits outside the bf16 band")

    # device-timed forward on a resident batch: eval_cli's rate over four
    # batches also counts the host loader
    plain = cfg.replace(fused_qkv=False, fused_mlp=False, use_pallas=False)
    with torch.inference_mode():
        images = images.bfloat16()
        fwd = {name: _median_ms(lambda c=c: vit.apply(params, images, c),
                                warmup=2, iters=10)
               for name, c in (("kernels", cfg), ("plain", plain))}
    print("slice: forward b64 (median of 10, CUDA events): " + ", ".join(
        f"{k} {ms:.2f} ms = {64e3 / ms:.0f} img/s" for k, ms in fwd.items()),
        flush=True)
    return counts, rate, rate_p


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"device: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from vitax_torch.kernels import build
    t0 = time.time()
    fresh = not build.library_path().exists()
    build.load()
    print(f"build: {time.time() - t0:.1f} s ({'fresh' if fresh else 'cached'}"
          f") -> {build.library_path()}", flush=True)

    print("kernels vs plain (bf16):", flush=True)
    stats = check_kernels()
    counts, rate, rate_p = run_slice()
    print(f"eval img/s b16@224 bf16: kernels {rate:.0f}, plain {rate_p:.0f} "
          f"[{card}]", flush=True)

    table = [dict(name=name, route="cuda", source=src, replaces=rep,
                  launches=counts[name], **stats[name])
             for name, (src, rep) in KERNEL_INFO.items()]
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
