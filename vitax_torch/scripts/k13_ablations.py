"""What holds K13's forward back on one CUDA card: the kernel as it is and
with one piece taken out at a time, timed in turns.

    python -m vitax_torch.scripts.k13_ablations

Each ablation is a text edit of a copy of `csrc/attention_core.cuh` (the
port's own library is not touched), built with the port's nvcc flags into
`build/vitax_torch_kernels/k13_ablations/` (git-ignored):

- `base`: the kernel as it is (its output is held against the twin);
- `no_exp`: ex2 returns its argument (no special-function unit work);
- `pass2_only`: the statistics pass skipped (pass 2 alone);
- `no_copies`: the ring's cp.async copies skipped after the first tiles;
- `one_wg`: one warpgroup a block, so no two query tiles share a K/V tile;
- `no_barrier`: the ring's block barrier taken out.

The ablations compute wrong outputs by design; they exist to be timed. The
times are K13's forward at ViT-B/16's b64 seq 577 (eval_cli at 384 px) and
b32 seq 197 (train_cli) and ViT-H/14's b8 seq 730 (head_dim 80): CUDA
events around 50 back-to-back launches, two rounds, the second in reverse
order, each variant's lower time printed with its change against `base`.
An edit whose anchor is missing from the source raises: update the anchor
with the kernel.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import torch

from vitax_torch.kernels import build
from vitax_torch.ops import cuda_kernels as ck

SYNC = ("    __syncthreads();  // tile `step` has landed; tile step − 2's "
        "buffers are free\n")
ABLATIONS = {
    "base": [],
    "no_exp": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                "y = x;")],
    "pass2_only": [
        ("  for (int step = 0; step < kS - 2; ++step) issue(step);",
         "  for (int step = 0; step < kS - 2; ++step) "
         "issue((kRowPass ? 0 : nt) + step);"),
        ("  for (int step = 0; step < steps; ++step) {",
         "  for (int step = kRowPass ? 0 : nt; step < steps; ++step) {")],
    "no_copies": [("    if (step < steps) {\n      const int kt",
                   "    if (step < kS - 2) {\n      const int kt")],
    "one_wg": [("constexpr int kRowWgs = 2;", "constexpr int kRowWgs = 1;")],
    "no_barrier": [(SYNC, "")],
}
# (batch, seq, heads, head_dim)
SHAPES = [(64, 577, 12, 64), (32, 197, 12, 64), (8, 730, 16, 80)]


def build_variants() -> dict:
    """name -> the variant's vitax_attention_core_fwd (ctypes)."""
    root = build.BUILD_DIR / "k13_ablations"
    header = (build.CSRC / "attention_core.cuh").read_text()
    nvcc = build._nvcc()
    procs = {}
    for name, edits in ABLATIONS.items():
        text = header
        for anchor, new in edits:
            if anchor not in text:
                raise RuntimeError(f"{name}: anchor not in attention_core.cuh:"
                                   f" {anchor!r}")
            text = text.replace(anchor, new)
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "attention_core.cuh").write_text(text)
        for src in ("common.cuh", "attention_core.cu"):
            shutil.copy(build.CSRC / src, d / src)
        cmd = [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "attention_core.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out[-3000:]}")
        fn = ctypes.CDLL(str(root / name / "lib.so")).vitax_attention_core_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _batch_ms(fn, launches: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k13_ablations: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = build_variants()
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(0)
    for b, s, h, hd in SHAPES:
        q, k, v = (torch.randn((b, s, h, hd), generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        out = torch.empty_like(q)
        calls = {name: (lambda f=fn: build.check(f(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            h, hd, hd ** -0.5, stream), "k13 ablation")) for name, fn in
            fns.items()}
        calls["base"]()
        torch.cuda.synchronize()
        ref = ck.flash_attention_bhsd_ref(
            *(t.transpose(1, 2) for t in (q, k, v))).transpose(1, 2)
        err = (out.float() - ref.float()).abs().max().item()
        if err > 2e-2 * max(1.0, ref.float().abs().max().item()):
            raise AssertionError(f"base at b{b} seq {s}: max error {err}")
        order = list(calls)
        times = {}
        for name in order + order[::-1]:
            times[name] = min(times.get(name, float("inf")),
                              _batch_ms(calls[name]))
        base = times["base"]
        print(f"b{b} seq {s} head_dim {hd} (base max|k-ref| {err:.2e}): "
              + ", ".join(f"{n} {t:.4f} ms ({100 * (t / base - 1):+.1f} %)"
                          for n, t in times.items()), flush=True)
        del q, k, v, out, ref
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
