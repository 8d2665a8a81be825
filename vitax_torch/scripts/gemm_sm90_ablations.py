"""What holds `csrc/gemm_sm90.cuh` back on one CUDA card: the products of
K1's and K2's backwards at ViT-B/16's b32 shapes and of their forwards at
b32 and b64, each with the GEMM as it is and with one piece taken out at a
time, timed in turns.

    python -m vitax_torch.scripts.gemm_sm90_ablations

Each ablation is a text edit of a copy of `csrc/gemm_sm90.cuh` (the port's
own library is not touched), built with the port's nvcc flags together
with `csrc/gemm_sm90.cu` into `build/vitax_torch_kernels/gemm_sm90_ablations/`
(git-ignored):

- `base`: the GEMM as it is (its output is held against an fp32
  `torch.matmul` of the same bf16 inputs);
- `no_loads`: the producer loads each ring stage once and then only
  arrives on its barrier, so the products reread stale tiles (the
  products, barriers and epilogue without the copies);
- `no_mma`: the consumers skip their wgmma (the copies, barriers and
  epilogue without the products);
- `six_stages`: six ring stages in place of four for the single products.

The ablations compute wrong outputs by design; they exist to be timed.
Times: CUDA events around 20 back-to-back launches through ctypes, the
lower of two turns (the second in reverse order), in TFLOP/s of the
product's own operations, with one `torch.matmul` of the same shapes
beside them as a yardstick (timed only; the port never calls it). An edit
whose anchor is missing from the source raises: update the anchor with
the kernel.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import torch

from vitax_torch.kernels import build

ABLATIONS = {
    "base": [],
    "no_loads": [("        mbar_expect_tx(full + s, kStageBytes<kDual>);\n",
                  "        if (t >= S) {\n          mbar_arrive(full + s);\n"
                  "          continue;\n        }\n"
                  "        mbar_expect_tx(full + s, kStageBytes<kDual>);\n")],
    "no_mma": [("      wgmma_m64n128<LAYOUT == kTN ? 1 : 0, LAYOUT == kNT ? 0 : 1>(",
                "      if (nk < 0) wgmma_m64n128<LAYOUT == kTN ? 1 : 0, "
                "LAYOUT == kNT ? 0 : 1>("),
               ("        wgmma_m64n128<0, 0>(acc2",
                "        if (nk < 0) wgmma_m64n128<0, 0>(acc2")],
    "six_stages": [("constexpr int kStages = kDual ? 3 : 4;",
                    "constexpr int kStages = kDual ? 3 : 6;")],
}
# (label, kind of vitax_gemm_sm90, k, n, rows) at b32 spq 200 (6400 rows)
# and b64 (12800): the backwards' K1 qkv recompute, dqkv·Wqkvᵀ and
# xnᵀ·dqkv, K2's dual pair, h1ᵀ·do; the forwards' qkv, out-projection, fc1
# with bias + GELU and fc2 with bias + residual
B32, B64 = 6400, 12800
CASES = [("qkv (kNN, bias)", 0, 768, 2304, B32),
         ("dxn (kNT, fp32)", 2, 2304, 768, B32),
         ("dWqkv (kTN)", 3, 768, 2304, B32),
         ("K2 pair (dual)", 4, 768, 3072, B32),
         ("dW2 (kTN)", 3, 3072, 768, B32)] + [
    (f"{label} b{rows // 200}", kind, k, n, rows) for rows in (B32, B64)
    for label, kind, k, n in (("fwd qkv (bias)", 0, 768, 2304),
                              ("fwd out-proj (bias)", 0, 768, 768),
                              ("fwd fc1 (bias+gelu)", 5, 768, 3072),
                              ("fwd fc2 (bias+residual)", 7, 3072, 768))]


def build_variants() -> dict:
    """name -> the variant's vitax_gemm_sm90 (ctypes)."""
    root = build.BUILD_DIR / "gemm_sm90_ablations"
    header = (build.CSRC / "gemm_sm90.cuh").read_text()
    nvcc = build._nvcc()
    procs = {}
    for name, edits in ABLATIONS.items():
        text = header
        for anchor, new in edits:
            if anchor not in text:
                raise RuntimeError(f"{name}: anchor not in gemm_sm90.cuh: "
                                   f"{anchor!r}")
            text = text.replace(anchor, new)
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        for src in build.CSRC.glob("*.cuh"):
            shutil.copy(src, d / src.name)
        shutil.copy(build.CSRC / "gemm_sm90.cu", d / "gemm_sm90.cu")
        (d / "gemm_sm90.cuh").write_text(text)
        cmd = [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "gemm_sm90.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out[-3000:]}")
        fn = ctypes.CDLL(str(root / name / "lib.so")).vitax_gemm_sm90
        fn.argtypes = build.SIGNATURES["vitax_gemm_sm90"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _batch_ms(fn, launches: int = 20) -> float:
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


def _operands(kind, k, n, rows, g):
    """(A, B, A2, B2, m, n, k, the fp32 reference of C or F, the library
    call, operations) of a case; kind 7's residual rides in A2."""
    def r(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    if kind == 3:  # F[k, n] = A[rows, k]ᵀ · B[rows, n]
        a, b = r(rows, k), r(rows, n)
        return (a, b, None, None, k, n, rows,
                torch.matmul(a.float().t(), b.float()),
                lambda: torch.matmul(a.t(), b), 2 * rows * k * n)
    a = r(rows, k)
    b = (r(n, k) if kind == 2 else r(k, n)) * k ** -0.5
    if kind == 2:
        return (a, b, None, None, rows, n, k,
                torch.matmul(a.float(), b.float().t()),
                lambda: torch.matmul(a, b.t()), 2 * rows * k * n)
    if kind in (0, 5, 7):
        ref = torch.matmul(a.float(), b.float())
        res = r(rows, n) if kind == 7 else None
        if kind == 5:
            ref = torch.nn.functional.gelu(ref)
        if kind == 7:
            ref = ref + res.float()
        return (a, b, res, None, rows, n, k, ref,
                lambda: torch.matmul(a, b), 2 * rows * k * n)
    a2, b2 = r(rows, k), r(n, k) * k ** -0.5
    return (a, b, a2, b2, rows, n, k,
            torch.nn.functional.gelu(torch.matmul(a.float(), b.float())),
            lambda: (torch.matmul(a, b), torch.matmul(a2, b2.t())),
            4 * rows * k * n)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("gemm_sm90_ablations: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = build_variants()
    stream = torch.cuda.current_stream().cuda_stream
    lib = build.load()
    g = torch.Generator(device="cuda").manual_seed(0)
    for label, kind, k, n, rows in CASES:
        a, b, a2, b2, m, nn, kk, ref, library, ops = _operands(kind, k, n,
                                                               rows, g)
        bias = torch.zeros(nn, device="cuda")
        c = torch.empty((m, nn), dtype=torch.bfloat16, device="cuda")
        c2, f = torch.empty_like(c), torch.empty((m, nn), device="cuda")
        ws = torch.empty(max(1, lib.vitax_gemm_sm90_ws(m, nn, kk)),
                         device="cuda")

        def ptr(t):
            return 0 if t is None else t.data_ptr()

        calls = {name: (lambda fn=fn: build.check(fn(
            ptr(a), ptr(b), bias.data_ptr(), ptr(a2), ptr(b2), c.data_ptr(),
            c2.data_ptr(), f.data_ptr(), ws.data_ptr(), m, nn, kk, kind,
            stream), "gemm_sm90 ablation")) for name, fn in fns.items()}
        calls["base"]()
        torch.cuda.synchronize()
        out = (c if kind in (0, 4, 5, 7) else f).float()
        err = ((out - ref).abs().max() / ref.abs().max()).item()
        if err > 2e-2:
            raise AssertionError(f"base {label}: relative error {err}")
        order = list(calls)
        times = {}
        for name in order + order[::-1]:
            times[name] = min(times.get(name, float("inf")),
                              _batch_ms(calls[name]))
        lib_ms = min(_batch_ms(library), _batch_ms(library))
        print(f"{label} [{m}x{nn}x{kk}] (base max|k-ref|/max|ref| "
              f"{err:.1e}): " + ", ".join(
                  f"{name} {t:.4f} ms ({ops / t / 1e9:.0f} TFLOP/s)"
                  for name, t in times.items())
              + f"; torch.matmul {lib_ms:.4f} ms "
              f"({ops / lib_ms / 1e9:.0f} TFLOP/s)", flush=True)
        del a, b, a2, b2, c, c2, f, ws, ref
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
