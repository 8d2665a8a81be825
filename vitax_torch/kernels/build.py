"""Build and load the Hopper kernels of `vitax_torch/csrc/`.

Each `csrc/*.cu` file is compiled by its own `nvcc` process, all started
together, and the objects are linked into one shared library with a plain C
interface, which is loaded with `ctypes` (no PyTorch headers in the build,
so it takes seconds, not minutes). The library lands in the checkout's
`build/vitax_torch_kernels/` (listed in `.gitignore`), named by a hash of
the sources and flags, so an edit to any source rebuilds it at first use.

Nothing here runs at import time: `load()` builds on the first call, and a
failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vitax_torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C entry points -> argtypes (every pointer and the stream as c_void_p, so
# 64-bit device addresses are not cut to 32 bits)
SIGNATURES = {
    "vitax_layer_norm": [_P, _P, _P, _P, _I, _I, _F, _I, _P],
    "vitax_ln_mlp_fwd": [_P] * 10 + [_I, _I, _I, _F, _I, _P],
    "vitax_ln_qkvo_attention_fwd": [_P] * 11 + [_I] * 7 + [_F, _F, _P],
    "vitax_layer_norm_bwd": [_P] * 7 + [_I, _I, _F, _I, _P],
    "vitax_ln_mlp_bwd": [_P] * 20 + [_I, _I, _I, _F, _I, _P],
    "vitax_ln_qkvo_attention_bwd": [_P] * 23 + [_I] * 7 + [_F, _F, _P],
    "vitax_ln_mlp_int8_fwd": [_P] * 17 + [_I, _I, _I, _F, _I, _P],
    "vitax_ln_mlp_int8_bwd": [_P] * 39 + [_I] * 5 + [_F, _I, _P],
    "vitax_ln_qkvo_attention_int8_fwd": [_P] * 18 + [_I] * 7 + [_F, _F, _P],
    "vitax_ln_qkvo_attention_int8_bwd": [_P] * 41 + [_I] * 9 + [_F, _F, _P],
    "vitax_ln_qkvo_attention_int8_ho_fwd": [_P] * 22 + [_I] * 7 + [_F, _F, _P],
    "vitax_ln_mlp_int8_ho_fwd": [_P] * 19 + [_I] * 3 + [_F, _P],
    "vitax_ln_qkvo_attention_rect_fwd": [_P] * 14 + [_I] * 7 + [_F, _F, _P],
    "vitax_ln_qkvo_attention_rect_int8_fwd": [_P] * 22 + [_I] * 7 + [_F, _F, _P],
    "vitax_ln_qkvo_attention_rect_bwd": [_P] * 33 + [_I] * 7 + [_F, _F, _P],
    "vitax_ln_qkvo_attention_rect_int8_bwd": [_P] * 60 + [_I] * 10 + [_F, _F, _P],
    "vitax_ln_qkvo_attention_flash_fwd": [_P] * 11 + [_I] * 6 + [_F, _F, _P],
    "vitax_ln_qkvo_attention_flash_bwd": [_P] * 23 + [_I] * 6 + [_F, _F, _P],
    "vitax_attention_core_fwd": [_P] * 4 + [_I] * 4 + [_F, _P],
    "vitax_attention_core_bwd": [_P] * 10 + [_I] * 4 + [_F, _P],
    "vitax_ln_mlp_save_fwd": [_P] * 11 + [_I, _I, _I, _F, _I, _P],
    "vitax_ln_mlp_bwd_fast": [_P] * 19 + [_I, _I, _I, _F, _I, _P],
    "vitax_ln_mlp_int8_save_fwd": [_P] * 18 + [_I, _I, _I, _F, _I, _P],
    "vitax_ln_mlp_int8_save_bwd": [_P] * 37 + [_I] * 5 + [_F, _I, _P],
    "vitax_ln_mlp_int4_fwd": [_P] * 17 + [_I, _I, _I, _F, _I, _P],
    "vitax_ln_mlp_int4_bwd": [_P] * 41 + [_I] * 5 + [_F, _I, _P],
    "vitax_ln_qkvo_attention_int4_fwd": [_P] * 18 + [_I] * 7 + [_F, _F, _P],
    "vitax_ln_qkvo_attention_int4_bwd": [_P] * 43 + [_I] * 9 + [_F, _F, _P],
    "vitax_ln_qkvo_attention_rect_int4_fwd": [_P] * 22 + [_I] * 7 + [_F, _F, _P],
    "vitax_ln_qkvo_attention_rect_int4_bwd": [_P] * 63 + [_I] * 10 + [_F, _F, _P],
    "vitax_qkv_attention_fwd": [_P] * 5 + [_I] * 6 + [_F, _P],
    "vitax_qkv_attention_bwd": [_P] * 13 + [_I] * 6 + [_F, _P],
    "vitax_qkvo_attention_fwd": [_P] * 8 + [_I] * 6 + [_F, _P],
    "vitax_qkvo_attention_bwd": [_P] * 17 + [_I] * 6 + [_F, _P],
}
# workspace sizes (fp32 elements) of the backward entry points: host code
WORKSPACE_SIGNATURES = {
    "vitax_layer_norm_bwd_ws": [_I, _I],
    "vitax_ln_mlp_bwd_ws": [_I, _I, _I],
    "vitax_ln_qkvo_attention_bwd_ws": [_I] * 4,
    "vitax_ln_qkvo_attention_rect_bwd_ws": [_I] * 4,
    "vitax_qkv_attention_bwd_ws": [_I] * 3,
    "vitax_qkvo_attention_bwd_ws": [_I] * 4,
}

_lib = None


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # finds the toolkit
    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the vitax_torch kernels are built "
                       "from source and need the CUDA toolkit")


def library_path() -> Path:
    return BUILD_DIR / f"libvitax_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the kernels unless a library of the current sources exists:
    one nvcc per source in parallel, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{_digest()}.{os.getpid()}"
    objs, procs = [], []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
        objs.append(obj)
    log, failed = [], []
    for cmd, proc in procs:
        text, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} (exit {proc.returncode}):\n{text[-3000:]}")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link (exit {proc.returncode}):\n{proc.stderr[-3000:]}")
    (BUILD_DIR / "nvcc.log").write_text("\n".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name, argtypes in WORKSPACE_SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_longlong
        lib.vitax_error_string.argtypes = [ctypes.c_int]
        lib.vitax_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = load().vitax_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
