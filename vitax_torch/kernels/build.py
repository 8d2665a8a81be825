"""Build and load the Hopper kernels of `vitax_torch/csrc/`.

All `csrc/*.cu` files are compiled by one `nvcc` call into a shared library
with a plain C interface, which is loaded with `ctypes` (no PyTorch headers in
the build, so it takes seconds, not minutes). The library lands in the
checkout's `build/vitax_torch_kernels/` (listed in `.gitignore`), named by a hash of
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C entry points -> argtypes (every pointer and the stream as c_void_p, so
# 64-bit device addresses are not cut to 32 bits)
SIGNATURES = {
    "vitax_layer_norm": [_P, _P, _P, _P, _I, _I, _F, _I, _P],
    "vitax_ln_mlp_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _F, _P],
    "vitax_ln_qkvo_attention_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _P, _I, _I, _I, _I, _I, _I, _F, _F, _P],
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
    """Compile the kernels unless a library of the current sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "nvcc.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
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
        lib.vitax_error_string.argtypes = [ctypes.c_int]
        lib.vitax_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = load().vitax_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
