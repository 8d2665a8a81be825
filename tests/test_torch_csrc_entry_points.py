"""The C entry points of `vitax_torch/csrc/` against the ctypes argtypes
that `vitax_torch/kernels/build.py` gives them, and the ablation scripts of
K13 and of the wgmma GEMM against the kernel sources they edit. No CUDA
compiler is needed: a count that disagrees would pass pointers into the
wrong parameters on the card, and a missing anchor would stop `python -m
vitax_torch.scripts.k13_ablations` (or `gemm_sm90_ablations`) there."""

import re

import pytest

from vitax_torch.kernels import build
from vitax_torch.scripts import gemm_sm90_ablations, k13_ablations

_DECL = re.compile(r'extern "C" (?:int|long long|const char\*) (\w+)\(([^)]*)\)')


def _entry_points():
    found = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        for name, params in _DECL.findall(src.read_text()):
            params = params.strip()
            found[name] = 0 if not params else params.count(",") + 1
    return found


ENTRY_POINTS = _entry_points()
ARGTYPES = {**build.SIGNATURES, **build.WORKSPACE_SIGNATURES}


@pytest.mark.parametrize("name", sorted(ARGTYPES))
def test_argtypes_match_the_c_declaration(name):
    assert name in ENTRY_POINTS, f"{name} is declared in no csrc/*.cu"
    assert len(ARGTYPES[name]) == ENTRY_POINTS[name]


@pytest.mark.parametrize("ablation", sorted(k13_ablations.ABLATIONS))
def test_k13_ablation_anchors_are_in_the_kernel_source(ablation):
    header = (build.CSRC / "attention_core.cuh").read_text()
    for anchor, _ in k13_ablations.ABLATIONS[ablation]:
        assert header.count(anchor) == 1, anchor


@pytest.mark.parametrize("ablation", sorted(gemm_sm90_ablations.ABLATIONS))
def test_gemm_sm90_ablation_anchors_are_in_the_kernel_source(ablation):
    header = (build.CSRC / "gemm_sm90.cuh").read_text()
    for anchor, _ in gemm_sm90_ablations.ABLATIONS[ablation]:
        assert header.count(anchor) == 1, anchor


def test_gemm_sm90_kinds_match_the_c_switch():
    """`ck.gemm_sm90` passes a kind as its index in GEMM_SM90_KINDS: the C
    switch of csrc/gemm_sm90.cu must have one case for each, in order."""
    from vitax_torch.ops import cuda_kernels as ck
    src = (build.CSRC / "gemm_sm90.cu").read_text()
    cases = [int(c) for c in re.findall(r"^\s*case (\d+):", src, re.M)]
    assert cases == list(range(len(ck.GEMM_SM90_KINDS)))


def test_gemm_sm90_s8_kinds_match_the_c_switch():
    """`ck.gemm_sm90_s8` passes a kind as its index in GEMM_SM90_S8_KINDS:
    the C switch of csrc/gemm_sm90_s8.cu must have one case for each, in
    order."""
    from vitax_torch.ops import cuda_kernels as ck
    src = (build.CSRC / "gemm_sm90_s8.cu").read_text()
    cases = [int(c) for c in re.findall(r"^\s*case (\d+):", src, re.M)]
    assert cases == list(range(len(ck.GEMM_SM90_S8_KINDS)))
