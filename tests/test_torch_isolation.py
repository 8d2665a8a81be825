"""vitax_torch stands alone: it imports torch and numpy, never jax or vitax,
and `chip_smoke.py` refuses to run without a CUDA card."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "vitax_torch"
_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|vitax)\b", re.M)


def test_importing_every_module_pulls_in_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import vitax_torch\n"
        "for m in pkgutil.walk_packages(vitax_torch.__path__, 'vitax_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'vitax')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_no_source_names_jax_or_vitax():
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        assert not _IMPORT.search(f.read_text()), f


def test_kernel_sources_and_build_dir():
    from vitax_torch.kernels import build
    names = {p.name for p in build.sources()}
    assert {"layernorm.cu", "ln_mlp.cu", "ln_qkvo_attention.cu"} <= names
    # the library is built inside the checkout, under an ignored directory
    rel = build.library_path().relative_to(ROOT)
    assert rel.parts[0] == "build"
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run for real")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
