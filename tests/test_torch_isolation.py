"""The port stands alone: every module of slam_indoor_code_tpu_torch imports
with ``jax`` and ``slam_indoor_code_tpu`` blocked, no port source (nor
the card scripts chip_smoke.py and profile_main.py) imports OpenCV or JAX,
and every kernel source builds with plain nvcc: no PyTorch headers."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "slam_indoor_code_tpu_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
for blocked in ("jax", "jaxlib", "slam_indoor_code_tpu", "cv2"):
    sys.modules[blocked] = None      # any import of these now raises
import slam_indoor_code_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(len(names))
"""


def test_every_port_module_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 58


@pytest.mark.parametrize("pattern", [
    r"^\s*(import|from)\s+cv2\b",
    r"^\s*(import|from)\s+jax\b",
    r"^\s*(import|from)\s+slam_indoor_code_tpu\b(?!_torch)",
])
def test_no_port_source_imports(pattern):
    rx = re.compile(pattern, re.M)
    hits = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
            if rx.search(p.read_text())]
    hits += [p.name for p in (ROOT / "chip_smoke.py", ROOT / "profile_main.py")
             if rx.search(p.read_text())]
    assert not hits, hits


@pytest.mark.parametrize("src", sorted(
    p.name for p in (PKG / "csrc").iterdir() if p.suffix in (".cu", ".cuh")))
def test_kernel_sources_include_no_pytorch_headers(src):
    text = (PKG / "csrc" / src).read_text()
    hits = re.findall(r'#include\s*[<"](torch|ATen|c10|pybind11)/', text)
    assert not hits, hits
