"""Build and load the port's CUDA kernels: plain ``nvcc`` into one C-ABI
shared library per source, loaded with ``ctypes``.

No PyTorch headers and no ``torch.utils.cpp_extension``: a source with a
plain C interface builds in seconds, where one that includes PyTorch's
headers takes minutes.  Every ``csrc/*.cu`` gets its own ``nvcc`` process and
all of them start together; ``csrc/*.cuh`` are headers they share.  Outputs
go to ``_build/`` inside the package (ignored by git); a library newer than
its source and the headers is reused.  Nothing is
built at import time — only on the first launch on a CUDA tensor, or when a
caller asks (``build_all``).  ``load`` holds a lock, so threads that launch
at once build and load each library once.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "port's CUDA kernels are built on first use")
    return path


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path(stem: str) -> Path:
    return BUILD_DIR / f"lib{stem}.so"


def _stale(src: Path) -> bool:
    """The library is missing or older than its source or a shared header."""
    lib = library_path(src.stem)
    newest = max(p.stat().st_mtime for p in [src, *CSRC_DIR.glob("*.cuh")])
    return not lib.exists() or lib.stat().st_mtime < newest


def build_all(force: bool = False) -> dict[str, dict]:
    """Compile every stale ``csrc/*.cu`` (all of them with ``force``), one
    ``nvcc`` per source, all started together.  Returns, per source stem,
    ``{"path", "seconds", "log"}`` where ``log`` is nvcc's ``-Xptxas -v``
    report (registers, shared memory, spills); raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s in sources() if force or _stale(s)]
    nvcc = nvcc_path()
    procs = []
    t0 = time.perf_counter()
    for src in todo:
        tmp = BUILD_DIR / f".lib{src.stem}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out: dict[str, dict] = {}
    failed = []
    for src, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        os.replace(tmp, library_path(src.stem))
        out[src.stem] = {"path": str(library_path(src.stem)),
                         "seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built if stale)."""
    with _LOAD_LOCK:
        lib = _LOADED.get(stem)
        if lib is None:
            src = CSRC_DIR / f"{stem}.cu"
            if not src.exists():
                raise FileNotFoundError(src)
            if _stale(src):
                build_all()
            lib = ctypes.CDLL(str(library_path(stem)))
            _LOADED[stem] = lib
        return lib
