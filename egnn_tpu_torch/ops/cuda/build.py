"""Build the package's CUDA sources into shared libraries and load them.

Each ``egnn_tpu_torch/csrc/<name>.cu`` is compiled by its own ``nvcc`` (all
started together) for ``sm_90a`` into ``build/egnn_tpu_torch/`` at the root
of the checkout, named by a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags so that an edited source is rebuilt, and loaded
with ``ctypes``. The sources have a plain C
interface (pointers and ints), so no PyTorch header is compiled. Nothing
happens at import: the first kernel launch builds, or ``build_all()`` does
it up front. What ``ptxas`` reports (each kernel's registers, spills and
shared memory) is kept beside each library, as ``<library>.log``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "egnn_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every source that has no current build, in parallel, and load
    all of them. Returns the libraries by source name."""
    with _lock:
        sources = sorted(CSRC.glob("*.cu"))
        todo = [s for s in sources if s.stem not in _libs and not _target(s).exists()]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = []
            for src in todo:
                tmp = _target(src).with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
                procs.append((src, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
            failed = []
            for src, tmp, proc in procs:
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"{src.name}:\n{out.decode(errors='replace')}")
                else:
                    _target(src).with_suffix(".log").write_bytes(out)
                    os.replace(tmp, _target(src))
            if failed:
                raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for src in sources:
            if src.stem not in _libs:
                _libs[src.stem] = ctypes.CDLL(str(_target(src)))
        return dict(_libs)


def ptxas_report(name: str) -> str:
    """What ptxas reported when it built ``csrc/<name>.cu``."""
    build_all()
    return _target(CSRC / f"{name}.cu").with_suffix(".log").read_text(errors="replace")


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all()[name]


@contextlib.contextmanager
def using(name: str, lib: ctypes.CDLL):
    """Within the block, the wrappers of ``csrc/<name>.cu`` launch from
    ``lib``, a build of another copy of that source (a parent checkout's, say),
    in place of this checkout's build."""
    own = library(name)
    _libs[name] = lib
    try:
        yield lib
    finally:
        _libs[name] = own


def function(name: str, entry: str, argtypes: list, restype=ctypes.c_int):
    """The C function ``entry`` of ``csrc/<name>.cu``, typed on first use;
    every launch function returns a CUDA error code (``c_int``)."""
    fn = getattr(library(name), entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn
