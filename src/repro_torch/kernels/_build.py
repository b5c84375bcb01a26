"""Build and load the port's hand-written CUDA kernels.

Each ``kernels/*/csrc/<name>.cu`` exports a plain C function and is
compiled on first use with ``nvcc`` for Hopper (``sm_90a``) into its own
shared library under ``<checkout>/build/repro_torch_kernels/``. The file
name carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded. Libraries are bound with
``ctypes``: pointers and the stream travel as ``c_void_p``, and every
launch function returns ``cudaGetLastError()``.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _sources() -> dict[str, Path]:
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def source(name: str) -> Path:
    return _sources()[name]


def kernel_names() -> list[str]:
    return list(_sources())


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "port's CUDA kernels are built on the machine with the card")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source(name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start ``nvcc`` for ``name`` unless its library exists already."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, log


def _finish(name: str, job: tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, log = job
    text, _ = proc.communicate()
    log.write_text(text)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{text[-4000:]}")
    os.replace(tmp, library_path(name))     # atomic: readers never see half


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every kernel that is not built yet, one ``nvcc`` per source,
    all started together; returns the library path of each."""
    names = kernel_names() if names is None else names
    jobs = {n: _start(n) for n in names}
    errors = []
    for n, job in jobs.items():
        if job is not None:
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: library_path(n) for n in names}


def build_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` said when it built the library (registers,
    shared memory, spills), or '' when there is no log."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def rows_aligned(t) -> bool:
    """Whether the kernels can read rows of ``t`` with 16-byte loads: unit
    stride on the last dim, every other stride a multiple of 16 bytes, and
    a 16-byte aligned base."""
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and not any(s % vec for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def require_aligned_rows(name: str, t) -> None:
    """Raise unless :func:`rows_aligned`."""
    if not rows_aligned(t):
        raise ValueError(f"{name} must have unit stride on its last dim and "
                         f"16-byte aligned rows; strides {t.stride()}")


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = _LOADED[name] = ctypes.CDLL(str(path))
        return lib
