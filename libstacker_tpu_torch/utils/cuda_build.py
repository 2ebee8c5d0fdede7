"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use with ``nvcc`` for Hopper (``sm_90a``) into ``build/`` beside the
package, keyed by a hash of its source, the shared headers
``csrc/*.cuh`` and the flags, then loaded with
``ctypes``.  No PyTorch header is compiled, which keeps a build at a few
seconds (``torch.utils.cpp_extension.load`` takes minutes per file).

Contract of every C entry point: pointers and the stream are
``ctypes.c_void_p``; the function returns ``cudaGetLastError()`` after
its launches, and the Python wrapper raises on a non-zero code (a
refused launch never runs, and ``torch.cuda.synchronize()`` would not
report it).

``--fmad=false`` keeps ``a*b+c`` as two rounded operations, the way
PyTorch's elementwise ops evaluate the kernels' plain versions: source
coordinates then land in the same 1/32-px bin in the kernel and in the
plain version, pixel for pixel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD = _PKG.parent / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--fmad=false", "-Xptxas", "-v",
)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def library_path(name: str) -> Path:
    """``build/lib<name>_<hash>.so`` for the current source of
    ``csrc/<name>.cu`` and the shared headers ``csrc/*.cuh``."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}_{digest[:16]}.so"


def build(*names: str) -> None:
    """Compile every ``csrc/<name>.cu`` whose hashed build is missing,
    one ``nvcc`` per source, all started together.  The compiler's
    ``-Xptxas -v`` report (registers, spills) is kept beside each
    library as ``<lib>.ptxas.txt``."""
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode == 0:
            out.with_suffix(".ptxas.txt").write_text(err)
            os.replace(tmp, out)  # atomic: concurrent builders agree
        else:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{err}")
        if os.path.exists(tmp):
            os.remove(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its hashed build is missing, then
    load it."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` lines of the last build of ``name`` ('' if the
    library was built by another process without the report)."""
    p = library_path(name).with_suffix(".ptxas.txt")
    return p.read_text() if p.exists() else ""


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
