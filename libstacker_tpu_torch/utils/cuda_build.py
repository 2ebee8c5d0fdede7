"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use with ``nvcc`` for Hopper (``sm_90a``) into ``build/`` beside the
package, keyed by a hash of its source, the shared headers
``csrc/*.cuh`` and the flags, then loaded with
``ctypes``.  No PyTorch header is compiled, which keeps a build at a few
seconds (``torch.utils.cpp_extension.load`` takes minutes per file).

Contract of every C entry point: pointers and the stream are
``ctypes.c_void_p``, the stream last; the function launches with
``<<<...>>>`` on the CUDA runtime's current device and returns
``cudaGetLastError()`` after its launches.  A wrapper calls it through
:func:`launch`, which makes the tensors' card current around the call
(another card's stream would be an invalid handle there) and raises on a
non-zero code (a refused launch never runs, and
``torch.cuda.synchronize()`` would not report it).

``--fmad=false`` keeps ``a*b+c`` as two rounded operations, the way
PyTorch's elementwise ops evaluate the kernels' plain versions: source
coordinates then land in the same 1/32-px bin in the kernel and in the
plain version, pixel for pixel.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

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


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """``build/lib<name>_<hash>.so`` for the current source of
    ``<csrc>/<name>.cu`` and the headers ``<csrc>/*.cuh`` beside it
    (``csrc`` is the package's ``csrc/`` unless a caller builds another
    copy of the sources, e.g. an earlier design to time against)."""
    src = (csrc / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(csrc.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}_{digest[:16]}.so"


def build(*names: str, csrc: Path = CSRC) -> None:
    """Compile every ``<csrc>/<name>.cu`` whose hashed build is missing,
    one ``nvcc`` per source, all started together.  The compiler's
    ``-Xptxas -v`` report (registers, spills) is kept beside each
    library as ``<lib>.ptxas.txt``.  One process builds at a time: the
    others wait on ``build/build.lock`` (``flock``, released when its
    holder exits), then find the libraries built."""
    if all(library_path(n, csrc).exists() for n in names):
        return
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / "build.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        _build_locked(names, csrc)


def _build_locked(names, csrc: Path) -> None:
    jobs = []
    for name in names:
        out = library_path(name, csrc)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode == 0:
            out.with_suffix(".ptxas.txt").write_text(err)
            os.replace(tmp, out)
        else:
            failed.append(f"nvcc failed for {csrc / name}.cu:\n{err}")
        if os.path.exists(tmp):
            os.remove(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.lru_cache(maxsize=None)
def load(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """Compile ``<csrc>/<name>.cu`` if its hashed build is missing, then
    load it."""
    build(name, csrc=csrc)
    return ctypes.CDLL(str(library_path(name, csrc)))


def ptxas_report(name: str, csrc: Path = CSRC) -> str:
    """The ``-Xptxas -v`` lines of the last build of ``name`` ('' if the
    library was built by another process without the report)."""
    p = library_path(name, csrc).with_suffix(".ptxas.txt")
    return p.read_text() if p.exists() else ""


def kernel_resources(name: str, csrc: Path = CSRC) -> dict:
    """Per kernel of the last build of ``name``, from its ``-Xptxas -v``
    report: mangled name -> ``{"registers", "spill_stores",
    "spill_loads", "smem"}`` (spills and static shared memory per block
    in bytes)."""
    out, cur = {}, None
    for line in ptxas_report(name, csrc).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$.]+)'?", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(m.group(1)) if m else 0
    return {k: v for k, v in out.items() if "registers" in v}


# one lock for every counter: the mesh's host threads launch at once
_COUNT_LOCK = threading.Lock()


def count(scope: dict, name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``scope[name]`` under one lock.  A
    wrapper passes its module's ``globals()``, so the module attribute
    that readers reset and read (``ecc_cuda.launch_count``) moves; a bare
    ``+=`` from the mesh's host threads can lose an increment."""
    with _COUNT_LOCK:
        scope[name] += n


def launch(lib: ctypes.CDLL, entry: str, device: torch.device, *args) -> None:
    """Call C entry point ``entry`` of ``lib`` with ``args`` and the
    current stream of ``device``, with ``device`` the current device for
    the call, then raise on its error code (:func:`check`)."""
    with torch.cuda.device(device):
        err = getattr(lib, entry)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    check(lib, err, entry)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
