"""ctypes bindings for the native C++ batch decoder (native/stacker_io.cpp).

A copy of ``libstacker_tpu/utils/native_loader.py`` with one change: the
library is built on first use with ``g++`` and the flags of
``native/Makefile`` into the git-ignored ``build/`` beside the package,
under a name that carries a hash of the source and the flags (as
``utils/cuda_build.py`` keys the kernels), instead of being loaded from
``native/libstacker_io.so``.  Nothing is written into ``native/``.

When the source is missing, or the build or the load fails (the host
lacks ``jpeglib.h``, ``png.h`` or ``tiffio.h``, or their libraries),
:func:`available` is False and ``utils.io.load_frames`` decodes through
PIL, as the reference does when its library is not built;
:func:`build_error` then says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from ..errors import NotEnoughFilesError, StackerIoError
from .cuda_build import BUILD

SOURCE = Path(__file__).resolve().parents[2] / "native" / "stacker_io.cpp"
# native/Makefile:1-3
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall")
LDFLAGS = ("-shared", "-ljpeg", "-lpng", "-ltiff")

_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_build_error: Optional[str] = None


def library_path() -> Path:
    """``build/libstacker_io_<hash>.so`` for the current source and flags."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXXFLAGS + LDFLAGS).encode()
    ).hexdigest()
    return BUILD / f"libstacker_io_{digest[:16]}.so"


def _build() -> Path:
    """Compile the loader if its hashed build is missing; raise OSError
    with the compiler's last lines if it cannot be built."""
    if not SOURCE.exists():
        raise OSError(f"{SOURCE} not found")
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        proc = subprocess.run(
            [cxx, *CXXFLAGS, str(SOURCE), "-o", tmp, *LDFLAGS],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            tail = "\n".join((proc.stderr or proc.stdout).splitlines()[-6:])
            raise OSError(f"{cxx} failed for {SOURCE}:\n{tail}")
        os.replace(tmp, out)  # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed, _build_error
    if _lib is not None or _load_failed:
        return _lib
    try:
        lib = ctypes.CDLL(str(_build()))
    except OSError as e:
        _load_failed = True
        _build_error = str(e)
        return None
    lib.stacker_probe.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.stacker_probe.restype = ctypes.c_int
    lib.stacker_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.stacker_decode_batch.restype = ctypes.c_int
    lib.stacker_rgb_to_gray.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int,
    ]
    lib.stacker_rgb_to_gray.restype = None
    lib.stacker_decode_batch16.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.stacker_decode_batch16.restype = ctypes.c_int
    lib.stacker_write_png16.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.stacker_write_png16.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return _get_lib() is not None


def build_error() -> Optional[str]:
    """Why the loader is not available (the compiler's last lines), or
    None if it built and loaded (or was not tried yet)."""
    _get_lib()
    return _build_error


def probe(path) -> Tuple[int, int]:
    """Return (height, width) of an image file without full decode."""
    lib = _get_lib()
    if lib is None:
        raise StackerIoError("native loader not built (make -C native)")
    h = ctypes.c_int64()
    w = ctypes.c_int64()
    rc = lib.stacker_probe(str(path).encode(), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise StackerIoError(f"probe failed for {path} (code {rc})")
    return int(h.value), int(w.value)


def _decode(files: Sequence, num_threads: int, dtype, fn) -> np.ndarray:
    """Decode ``files`` into one [N,H,W,3] ``dtype`` tensor through the
    library's batch entry ``fn``; raise listing every file that failed."""
    h, w = probe(files[0])
    n = len(files)
    out = np.empty((n, h, w, 3), dtype=dtype)
    statuses = (ctypes.c_int * n)()
    c_paths = (ctypes.c_char_p * n)(*[f.encode() for f in files])
    failures = fn(
        c_paths,
        n,
        out.ctypes.data_as(ctypes.POINTER(np.ctypeslib.as_ctypes_type(dtype))),
        h,
        w,
        num_threads,
        statuses,
    )
    if failures:
        bad = [
            f"{files[i]} (code {statuses[i]})"
            for i in range(n)
            if statuses[i] != 0
        ]
        raise StackerIoError("decode failures: " + "; ".join(bad))
    return out


def load_frames_native(
    files: Sequence, num_threads: int = 0
) -> np.ndarray:
    """Decode files into one [N,H,W,3] uint8 RGB tensor with the native
    thread-pool decoder.  All frames must match frame 0's size."""
    files = [str(f) for f in files]
    if not files:
        raise NotEnoughFilesError()
    lib = _get_lib()
    if lib is None:
        raise StackerIoError("native loader not built (make -C native)")
    return _decode(files, num_threads, np.uint8, lib.stacker_decode_batch)


def available16() -> bool:
    return available()


def load_frames_native16(
    files: Sequence, num_threads: int = 0
) -> np.ndarray:
    """Full-depth decode into one [N,H,W,3] uint16 RGB tensor: 16-bit
    PNG/TIFF at native depth, 8-bit sources expanded x257."""
    files = [str(f) for f in files]
    if not files:
        raise NotEnoughFilesError()
    if not available16():
        raise StackerIoError(
            "native 16-bit decoder not built (make -C native)"
        )
    return _decode(files, num_threads, np.uint16,
                   _get_lib().stacker_decode_batch16)


def write_png16_native(path, rgb16: np.ndarray) -> None:
    """Encode a [H,W,3] uint16 array as a 16-bit RGB PNG (libpng)."""
    lib = _get_lib()
    if lib is None:
        raise StackerIoError(
            "native writer not built (make -C native)"
        )
    rgb16 = np.ascontiguousarray(rgb16, dtype=np.uint16)
    if rgb16.ndim != 3 or rgb16.shape[2] != 3:
        raise StackerIoError(
            f"write_png16 needs [H,W,3] uint16, got {rgb16.shape}"
        )
    rc = lib.stacker_write_png16(
        str(path).encode(),
        rgb16.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        rgb16.shape[0],
        rgb16.shape[1],
    )
    if rc != 0:
        raise StackerIoError(f"write failed for {path} (code {rc})")


def rgb_to_gray_native(rgb: np.ndarray, num_threads: int = 0) -> np.ndarray:
    """Fixed-point grayscale on host via the native library (bit-exact
    with ops.color.rgb_to_gray_u8)."""
    lib = _get_lib()
    if lib is None:
        raise StackerIoError("native loader not built (make -C native)")
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    out = np.empty(rgb.shape[:-1], dtype=np.uint8)
    lib.stacker_rgb_to_gray(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.size,
        num_threads,
    )
    return out
