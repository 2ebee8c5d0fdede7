"""ctypes bindings for the native batch decoder: ``native/stacker_io.cpp``
where it builds, else the port's own ``csrc/image_io.cpp``.

Both libraries export one C ABI (``stacker_probe``,
``stacker_decode_batch``, ``stacker_decode_batch16``,
``stacker_write_png16``, ``stacker_rgb_to_gray``) with the same per-file
status codes.  They are tried in :data:`ORDER`:

- ``"libjpeg/libpng/libtiff"``: the JAX package's decoder
  (``native/stacker_io.cpp``, the flags of ``native/Makefile``); it needs
  ``jpeglib.h``, ``png.h`` and ``tiffio.h``;
- ``"zlib"``: ``csrc/image_io.cpp``, which needs only ``zlib.h``; it
  decodes PNG and baseline TIFF and gives :data:`ERR_FORMAT` for JPEG and
  for a TIFF outside its subset, which ``utils.io`` then decodes through
  PIL.

Each is built on first use with ``g++`` into the git-ignored ``build/``
beside the package, under a name that carries a hash of its source and
flags (as ``utils/cuda_build.py`` keys the kernels), one build at a
time on ``build/build.lock``.  Nothing is written into ``native/``.  When
neither builds, :func:`available` is False and ``utils.io.load_frames``
decodes through PIL; :func:`build_error` then gives both compilers'
reasons.  :func:`library` loads one of them by name (tests narrow
:data:`ORDER` to the zlib reader to hold it to the oracle wherever the
full loader builds too).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..errors import NotEnoughFilesError, StackerIoError
from .cuda_build import BUILD, CSRC

FULL = "libjpeg/libpng/libtiff"
ZLIB = "zlib"

# per-file status codes (native/stacker_io.cpp:38-42)
ERR_OPEN, ERR_DECODE, ERR_SIZE, ERR_FORMAT = 1, 2, 3, 4

# native/Makefile:1-3
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall")


class _Spec(NamedTuple):
    source: Path
    ldflags: Tuple[str, ...]
    stem: str


_SPECS: Dict[str, _Spec] = {
    FULL: _Spec(Path(__file__).resolve().parents[2] / "native"
                / "stacker_io.cpp",
                ("-shared", "-ljpeg", "-lpng", "-ltiff"), "libstacker_io"),
    ZLIB: _Spec(CSRC / "image_io.cpp", ("-shared", "-lz"), "libimage_io"),
}

# the order in which :func:`backend` tries the libraries
ORDER: Tuple[str, ...] = (FULL, ZLIB)

_libs: Dict[str, ctypes.CDLL] = {}
_errors: Dict[str, str] = {}


def library_path(name: str = FULL) -> Path:
    """``build/<stem>_<hash>.so`` for ``name``'s current source and
    flags."""
    spec = _SPECS[name]
    digest = hashlib.sha256(
        spec.source.read_bytes() + " ".join(CXXFLAGS + spec.ldflags).encode()
    ).hexdigest()
    return BUILD / f"{spec.stem}_{digest[:16]}.so"


def _build(name: str) -> Path:
    """Compile ``name``'s library if its hashed build is missing; raise
    OSError with the compiler's last lines if it cannot be built."""
    spec = _SPECS[name]
    if not spec.source.exists():
        raise OSError(f"{spec.source} not found")
    out = library_path(name)
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / "build.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # built by the holder we waited for
            return out
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        try:
            proc = subprocess.run(
                [cxx, *CXXFLAGS, str(spec.source), "-o", tmp, *spec.ldflags],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                tail = "\n".join(
                    (proc.stderr or proc.stdout).splitlines()[-6:])
                raise OSError(f"{cxx} failed for {spec.source}:\n{tail}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    i64, c_int = ctypes.c_int64, ctypes.c_int
    paths = ctypes.POINTER(ctypes.c_char_p)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    u16 = ctypes.POINTER(ctypes.c_uint16)
    status = ctypes.POINTER(c_int)
    lib.stacker_probe.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.stacker_probe.restype = c_int
    lib.stacker_decode_batch.argtypes = [
        paths, i64, u8, i64, i64, c_int, status]
    lib.stacker_decode_batch.restype = c_int
    lib.stacker_decode_batch16.argtypes = [
        paths, i64, u16, i64, i64, c_int, status]
    lib.stacker_decode_batch16.restype = c_int
    lib.stacker_rgb_to_gray.argtypes = [u8, u8, i64, c_int]
    lib.stacker_rgb_to_gray.restype = None
    lib.stacker_write_png16.argtypes = [ctypes.c_char_p, u16, i64, i64]
    lib.stacker_write_png16.restype = c_int


def library(name: str) -> Optional[ctypes.CDLL]:
    """``name``'s library, built and loaded on first use; None (and
    :func:`build_error` says why) where it does not build or load."""
    if name in _libs:
        return _libs[name]
    if name in _errors:
        return None
    try:
        lib = ctypes.CDLL(str(_build(name)))
    except OSError as e:
        _errors[name] = str(e)
        return None
    _declare(lib)
    _libs[name] = lib
    return lib


def backend() -> Optional[str]:
    """The first library of :data:`ORDER` that loads:
    ``"libjpeg/libpng/libtiff"``, ``"zlib"``, or None."""
    for name in ORDER:
        if library(name) is not None:
            return name
    return None


def _lib() -> ctypes.CDLL:
    name = backend()
    if name is None:
        raise StackerIoError(f"native loader not built: {build_error()}")
    return library(name)


def available() -> bool:
    return backend() is not None


def build_error() -> Optional[str]:
    """Why no library of :data:`ORDER` loads (each compiler's last lines),
    or None if one does."""
    if available():
        return None
    return "\n".join(f"{name}: {_errors.get(name, 'not tried')}"
                     for name in ORDER)


def probe_status(path) -> Tuple[int, int, int]:
    """(status, height, width) of an image file from its header alone."""
    h = ctypes.c_int64()
    w = ctypes.c_int64()
    rc = _lib().stacker_probe(
        str(path).encode(), ctypes.byref(h), ctypes.byref(w))
    return int(rc), int(h.value), int(w.value)


def probe(path) -> Tuple[int, int]:
    """Return (height, width) of an image file without full decode."""
    rc, h, w = probe_status(path)
    if rc != 0:
        raise StackerIoError(f"probe failed for {path} (code {rc})")
    return h, w


def decode_batch(files: Sequence, h: int, w: int, dtype,
                 num_threads: int = 0):
    """Decode ``files`` into one [N,h,w,3] ``dtype`` (uint8 or uint16)
    array in one call on the library's thread pool -> (array, per-file
    status codes).  A file whose code is not 0 leaves its frame
    unwritten; nothing is raised."""
    lib = _lib()
    dtype = np.dtype(dtype)
    fn = {np.dtype(np.uint8): lib.stacker_decode_batch,
          np.dtype(np.uint16): lib.stacker_decode_batch16}[dtype]
    n = len(files)
    out = np.empty((n, h, w, 3), dtype=dtype)
    statuses = (ctypes.c_int * n)()
    c_paths = (ctypes.c_char_p * n)(*[str(f).encode() for f in files])
    fn(c_paths, n,
       out.ctypes.data_as(ctypes.POINTER(np.ctypeslib.as_ctypes_type(dtype))),
       h, w, num_threads, statuses)
    return out, list(statuses)


def _decode(files: Sequence, num_threads: int, dtype) -> np.ndarray:
    """Decode ``files`` at frame 0's size; raise listing every file that
    failed."""
    files = [str(f) for f in files]
    if not files:
        raise NotEnoughFilesError()
    h, w = probe(files[0])
    out, statuses = decode_batch(files, h, w, dtype, num_threads)
    bad = [f"{f} (code {s})" for f, s in zip(files, statuses) if s != 0]
    if bad:
        raise StackerIoError("decode failures: " + "; ".join(bad))
    return out


def load_frames_native(files: Sequence, num_threads: int = 0) -> np.ndarray:
    """Decode files into one [N,H,W,3] uint8 RGB tensor with the native
    thread-pool decoder.  All frames must match frame 0's size."""
    return _decode(files, num_threads, np.uint8)


def available16() -> bool:
    return available()


def load_frames_native16(files: Sequence, num_threads: int = 0) -> np.ndarray:
    """Full-depth decode into one [N,H,W,3] uint16 RGB tensor: 16-bit
    PNG/TIFF at native depth, 8-bit sources expanded x257."""
    return _decode(files, num_threads, np.uint16)


def write_png16_native(path, rgb16: np.ndarray) -> None:
    """Encode a [H,W,3] uint16 array as a 16-bit RGB PNG."""
    lib = _lib()
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
    lib = _lib()
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    out = np.empty(rgb.shape[:-1], dtype=np.uint8)
    lib.stacker_rgb_to_gray(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.size,
        num_threads,
    )
    return out
