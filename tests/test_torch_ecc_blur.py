"""The ECC solve's Gaussian pre-filter (``ops/ecc_cuda.gaussian_prefilter``,
``csrc/ecc_blur.cu``) on the CPU.

- The wrapper hands a CPU tensor to ``filters.gaussian_blur`` (the plain
  version) and raises, on every device, on a wrong dtype, a wrong rank, a
  non-contiguous input, an even or non-positive ``ksize``, and H or W at
  most the radius (where the plain version's reflect pad raises).
- ``csrc/ecc_blur.cu`` itself, compiled for the host with ``g++`` through
  ``tests/_cuda_host_shim.h`` (cp.async as a plain copy; each block's
  lanes as coroutines that switch at ``__syncthreads``), bitwise against
  ``filters.gaussian_blur``: ksize 1-17 through the staged form and 19
  and 21 through the direct one, N 1 and 7, widths that are and are not
  a multiple of 4 and that cross a block's 960-column strip, H and W at
  r + 1 and just above 2r, row segments across a plane (N = 1 and a tall
  plane), and planes that do not start on a 16-byte boundary (scalar
  copies and stores).

``tests/test_torch_cuda.py`` runs :data:`CASES` on the card through the
wrapper.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_warp_design import host_launches  # noqa: E402
from libstacker_tpu_torch.ops import ecc_cuda, filters  # noqa: E402

_SHIM = Path(__file__).with_name("_cuda_host_shim.h")
_CSRC = Path(ecc_cuda.__file__).parents[1] / "csrc"

# (ksize, N, H, W): W % 4 == 0 and != 0, across strips, H and W at r + 1
# and 2r + 1, a tall plane cut into row segments, the direct form above
# ksize 17
CASES = [
    (1, 1, 5, 7), (1, 7, 12, 16), (1, 1, 33, 962),
    (3, 1, 2, 2), (3, 7, 3, 3), (3, 1, 70, 964),
    (5, 1, 3, 3), (5, 7, 5, 5), (5, 1, 97, 260), (5, 7, 33, 44),
    (5, 1, 130, 1930), (5, 2, 9, 1924),
    (7, 1, 4, 9), (7, 7, 7, 7), (7, 1, 41, 1001),
    (9, 1, 5, 5), (9, 7, 9, 12), (9, 1, 66, 1925),
    (11, 1, 6, 11), (11, 7, 11, 13), (11, 1, 50, 970),
    (15, 1, 8, 8), (15, 7, 15, 16), (15, 1, 64, 968),
    (17, 1, 17, 20), (17, 1, 40, 979),
    (19, 1, 10, 19), (19, 7, 19, 24),
    (21, 1, 11, 13), (21, 1, 30, 45),
]


def planes(n, h, w, seed):
    """Random float32 planes with negatives, wide magnitudes and a few
    u8-like integers, so every tap's product and sum rounds."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w)).astype(np.float32)
    x *= rng.uniform(0.01, 300.0, (n, 1, 1)).astype(np.float32)
    x.reshape(-1)[::7] = rng.integers(0, 256, x.size)[::7]
    return x


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/ecc_blur.cu built for the host with g++ and the shim."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    d = tmp_path_factory.mktemp("ecc_blur_host")
    (d / "cuda_runtime.h").write_text(_SHIM.read_text())
    (d / "cuda_pipeline.h").write_text("#pragma once\n"
                                       "#include <cuda_runtime.h>\n")
    (d / "ecc_blur.cpp").write_text(
        host_launches((_CSRC / "ecc_blur.cu").read_text()))
    lib = d / "libecc_blur_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off",
                    "-fno-fast-math", "-fPIC", "-shared", "-I", str(d),
                    "-o", str(lib), str(d / "ecc_blur.cpp")],
                   check=True, capture_output=True)
    h = ctypes.CDLL(str(lib))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    h.gaussian_prefilter.argtypes = [vp] * 3 + [ci] * 4 + [vp]
    h.gaussian_prefilter.restype = ci
    return h


def host_blur(h, x, ksize, offset=0):
    """The host build on ``x`` [N,H,W] float32, the planes starting
    ``offset`` floats into their buffer (and the output into its own)."""
    n_, hh, ww = x.shape
    src = np.zeros(x.size + offset, np.float32)
    src[offset:] = x.reshape(-1)
    dst = np.full(x.size + offset, np.nan, np.float32)
    taps = np.asarray(filters.gaussian_kernel(ksize), np.float32)
    err = h.gaussian_prefilter(
        src.ctypes.data + 4 * offset, dst.ctypes.data + 4 * offset,
        taps.ctypes.data, n_, hh, ww, ksize // 2, None)
    assert err == 0
    return dst[offset:].reshape(x.shape)


@pytest.mark.parametrize("ksize,n_,h,w", CASES)
def test_host_kernel_bitwise(host_lib, ksize, n_, h, w):
    x = planes(n_, h, w, seed=ksize * 1000 + h * 10 + w)
    want = filters.gaussian_blur(torch.from_numpy(x), ksize).numpy()
    got = host_blur(host_lib, x, ksize)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("ksize,w", [(5, 44), (5, 1000), (9, 1924)])
def test_host_kernel_unaligned_planes(host_lib, ksize, w):
    """A plane one float past a 16-byte boundary: W % 4 == 0, yet every
    row copies and stores by scalars."""
    x = planes(3, 37, w, seed=w)
    want = filters.gaussian_blur(torch.from_numpy(x), ksize).numpy()
    got = host_blur(host_lib, x, ksize, offset=1)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("bad", [(5, 0, 5, 5), (5, 1, 2, 9), (5, 1, 9, 2),
                                 (3, 1, 1, 4), (3, 70000, 4, 4)])
def test_host_kernel_refuses(host_lib, bad):
    """N outside 1..65535, or H or W at most the radius."""
    ksize, n_, h, w = bad
    buf = np.zeros(16, np.float32)
    taps = np.asarray(filters.gaussian_kernel(ksize), np.float32)
    assert host_lib.gaussian_prefilter(buf.ctypes.data, buf.ctypes.data,
                                       taps.ctypes.data, n_, h, w,
                                       ksize // 2, None) != 0


@pytest.mark.parametrize("ksize,shape", [(1, (1, 3, 4)), (5, (2, 9, 13)),
                                         (7, (1, 4, 4)), (9, (3, 16, 10))])
def test_cpu_tensor_takes_the_plain_version(monkeypatch, ksize, shape):
    x = torch.from_numpy(planes(*shape, seed=ksize))
    calls = []
    plain = filters.gaussian_blur

    def spy(img, k, *args, **kw):
        calls.append((img, k))
        return plain(img, k, *args, **kw)

    monkeypatch.setattr(filters, "gaussian_blur", spy)
    got = ecc_cuda.gaussian_prefilter(x, ksize)
    assert len(calls) == 1 and calls[0][0] is x and calls[0][1] == ksize
    assert torch.equal(got, plain(x, ksize))


@pytest.mark.parametrize("x,ksize,match", [
    (torch.zeros(2, 8, 8, dtype=torch.float64), 5, "float32"),
    (torch.zeros(8, 8, dtype=torch.uint8), 5, "float32"),
    (torch.zeros(8, 8), 5, r"\[N,H,W\]"),
    (torch.zeros(1, 2, 8, 8), 5, r"\[N,H,W\]"),
    (torch.zeros(2, 8, 8).transpose(1, 2), 5, "contiguous"),
    (torch.zeros(2, 8, 8), 4, "odd"),
    (torch.zeros(2, 8, 8), 0, "odd"),
    (torch.zeros(2, 8, 8), -3, "odd"),
    (torch.zeros(2, 2, 8), 5, "radius"),
    (torch.zeros(2, 8, 2), 5, "radius"),
    (torch.zeros(2, 7, 7), 15, "radius"),
])
def test_wrapper_refuses(x, ksize, match):
    with pytest.raises(ValueError, match=match):
        ecc_cuda.gaussian_prefilter(x, ksize)
