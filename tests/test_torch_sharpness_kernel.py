"""The one-pass sharpness kernel (``ops/sharpness_cuda.sharpness_sums``,
``csrc/sharpness.cu``) on the CPU.

- ``csrc/sharpness.cu`` compiled for the host with ``g++`` through
  ``tests/_cuda_host_shim.h`` (cp.async as a plain copy; each block's
  lanes as coroutines that switch at ``__syncthreads``), against the
  plain version ``sharpness_sums_reference`` on :data:`CASES`: u8, u16
  and float32 at every TENG ksize, N 1 and 5, H and W at R + 1 and 3,
  odd widths, widths across a block's 768-column strip, a tall frame cut
  into row segments, and frames one element off their quads' alignment
  (scalar staging).  For u8 at ksize 1 and 3 every sum is an exact
  integer (a quarter for LAPM), so the sums and the metrics are equal;
  elsewhere each sum lies within rel 1e-12 (``sum lap``, which cancels,
  within 1e-12 of sqrt(n sum lap^2), a bound on sum |lap|).
- The host build's u8 metrics within rel 1e-7 of the cv2 float64 oracles
  of ``tests/test_torch_sharpness.py`` (the float32 rounding of the
  result alone), and its TENG order that of the oracle.
- The wrapper's guards, on every device: a wrong dtype or rank, a
  non-contiguous input, H or W at most the reflect radius, and a k_size
  outside {1, 3, 5, 7} with the reference's message.

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
from libstacker_tpu_torch import errors  # noqa: E402
from libstacker_tpu_torch.ops import sharpness, sharpness_cuda  # noqa: E402

_SHIM = Path(__file__).with_name("_cuda_host_shim.h")
_CSRC = Path(sharpness_cuda.__file__).parents[1] / "csrc"
DTYPES = {"u8": np.uint8, "u16": np.uint16, "f32": np.float32}
CODES = {"u8": 0, "u16": 1, "f32": 2}


def _radius(k):
    return max(1, k // 2)


def _cases():
    """(dtype, k, N, H, W, offset): the least frames, odd widths, strips
    crossed, a tall frame's row segments, aligned and one element off."""
    out = []
    for k in (1, 3, 5, 7):
        r = _radius(k)
        least = max(3, r + 1)
        for dt in DTYPES:
            out += [(dt, k, 1, r + 1, r + 1, 0), (dt, k, 5, least, least, 0),
                    (dt, k, 5, 37, 53, 0), (dt, k, 1, 70, 1537, 0),
                    (dt, k, 2, 300, 41, 0), (dt, k, 3, 29, 772, 0),
                    (dt, k, 3, 29, 772, 1)]
    return out


CASES = _cases()


def frames(dtype, n, h, w, seed):
    """Grey frames of ``dtype``: full-range noise, a blurred copy and a
    flat frame; float32 with fractions, so its products round."""
    rng = np.random.default_rng(seed)
    if dtype == "f32":
        x = rng.uniform(0.0, 1000.0, (n, h, w)).astype(np.float32)
    else:
        top = 256 if dtype == "u8" else 65536
        x = rng.integers(0, top, (n, h, w)).astype(DTYPES[dtype])
    if n > 1:
        x[1] = ((x[1].astype(np.float64) + np.roll(x[1], 1, 0)
                 + np.roll(x[1], 1, 1)) / 3).astype(x.dtype)
    if n > 2:
        x[2] = x[2].flat[0]
    return x


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/sharpness.cu built for the host with g++ and the shim."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    d = tmp_path_factory.mktemp("sharpness_host")
    (d / "cuda_runtime.h").write_text(_SHIM.read_text())
    (d / "cuda_pipeline.h").write_text("#pragma once\n"
                                       "#include <cuda_runtime.h>\n")
    (d / "sharpness.cpp").write_text(
        host_launches((_CSRC / "sharpness.cu").read_text()))
    lib = d / "libsharpness_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off",
                    "-fno-fast-math", "-fPIC", "-shared", "-I", str(d),
                    "-o", str(lib), str(d / "sharpness.cpp")],
                   check=True, capture_output=True)
    h = ctypes.CDLL(str(lib))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    h.sharpness_slots.argtypes = [ci] * 5
    h.sharpness_slots.restype = ci
    h.sharpness_metrics.argtypes = [vp] * 4 + [ci] * 5 + [vp]
    h.sharpness_metrics.restype = ci
    return h


def host_sums(h, x, dtype, k, offset=0):
    """The host build on ``x`` [N,H,W], the frames starting ``offset``
    elements into their buffer: (sums [N,6], metrics [4,N])."""
    n_, hh, ww = x.shape
    code = CODES[dtype]
    slots = h.sharpness_slots(n_, hh, ww, code, k)
    assert slots > 0
    src = np.zeros(x.size + offset, x.dtype)
    src[offset:] = x.reshape(-1)
    partials = np.full(n_ * slots * 6, np.nan)
    sums = np.full((n_, 6), np.nan)
    metrics = np.full((4, n_), np.nan, np.float32)
    err = h.sharpness_metrics(src.ctypes.data + offset * x.itemsize,
                              partials.ctypes.data, sums.ctypes.data,
                              metrics.ctypes.data, n_, hh, ww, code, k, None)
    assert err == 0
    return sums, metrics


def assert_sums_match(got, want, exact):
    """Equal where the sums are exact, else rel 1e-12 (``sum lap``
    against sqrt(n sum lap^2), its terms' bound).  ``want`` [N,6]."""
    got, want = np.asarray(got), np.asarray(want)
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    for q in (0, 2, 3, 4, 5):
        np.testing.assert_allclose(got[:, q], want[:, q], rtol=1e-12,
                                   atol=0.0, err_msg=sharpness_cuda.SUMS[q])
    # sqrt(N_px * sum lap^2) >= sum |lap| (Cauchy-Schwarz); N_px <= 1e6
    scale = np.sqrt(1e6 * want[:, 2])
    assert np.all(np.abs(got[:, 1] - want[:, 1]) <= 1e-12 * scale + 1e-300)


def exact(dtype, k):
    return dtype == "u8" and k <= 3


@pytest.mark.parametrize("case", CASES)
def test_host_kernel_matches_plain(host_lib, case):
    dtype, k, n_, h, w, offset = case
    x = frames(dtype, n_, h, w, seed=k * 100 + h + w + offset)
    want_s, want_m = sharpness_cuda.sharpness_sums_reference(
        torch.from_numpy(x), k)
    got_s, got_m = host_sums(host_lib, x, dtype, k, offset)
    assert_sums_match(got_s, want_s.numpy(), exact(dtype, k))
    # the finalisation is the plain one, bit for bit, on the kernel's sums
    fin = sharpness_cuda.metrics_from_sums(torch.from_numpy(got_s), h * w)
    np.testing.assert_array_equal(got_m.view(np.uint32),
                                  fin.numpy().view(np.uint32))


@pytest.mark.parametrize("bad", [(0, 5, 5, 0, 3), (1, 1, 5, 0, 3),
                                 (1, 5, 1, 0, 3), (1, 3, 9, 0, 7),
                                 (1, 9, 3, 0, 7), (1, 5, 5, 3, 3),
                                 (1, 5, 5, 0, 2), (1, 5, 5, 0, 9)])
def test_host_kernel_refuses(host_lib, bad):
    """N < 1, H or W at most the radius, an unknown dtype code or k."""
    n_, h, w, code, k = bad
    assert host_lib.sharpness_slots(n_, h, w, code, k) == 0
    buf = np.zeros(64)
    assert host_lib.sharpness_metrics(buf.ctypes.data, buf.ctypes.data,
                                      buf.ctypes.data, buf.ctypes.data, n_,
                                      h, w, code, k, None) != 0


def _oracle_batch():
    """``tests/test_torch_sharpness.py``'s ``batch``: [3,97,131] smoothed
    grey (u8) with one frame blurred."""
    import cv2

    rng = np.random.default_rng(97)
    raw = rng.integers(0, 256, (3, 97, 131), np.uint8)
    out = np.stack([cv2.GaussianBlur(f, (5, 5), 1.0) for f in raw])
    out[2] = cv2.GaussianBlur(out[2], (0, 0), 2.5)
    return out


@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_host_kernel_u8_matches_cv2(host_lib, noise_image, k):
    """Every metric within rel 1e-7 of the float64 oracles: the float32
    rounding of the result alone."""
    import test_torch_sharpness as ts

    x = np.concatenate([noise_image[None, :, :97], _oracle_batch()[:, :, :97]])
    _, m = host_sums(host_lib, np.ascontiguousarray(x), "u8", k)
    for i, f in enumerate(x):
        want = (ts._lapm_oracle(f), ts._lapv_oracle(f), ts._teng_oracle(f, k),
                ts._glvn_oracle(f))
        np.testing.assert_allclose(m[:, i], want, rtol=1e-7)


def test_host_kernel_teng_order_matches_cv2(host_lib):
    import test_torch_sharpness as ts

    x = _oracle_batch()
    _, m = host_sums(host_lib, x, "u8", 3)
    want = [ts._teng_oracle(f, 3) for f in x]
    np.testing.assert_array_equal(np.argsort(m[2], kind="stable"),
                                  np.argsort(want, kind="stable"))
    assert int(np.argmin(m[2])) == 2  # the blurred frame


@pytest.mark.parametrize("x,k,err,match", [
    (torch.zeros(2, 8, 8, dtype=torch.float64), 3, ValueError, "uint8"),
    (torch.zeros(2, 8, 8, dtype=torch.int32), 3, ValueError, "uint8"),
    (torch.zeros(8, 8, dtype=torch.uint8), 3, ValueError, r"\[N,H,W\]"),
    (torch.zeros(1, 2, 8, 8), 3, ValueError, r"\[N,H,W\]"),
    (torch.zeros(2, 8, 9).transpose(1, 2), 3, ValueError, "contiguous"),
    (torch.zeros(2, 1, 8), 3, ValueError, "radius"),
    (torch.zeros(2, 8, 1), 1, ValueError, "radius"),
    (torch.zeros(2, 3, 8), 7, ValueError, "radius"),
    (torch.zeros(2, 8, 2), 5, ValueError, "radius"),
    (torch.zeros(2, 8, 8), 0, errors.InvalidParamsError, "1, 3, 5, or 7"),
    (torch.zeros(2, 8, 8), 4, errors.InvalidParamsError, "1, 3, 5, or 7"),
    (torch.zeros(2, 8, 8), 9, errors.InvalidParamsError, "1, 3, 5, or 7"),
])
@pytest.mark.parametrize("fn", ["sharpness_sums", "sharpness_sums_reference"])
def test_wrapper_refuses(x, k, err, match, fn):
    with pytest.raises(err, match=match):
        getattr(sharpness_cuda, fn)(x, k)


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    x = torch.from_numpy(frames("u8", 3, 9, 13, seed=1))
    calls = []
    plain = sharpness_cuda.sharpness_sums_reference

    def spy(img, k):
        calls.append((img, k))
        return plain(img, k)

    monkeypatch.setattr(sharpness_cuda, "sharpness_sums_reference", spy)
    before = sharpness_cuda.launch_count
    sums, metrics = sharpness_cuda.sharpness_sums(x, 5)
    assert len(calls) == 1 and calls[0][0] is x and calls[0][1] == 5
    assert sharpness_cuda.launch_count == before
    want_s, want_m = plain(x, 5)
    assert torch.equal(sums, want_s) and torch.equal(metrics, want_m)
    assert sums.dtype == torch.float64 and tuple(sums.shape) == (3, 6)
    assert metrics.dtype == torch.float32 and tuple(metrics.shape) == (4, 3)


def test_plain_version_scores_in_chunks(monkeypatch):
    """The plain version's passes of ``_SCORE_CHUNK`` frames give the
    one-pass sums (u8: exact)."""
    x = torch.from_numpy(frames("u8", 5, 11, 17, seed=2))
    whole = sharpness_cuda.sharpness_sums_reference(x, 3)
    monkeypatch.setattr(sharpness, "_SCORE_CHUNK", 2)
    chunked = sharpness_cuda.sharpness_sums_reference(x, 3)
    assert torch.equal(whole[0], chunked[0])
    assert torch.equal(whole[1], chunked[1])


@pytest.mark.parametrize("dtype", [torch.int16, torch.float64, torch.bool])
def test_other_dtypes_are_scored_as_float32(dtype):
    x = torch.from_numpy(frames("u8", 2, 12, 15, seed=3) % 2).to(dtype)
    got = sharpness.sharpness_all(x, 3)
    want = sharpness.sharpness_all(x.to(torch.float32), 3)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_metrics_keep_the_leading_shape():
    x = torch.from_numpy(frames("u8", 6, 10, 12, seed=4)).reshape(2, 3, 10, 12)
    out = sharpness.sharpness_all(x, 1)
    flat = sharpness.sharpness_all(x.reshape(6, 10, 12), 1)
    for k in out:
        assert tuple(out[k].shape) == (2, 3)
        assert torch.equal(out[k].reshape(6), flat[k])
    one = sharpness.sharpness_tenengrad(x[0, 0], 1)
    assert one.shape == () and float(one) == float(flat["teng"][0])
