"""RANSAC's refit kernels (``ops/ransac_cuda.py``, ``csrc/ransac_refit.cu``)
on the CPU.

``csrc/ransac_refit.cu`` compiled for the host with ``g++`` through
``tests/_cuda_host_shim.h`` (each block's lanes as coroutines that switch
at ``__syncthreads``), against its plain versions ``ops/ransac.py``
``_dlt_least_squares`` and ``_gauss_newton_refine`` on 4K-sized
correspondences (19 frames of 500 slots, ~165 of them valid, 0.3 px of
noise and a few gross outliers, the RANSAC inliers as weights).  The
kernels compute in float64 and return float32, so the bars are at the
image corners (3840 x 2160, in pixels, after the DLT's normalisation is
undone):

- against the plain versions run in float64 on the same inputs: 1e-3 px,
  the float32 output's rounding (an entry near 1 rounds by up to 6e-8,
  ~2.5e-4 px at a 4K corner; read 1.1e-4 / 2.2e-4);
- against the plain versions in float32, the path's own: 0.01 px (the
  float32 ``eigh`` of a Gram whose least eigenvalue is far below its
  rounding, and a float32 polish that stops short of the float64
  optimum; read up to 0.0049 px for either over 12 seeds).

One frame of the 4K keypoint cell read on the card
(``data/ransac_refit_frame.json``, 173 correspondences) is the one of
456 whose answer moved most with the kernels, 0.0136 px from the
float32 plain versions': there the float64 plain versions land within
1e-3 px of the kernels' answer and the float32 answer lies 0.0137 px
from that optimum, at a larger weighted error, so the float32 polish
stopped short.

Degenerate lanes (no weight, no slot, no step) give the plain versions'
answers, and the wrapper refuses what the kernels do not take.
``tests/test_torch_cuda.py`` runs :data:`SEEDS` on the card.
"""

import ctypes
import json
import math
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_warp_design import host_launches  # noqa: E402
from libstacker_tpu_torch.ops import ransac, ransac_cuda  # noqa: E402

_SHIM = Path(__file__).with_name("_cuda_host_shim.h")
_CSRC = Path(ransac.__file__).parents[1] / "csrc"

W, H = 3840.0, 2160.0
CORNERS = np.array([[0, 0], [W, 0], [0, H], [W, H]], np.float64)
SEEDS = [0, 1, 2, 3, 4, 5]
# px at the corners: against the float64 plain versions, and the float32
BAR64, BAR32 = 1e-3, 0.01
_FRAME = Path(__file__).with_name("data") / "ransac_refit_frame.json"


def correspondences(seed, b=19, m=500):
    """``(src, dst, valid)`` of ``b`` frames of ``m`` slots under small
    rotations and shifts (the bench's handheld bursts): 150-180 valid
    slots a frame with 0.3 px of noise and 5 gross outliers; the other
    slots hold points too, as the matcher's padding does."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, [W, H], (b, m, 2)).astype(np.float32)
    dst = rng.uniform(0, [W, H], (b, m, 2)).astype(np.float32)
    valid = np.zeros((b, m), bool)
    for i in range(b):
        a = np.deg2rad(rng.uniform(-0.6, 0.6))
        sh = rng.uniform(-6, 6, 2)
        h = np.array([[math.cos(a), -math.sin(a), sh[0]],
                      [math.sin(a), math.cos(a), sh[1]],
                      [rng.normal(0, 1e-7), rng.normal(0, 1e-7), 1.0]])
        n = int(rng.integers(150, 180))
        s = rng.uniform(40, [W - 40, H - 40], (n, 2))
        p = np.c_[s, np.ones(n)] @ h.T
        d = p[:, :2] / p[:, 2:] + rng.normal(0, 0.3, (n, 2))
        out = rng.choice(n, 5, replace=False)
        d[out] += rng.uniform(50, 500, (5, 2))
        src[i, :n], dst[i, :n], valid[i, :n] = s, d, True
    return (torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(valid))


def cell_frame():
    """The card's frame of ``data/ransac_refit_frame.json``: ``(record,
    src, dst, weights)``, the points ``[1,M,2]`` float32."""
    rec = json.loads(_FRAME.read_text())
    src, dst, wts = (torch.tensor(rec[k], dtype=torch.float32)[None]
                     for k in ("src", "dst", "weights"))
    return rec, src, dst, wts


def refit64(src, dst, wts, iters):
    """The whole refit by the plain versions in float64: the DLT on the
    normalised points, in pixels, then the polish."""
    p = ransac._points(src, dst, torch.ones(wts.shape, dtype=torch.bool))
    h = ransac._normalise_h22(
        p.t_dst_inv.double() @ ransac._dlt_plain(
            p.src_n.double(), p.dst_n.double(), wts.double())
        @ p.t_src.double())
    return ransac._refine_plain(h, src.double(), dst.double(), wts.double(),
                                iters)


def weighted_sse(h, src, dst, wts) -> float:
    err = ransac._sq_reproj_error(torch.as_tensor(h).double()[None],
                                  src.double(), dst.double())
    return float((wts.double() * err).sum())


def refit_inputs(seed):
    """The refit's inputs as ``find_homography`` makes them: the points,
    their normalisation, the RANSAC inliers as weights and the start of
    the polish (the float32 DLT, in pixels)."""
    src, dst, valid = correspondences(seed)
    p = ransac._points(src, dst, valid)
    res = ransac.find_homography(src, dst, valid,
                                 torch.Generator().manual_seed(seed))
    wts = res.inliers.to(torch.float32)
    start = ransac._normalise_h22(p.t_dst_inv @ ransac._dlt_least_squares(
        p.src_n, p.dst_n, wts) @ p.t_src)
    return p, wts, start


def corner_gap(a, b) -> float:
    """Largest distance in px between where ``[B,3,3]`` ``a`` and ``b``
    map the image corners."""
    out = 0.0
    for ha, hb in zip(np.asarray(a, np.float64), np.asarray(b, np.float64)):
        pa = np.c_[CORNERS, np.ones(4)] @ ha.T
        pb = np.c_[CORNERS, np.ones(4)] @ hb.T
        out = max(out, float(np.abs(pa[:, :2] / pa[:, 2:]
                                    - pb[:, :2] / pb[:, 2:]).max()))
    return out


def pixels(p, h_n):
    """A normalised-coordinates DLT answer in pixels, in float64."""
    return (p.t_dst_inv.double() @ torch.as_tensor(h_n).double()
            @ p.t_src.double()).numpy()


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/ransac_refit.cu built for the host with g++ and the shim."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    d = tmp_path_factory.mktemp("ransac_refit_host")
    (d / "cuda_runtime.h").write_text(_SHIM.read_text())
    (d / "ransac_refit.cpp").write_text(
        host_launches((_CSRC / "ransac_refit.cu").read_text()))
    lib = d / "libransac_refit_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off",
                    "-fno-fast-math", "-fPIC", "-shared", "-I", str(d),
                    "-o", str(lib), str(d / "ransac_refit.cpp")],
                   check=True, capture_output=True)
    h = ctypes.CDLL(str(lib))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    h.ransac_dlt.argtypes = [vp] * 4 + [ci] * 2 + [vp]
    h.ransac_dlt.restype = ci
    h.ransac_refine.argtypes = [vp] * 5 + [ci] * 3 + [vp]
    h.ransac_refine.restype = ci
    return h


def _f32(x):
    return np.ascontiguousarray(np.asarray(x, np.float32))


def host_dlt(lib, src, dst, w):
    src, dst, w = _f32(src), _f32(dst), _f32(w)
    out = np.full((src.shape[0], 3, 3), np.nan, np.float32)
    assert lib.ransac_dlt(src.ctypes.data, dst.ctypes.data, w.ctypes.data,
                          out.ctypes.data, src.shape[0], src.shape[1],
                          None) == 0
    return out


def host_refine(lib, h, src, dst, w, iters=10):
    h, src, dst, w = _f32(h), _f32(src), _f32(dst), _f32(w)
    out = np.full(h.shape, np.nan, np.float32)
    assert lib.ransac_refine(h.ctypes.data, src.ctypes.data, dst.ctypes.data,
                             w.ctypes.data, out.ctypes.data, src.shape[0],
                             src.shape[1], iters, None) == 0
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_host_dlt_near_plain(host_lib, seed):
    p, wts, _ = refit_inputs(seed)
    got = pixels(p, host_dlt(host_lib, p.src_n, p.dst_n, wts))
    plain64 = ransac._dlt_least_squares(p.src_n.double(), p.dst_n.double(),
                                        wts.double())
    plain32 = ransac._dlt_least_squares(p.src_n, p.dst_n, wts)
    assert corner_gap(got, pixels(p, plain64)) < BAR64
    assert corner_gap(got, pixels(p, plain32)) < BAR32


@pytest.mark.parametrize("seed", SEEDS)
def test_host_refine_near_plain(host_lib, seed):
    p, wts, start = refit_inputs(seed)
    got = host_refine(host_lib, start, p.src, p.dst, wts)
    plain64 = ransac._gauss_newton_refine(start.double(), p.src.double(),
                                          p.dst.double(), wts.double())
    plain32 = ransac._gauss_newton_refine(start, p.src, p.dst, wts)
    assert corner_gap(got, plain64) < BAR64
    assert corner_gap(got, plain32) < BAR32
    # the polish moved the start, and toward the plain answer
    assert corner_gap(start, plain64) > corner_gap(got, plain64)


def test_cell_frame_float32_polish_stopped_short():
    rec, src, dst, wts = cell_frame()
    h64 = refit64(src, dst, wts, rec["iters"])
    kernels, f32 = np.asarray([rec["h"]]), np.asarray([rec["h_f32"]])
    assert corner_gap(kernels, h64) < BAR64
    assert corner_gap(f32, h64) > BAR32
    assert corner_gap(f32, kernels) > BAR32
    sse64 = weighted_sse(h64[0], src, dst, wts)
    assert weighted_sse(rec["h"], src, dst, wts) - sse64 < 1e-4
    assert weighted_sse(rec["h_f32"], src, dst, wts) - sse64 > 1e-3


def test_host_refine_on_cell_frame(host_lib):
    """The polish kernel through the shim from the card's start: the
    float64 optimum, as on the card."""
    rec, src, dst, wts = cell_frame()
    got = host_refine(host_lib, np.asarray([rec["start"]]), src, dst, wts,
                      rec["iters"])
    assert corner_gap(got, refit64(src, dst, wts, rec["iters"])) < BAR64
    assert corner_gap(got, [rec["h"]]) < BAR64


@pytest.mark.parametrize("case", ["no_weight", "no_slot", "no_step"])
def test_host_degenerate_lanes(host_lib, case):
    """No weight: the DLT's zero Gram gives the first unit vector over
    1e-12 (as ``eigh`` of zeros), and no polish step is kept; no slot:
    the same on ``[B,0,2]``; no step: the start, bitwise."""
    p, wts, start = refit_inputs(9)
    src_n, dst_n, src, dst = p.src_n, p.dst_n, p.src, p.dst
    iters = 0 if case == "no_step" else 10
    if case != "no_step":
        wts = torch.zeros_like(wts)
    if case == "no_slot":
        src_n, dst_n, src, dst = (x[:, :0] for x in (src_n, dst_n, src, dst))
        wts = wts[:, :0]
    got = host_refine(host_lib, start, src, dst, wts, iters)
    np.testing.assert_array_equal(got, start.numpy())
    if case == "no_step":
        return
    plain = ransac._dlt_least_squares(src_n, dst_n, wts).numpy()
    np.testing.assert_allclose(host_dlt(host_lib, src_n, dst_n, wts), plain,
                               rtol=1e-6)


def test_wrapper_refuses():
    p, wts, start = refit_inputs(0)
    with pytest.raises(ValueError, match="CUDA"):
        ransac_cuda.dlt(p.src_n, p.dst_n, wts)
    with pytest.raises(ValueError, match="CUDA"):
        ransac_cuda.refine(start, p.src, p.dst, wts)
    with pytest.raises(ValueError, match="weights"):
        ransac_cuda._check(p.src, p.dst, wts[:, :7])
    with pytest.raises(ValueError, match="one \\[B,M,2\\] shape"):
        ransac_cuda._check(p.src, p.dst[:3], wts)
