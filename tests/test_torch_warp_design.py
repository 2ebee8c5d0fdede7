"""Kernel B5's planar form (``libstacker_tpu_torch/csrc/warp.cu``
``warp_kernel``), compiled for the host with ``g++`` through
``tests/_cuda_host_shim.h`` (each block's lanes as coroutines that switch
at ``__syncthreads``), bitwise against ``ops/warp_cuda.
warp_bilinear_reference`` on the CPU:

- all six border modes (BORDER_TRANSPARENT as the wrapper launches it,
  CONSTANT 0) and both quantisations;
- maps built on rounding ties and near ties, rows where ``sw == 0``,
  coordinates on the edges, every tap far off the frame, 30-degree and
  strongly perspective maps, and shifts by +-3/64 px (every weight
  1/16 or 15/16: the last row and column tap just past the frame, the
  first just before it);
- widths that are not a multiple of a thread's pixels (1, 5, 33, 6001);
- the source grid and another one, slots sharing sources, runs of
  bitwise-equal maps on neighbouring slots (reused coordinates) beside
  unequal ones, across a block's staged slots, the border per slot or by
  value, and non-zero row origins, a negative strip origin included.

``tests/test_torch_cuda.py`` runs :func:`planar_cases` on the card
through the wrapper.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_warp_accum_design import _host_maps  # noqa: E402
from libstacker_tpu_torch.ops import warp_cuda  # noqa: E402

MODES = ("constant", "transparent", "replicate", "reflect", "reflect101",
         "wrap")
KINDS = ("ties", "near_ties", "horizon", "edges", "far", "rot30", "strong",
         "shift")
# (height, width) and the lengths of the runs of equal maps over the
# slots, one source plane a slot: 14 slots cross several blocks' staged
# slots
SHAPES = {(9, 1): (3, 2), (7, 5): (3, 1, 2, 4, 4), (17, 33): (1, 3, 2),
          (3, 6001): (2, 1)}

_SHIM = Path(__file__).with_name("_cuda_host_shim.h")
_CSRC = Path(warp_cuda.__file__).parents[1] / "csrc"
# a launch, its grid a number or a dim3(...), then its threads, dynamic
# shared bytes and stream
_LAUNCH = re.compile(r"(\w+(?:<[^;]*?>)?)<<<(dim3\((?:[^()]|\([^()]*\))*\)"
                     r"|[^,]+),\s*([^,]+),\s*([^,]+),.*?>>>\((.*?)\);", re.S)


def host_launches(source: str) -> str:
    """``source`` with each launch rewritten as the shim's host_grid
    call."""
    return _LAUNCH.sub(
        lambda m: (f"host_grid({m.group(2)}, {m.group(3)}, [&] "
                   f"{{ {m.group(1)}({m.group(5)}); }}, {m.group(4)});"),
        source)


def build_host(tmp_path_factory):
    """csrc/warp.cu built for the host with g++ and the shim (launches
    rewritten as shim calls; -ffp-contract=off as nvcc's --fmad=false),
    its ``warp_bilinear`` and ``warp_frames`` bound."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    d = tmp_path_factory.mktemp("warp_host")
    src = host_launches((_CSRC / "warp.cu").read_text())
    (d / "cuda_runtime.h").write_text(_SHIM.read_text())
    (d / "warp.cpp").write_text(src)
    lib = d / "libwarp_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off",
                    "-fno-fast-math", "-fPIC", "-shared", "-I", str(d),
                    "-I", str(_CSRC), "-o", str(lib), str(d / "warp.cpp")],
                   check=True, capture_output=True)
    h = ctypes.CDLL(str(lib))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    h.warp_bilinear.argtypes = ([vp] * 3 + [ctypes.c_float] + [vp] * 2
                                + [ci] * 9 + [vp])
    h.warp_bilinear.restype = ci
    h.warp_frames.argtypes = ([vp, vp, ctypes.POINTER(ctypes.c_float), vp,
                               vp] + [ci] * 7 + [ctypes.c_float, ci, ci, vp])
    h.warp_frames.restype = ci
    return h


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    return build_host(tmp_path_factory)


def planar_cases(kind, shape):
    """B5's inputs for one map kind and shape, as ``(src, minv,
    border_value, src_index, out_hw, rows)`` on the CPU: the source grid
    with a border per slot; another grid, shared sources and a border by
    value; strips with row origins, one starting above the frame as a
    mesh's first row band does."""
    h, w = shape
    runs = SHAPES[shape]
    g = sum(runs)
    rng = np.random.default_rng(h * 10000 + w)
    src = torch.from_numpy(rng.uniform(-1.0, 2.0, (g, h, w))
                           .astype(np.float32))
    if kind == "shift":
        e = np.float32(3 / 64)
        distinct = torch.from_numpy(np.stack([
            np.array([[1, 0, e * sx], [0, 1, e * sy], [0, 0, 1]], np.float32)
            for sx, sy in ((1, 1), (-1, -1), (1, -1), (-1, 1), (1, 1))
        ][:len(runs)]))
    else:
        distinct = _host_maps(kind, len(runs), h, w)
    minv = distinct.repeat_interleave(torch.tensor(runs), dim=0).contiguous()
    per_slot = torch.linspace(-0.5, 3.0, g)
    shared = torch.tensor([(3 * i + 1) % 2 for i in range(g)])
    return [(src, minv, per_slot, None, None, (0, 0)),
            (src, minv, 0.75, shared, (h + 2, w + 3), (0, 0)),
            (src, minv, per_slot, shared, (h + 1, w), (4, 2)),
            (src, minv, -1.5, None, (h, w + 1), (0, -2))]


def _host_warp(host, src, minv, border_value, src_index, out_hw, qa, mode,
               rows):
    """The host build's warp_bilinear, launched as the wrapper launches
    it (BORDER_TRANSPARENT as CONSTANT 0)."""
    g, (s_n, h, w) = minv.shape[0], src.shape
    oh, ow = out_hw or (h, w)
    if mode == "transparent":
        mode, border_value = "constant", 0.0
    per_slot = isinstance(border_value, torch.Tensor)
    bv = border_value.contiguous() if per_slot else None
    sidx = None if src_index is None else src_index.to(torch.int32)
    out = torch.empty((g, oh, ow), dtype=torch.float32)

    def ptr(t):
        return None if t is None else ctypes.c_void_p(t.data_ptr())

    assert host.warp_bilinear(
        ptr(src), ptr(minv), ptr(bv), 0.0 if per_slot else border_value,
        ptr(sidx), ptr(out), g, h, w, oh, ow,
        warp_cuda._MODE_CODE[mode], int(not qa), rows[0], rows[1], None) == 0
    return out


def bitwise(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", MODES)
def test_planar_kernel_source_on_host(host_kernel, mode, kind, shape):
    for case in planar_cases(kind, shape):
        src, minv, bv, sidx, out_hw, rows = case
        for qa in (False, True):
            got = _host_warp(host_kernel, src, minv, bv, sidx, out_hw, qa,
                             mode, rows)
            want = warp_cuda.warp_bilinear_reference(
                src, minv, bv, sidx, out_hw, qa, mode, rows)
            assert bitwise(got, want), (qa, out_hw, rows)

