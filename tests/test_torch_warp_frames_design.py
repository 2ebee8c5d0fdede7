"""Kernel B5's accumulate and frames forms (``libstacker_tpu_torch/csrc/
warp.cu`` ``accum_kernel`` and ``frames_kernel``, one per-pixel body),
compiled for the host with ``g++`` through ``tests/_cuda_host_shim.h`` as
``tests/test_torch_warp_design.py`` builds it, bitwise against
``ops/warp_cuda.warp_frames_reference`` on the CPU (the frames form with
``valid=None``, each warp's span stored through its shared buffer):

- all six border modes (BORDER_TRANSPARENT as the wrapper launches it,
  CONSTANT 0) and both quantisations;
- u8, u16 and f32 frames of 1, 3 and 4 channels (3 is its own
  instance);
- the map kinds of ``tests/test_torch_warp_accum_design.py``
  (``_host_maps``: ties and near ties of the 1/32 rounding, rows where
  ``sw == 0``, coordinates on the edges, every tap far off the frame,
  30-degree and strongly perspective maps) and shifts by +-3/64 px;
- widths that are not a multiple of a thread's pixels (1, 5, 33, 6001),
  and 164, a multiple of 4 (the frames form's 16-byte stores);
- the accumulate form's dropped frames with non-finite maps, inside a
  block's staged chunk of maps and across two chunks (35 frames), and
  fractional weights (the frames form warps every frame);
- row origins: a strip from two rows below the frame's top, and one from
  two rows above it (a mesh's first band).

``tests/test_torch_cuda.py`` runs :func:`frames_cases` on the card
through the wrapper, in both forms.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_warp_accum_design import _host_maps  # noqa: E402
from test_torch_warp_design import MODES, bitwise, build_host  # noqa: E402
from libstacker_tpu_torch.ops import color, warp_cuda  # noqa: E402

KINDS = ("ties", "near_ties", "horizon", "edges", "far", "rot30", "strong",
         "shift")
# (frames, height, width) -> row origins (oy0, sy0): 35 frames cross the
# kernel's staged chunks; a strip from 2 rows below the frame's top and
# one from 2 rows above it; a width of a multiple of 4 past a block's
# columns (the frames form's 16-byte stores, a ragged last span)
SHAPES = {(2, 9, 1): (0, 0), (3, 7, 5): (4, 2), (2, 17, 33): (1, -2),
          (35, 4, 6): (0, 0), (1, 3, 6001): (0, 0), (2, 5, 164): (3, 1)}
# (dtype, channels); a host test takes the first three or the last three
TYPES = ((torch.uint8, 3), (torch.uint16, 1), (torch.float32, 4),
         (torch.uint8, 4), (torch.float32, 3), (torch.uint16, 3))


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    return build_host(tmp_path_factory)


def _weights(n):
    """valid[n]: dropped frames inside a chunk and on both sides of the
    first chunk's end (32), the others 1 or fractional."""
    w = torch.tensor([(1.0, 0.0, 0.5, 1.0, 0.25, 0.0, 1.0)[i % 7]
                      for i in range(n)])
    if n > 33:
        w[31] = w[32] = 0.0
    return w


def frames_cases(kind, dtype, c, drop=True):
    """B5a's inputs for one map kind, type and channel count, as ``(frames,
    minv, valid, border_value, rows)`` on the CPU: each shape of
    ``SHAPES`` with its row origins; with ``drop`` the dropped frames
    carry non-finite maps, which the kernel must never read."""
    cases = []
    for (n, h, w), rows in SHAPES.items():
        rng = np.random.default_rng(n * 100000 + h * 1000 + w + c)
        raw = rng.integers(0, 256, (n, h, w, c), np.uint8)
        frames = torch.from_numpy(raw)
        if dtype == torch.uint16:
            frames = (frames.to(torch.int32) * 257
                      + torch.from_numpy(rng.integers(0, 257, raw.shape))
                      ).to(torch.uint16)
        elif dtype == torch.float32:
            frames = color.to_unit_f32(frames)
        if kind == "shift":
            e = np.float32(3 / 64)
            minv = torch.from_numpy(np.stack([
                np.array([[1, 0, e * sx], [0, 1, e * sy], [0, 0, 1]],
                         np.float32)
                for sx, sy in ((1, 1), (-1, -1), (1, -1), (-1, 1))
            ] * n)[:n])
        else:
            minv = _host_maps(kind, n, h, w)
        valid = _weights(n)
        minv = minv.clone()
        if drop:
            minv[valid == 0] = float("nan")
        cases.append((frames.contiguous(), minv.contiguous(), valid,
                      [0.1, -0.2, 0.3, 0.7][:c], rows))
    return cases


def _host_accum(host, frames, minv, valid, border, mode, qa, rows):
    """The host build's warp_frames with ``valid``, launched as the
    wrapper launches it (BORDER_TRANSPARENT as CONSTANT 0)."""
    n, h, w, c = frames.shape
    if mode == "transparent":
        mode, border = "constant", [0.0] * c
    out = torch.empty((h, w, c), dtype=torch.float32)
    bv = (ctypes.c_float * c)(*border)
    assert host.warp_frames(
        ctypes.c_void_p(frames.data_ptr()), ctypes.c_void_p(minv.data_ptr()),
        bv, ctypes.c_void_p(valid.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        n, h, w, c, warp_cuda._DTYPE_CODE[frames.dtype],
        warp_cuda._MODE_CODE[mode], int(not qa), warp_cuda._SCALE[frames.dtype],
        rows[0], rows[1], None) == 0
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", MODES)
def test_accum_kernel_source_on_host(host_kernel, mode, kind):
    half = len(TYPES) // 2
    for dtype, c in TYPES[half:] if KINDS.index(kind) % 2 else TYPES[:half]:
        for frames, minv, valid, border, rows in frames_cases(kind, dtype, c):
            for qa in (False, True):
                got = _host_accum(host_kernel, frames, minv, valid, border,
                                  mode, qa, rows)
                want = warp_cuda.warp_frames_reference(
                    frames, minv, border, mode, qa, valid, rows)
                assert bitwise(got, want), (dtype, c, frames.shape, qa, rows)


def _host_frames(host, frames, minv, border, mode, qa, rows):
    """The host build's warp_frames with ``valid`` null (the frames form),
    launched as the wrapper launches it."""
    n, h, w, c = frames.shape
    if mode == "transparent":
        mode, border = "constant", [0.0] * c
    out = torch.full((n, h, w, c), float("nan"), dtype=torch.float32)
    bv = (ctypes.c_float * c)(*border)
    assert host.warp_frames(
        ctypes.c_void_p(frames.data_ptr()), ctypes.c_void_p(minv.data_ptr()),
        bv, None, ctypes.c_void_p(out.data_ptr()), n, h, w, c,
        warp_cuda._DTYPE_CODE[frames.dtype], warp_cuda._MODE_CODE[mode],
        int(not qa), warp_cuda._SCALE[frames.dtype], rows[0], rows[1],
        None) == 0
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", MODES)
def test_frames_kernel_source_on_host(host_kernel, mode, kind):
    """The frames form: every element of every frame written (the output
    starts as NaN), each bitwise the plain version's."""
    half = len(TYPES) // 2
    for dtype, c in TYPES[:half] if KINDS.index(kind) % 2 else TYPES[half:]:
        for frames, minv, _, border, rows in frames_cases(kind, dtype, c,
                                                          drop=False):
            for qa in (False, True):
                got = _host_frames(host_kernel, frames, minv, border, mode,
                                   qa, rows)
                want = warp_cuda.warp_frames_reference(
                    frames, minv, border, mode, qa, None, rows)
                assert bitwise(got, want), (dtype, c, frames.shape, qa, rows)
