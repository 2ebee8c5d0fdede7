"""The burst grey in one pass (``ops/color_cuda.grey``, ``csrc/grey.cu``).

On the CPU:

- ``csrc/grey.cu`` compiled for the host with ``g++`` through
  ``tests/_cuda_host_shim.h``, bitwise against the plain version
  ``grey_reference`` on :data:`CASES`: uint8 and uint16 RGB to uint8 and
  float32 grey, one pixel, bursts shorter than a block's step of 4096
  pixels (the scalar path alone), odd H and W, two whole steps, nine
  steps and a tail that one SM's grid walks twice, an empty burst, and
  the source or the destination one element off its 16-byte alignment
  (the scalar path);
- the plain version against the JAX package's ``rgb_to_gray_u8`` for
  uint8 and uint16, on a burst across ``_GREY_CHUNK`` and on one frame;
- ``burst_grey_f32`` bitwise ``burst_grey_u8(...).to(float32)``, scaled
  and unscaled, and ``rgb_to_gray_u8`` of a non-contiguous view;
- the wrapper's refusals: C != 3, float or int32 input, a non-contiguous
  tensor, an output other than uint8 / float32, fewer than 3 axes.

On the card (marked ``cuda``, skipped without one; run with
``python -m pytest --noconftest tests/test_torch_grey_kernel.py -q``):
the kernel bitwise against the plain version on the same shapes, on a
view at an offset that is not 16-byte aligned and on 2160x3840 frames;
one launch (``color_cuda.launch_count``) an unscaled ``ecc_match_arrays``
and ``keypoint_match_arrays``; the refusals on CUDA tensors.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_warp_design import host_launches  # noqa: E402
from libstacker_tpu_torch.ops import color, color_cuda  # noqa: E402

_SHIM = Path(__file__).with_name("_cuda_host_shim.h")
_CSRC = Path(color_cuda.__file__).parents[1] / "csrc"
IN = {"u8": np.uint8, "u16": np.uint16}
OUT = {"u8": torch.uint8, "f32": torch.float32}
# (N, H, W): one pixel; 15 pixels; 32; odd H and W (63); two steps of
# a block's 4096 pixels; nine steps and a tail of 2829 pixels, walked
# twice by the 8 blocks of one SM; empty
SHAPES = [(1, 1, 1), (1, 3, 5), (2, 4, 4), (1, 7, 9), (2, 64, 64),
          (3, 101, 131), (0, 5, 7)]
# (source offset, destination offset) in elements
OFFSETS = [(0, 0), (1, 0), (0, 1)]
CASES = [(i, o, s, off) for i in IN for o in OUT for s in SHAPES
         for off in OFFSETS]


def rgb(dtype, shape, seed):
    """Full-range RGB noise of ``dtype`` ``[*shape, 3]``, its first
    pixels black and white."""
    top = 256 if dtype == "u8" else 65536
    x = np.random.default_rng(seed).integers(0, top, (*shape, 3))
    flat = x.reshape(-1, 3)
    flat[:2] = np.array([[0, 0, 0], [top - 1] * 3])[: len(flat)]
    return x.astype(IN[dtype])


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/grey.cu built for the host with g++ and the shim."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    d = tmp_path_factory.mktemp("grey_host")
    (d / "cuda_runtime.h").write_text(_SHIM.read_text())
    (d / "grey.cpp").write_text(host_launches((_CSRC / "grey.cu").read_text()))
    lib = d / "libgrey_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off",
                    "-fno-fast-math", "-fPIC", "-shared", "-I", str(d),
                    "-o", str(lib), str(d / "grey.cpp")],
                   check=True, capture_output=True)
    h = ctypes.CDLL(str(lib))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    h.grey.argtypes = [vp, vp, ctypes.c_longlong, ci, ci, ci, vp]
    h.grey.restype = ci
    return h


def _aligned(n, dtype, offset):
    """A numpy buffer of ``n`` elements of ``dtype`` starting ``offset``
    elements past a 16-byte boundary."""
    item = np.dtype(dtype).itemsize
    raw = np.zeros((n + offset) * item + 16, np.uint8)
    start = (-raw.ctypes.data) % 16 + offset * item
    out = raw[start : start + n * item].view(dtype)
    assert n == 0 or out.ctypes.data % 16 == (offset * item) % 16
    return out


@pytest.mark.parametrize("in_dt, out_dt, shape, offsets", CASES)
def test_host_kernel_equals_plain(host_lib, in_dt, out_dt, shape, offsets):
    x = rgb(in_dt, shape, seed=sum(shape) + len(in_dt))
    src = _aligned(x.size, x.dtype, offsets[0])
    src[:] = x.reshape(-1)
    out_np = np.uint8 if out_dt == "u8" else np.float32
    pixels = x.size // 3
    dst = _aligned(pixels, out_np, offsets[1])
    dst[:] = 77
    err = host_lib.grey(src.ctypes.data, dst.ctypes.data, pixels,
                        color_cuda.IN_DTYPES[torch.from_numpy(x).dtype],
                        color_cuda.OUT_DTYPES[OUT[out_dt]], 1, None)
    assert err == 0
    want = color_cuda.grey_reference(torch.from_numpy(x), OUT[out_dt])
    got = torch.from_numpy(dst.copy()).view(tuple(shape))
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


def test_host_kernel_refuses_bad_codes(host_lib):
    buf = np.zeros(48, np.uint8)
    p = buf.ctypes.data
    for args in ((-1, 0, 0, 1), (16, 2, 0, 1), (16, 0, 2, 1), (16, 0, 0, 0)):
        assert host_lib.grey(p, p, *args, None) != 0


@pytest.mark.parametrize("dtype", ["u8", "u16"])
@pytest.mark.parametrize("shape", [(18, 9, 11), (9, 11)])
def test_plain_equals_jax_package(dtype, shape):
    if torch.cuda.is_available():
        pytest.skip("the JAX package is the CPU reference; not run beside "
                    "a card")
    jnp = pytest.importorskip("jax.numpy")
    from libstacker_tpu.ops import color as jcolor

    x = rgb(dtype, shape, seed=5)
    got = color_cuda.grey_reference(torch.from_numpy(x))
    want = np.asarray(jcolor.rgb_to_gray_u8(jnp.asarray(x)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    got_f = color_cuda.grey_reference(torch.from_numpy(x), torch.float32)
    np.testing.assert_array_equal(got_f.numpy(), want.astype(np.float32))


@pytest.mark.parametrize("dtype", ["u8", "u16"])
@pytest.mark.parametrize("scale_hw", [None, (20, 30), (13, 7)])
def test_burst_grey_f32_is_the_widened_u8_grey(dtype, scale_hw):
    frames = torch.from_numpy(rgb(dtype, (18, 40, 60), seed=9))
    want = color.burst_grey_u8(frames, scale_hw).to(torch.float32)
    got = color.burst_grey_f32(frames, scale_hw)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(color.burst_grey_u8(frames),
                       color.rgb_to_gray_u8(frames))


def test_rgb_to_gray_u8_takes_a_view():
    frames = torch.from_numpy(rgb("u8", (4, 10, 24), seed=3))
    view = frames[:, :, ::2]
    assert not view.is_contiguous()
    assert torch.equal(color.rgb_to_gray_u8(view),
                       color.rgb_to_gray_u8(view.contiguous()))


def _refused(device):
    x = torch.zeros((2, 6, 8, 3), dtype=torch.uint8, device=device)
    return [
        (torch.zeros((2, 6, 8, 4), dtype=torch.uint8, device=device),
         torch.uint8),
        (torch.zeros((2, 6, 8, 1), dtype=torch.uint8, device=device),
         torch.uint8),
        (x.float(), torch.float32),
        (x.to(torch.int32), torch.uint8),
        (x[:, :, ::2], torch.uint8),
        (x, torch.int32),
        (x, torch.float64),
        (x[0, 0], torch.uint8),
    ]


@pytest.mark.parametrize("case", range(8))
def test_wrapper_refuses_on_cpu(case):
    x, out_dtype = _refused("cpu")[case]
    with pytest.raises(ValueError):
        color_cuda.grey(x, out_dtype)
    with pytest.raises(ValueError):
        color_cuda.grey_reference(x, out_dtype)


# --- on the card --------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (csrc/grey.cu has no CPU mode)")
    return torch.device("cuda")


CARD_SHAPES = SHAPES + [(2, 37, 53), (17, 64, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("in_dt", list(IN))
@pytest.mark.parametrize("out_dt", list(OUT))
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_equals_plain(dev, in_dt, out_dt, shape):
    x = torch.from_numpy(rgb(in_dt, shape, seed=len(shape) + shape[-1]))
    before = color_cuda.launch_count
    got = color_cuda.grey(x.to(dev), OUT[out_dt])
    torch.cuda.synchronize()
    assert color_cuda.launch_count - before == (1 if x.numel() else 0)
    assert torch.equal(got.cpu(), color_cuda.grey_reference(x, OUT[out_dt]))


@pytest.mark.cuda
@pytest.mark.parametrize("in_dt", list(IN))
@pytest.mark.parametrize("out_dt", list(OUT))
def test_kernel_on_an_unaligned_view(dev, in_dt, out_dt):
    x = torch.from_numpy(rgb(in_dt, (3, 37, 53), seed=11))
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    view = buf[1:].view(x.shape)
    view.copy_(x.to(dev))
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    got = color_cuda.grey(view, OUT[out_dt])
    assert torch.equal(got.cpu(), color_cuda.grey_reference(x, OUT[out_dt]))


@pytest.mark.cuda
@pytest.mark.parametrize("in_dt", list(IN))
@pytest.mark.parametrize("out_dt", list(OUT))
def test_kernel_on_4k_frames(dev, in_dt, out_dt):
    x = torch.from_numpy(rgb(in_dt, (3, 2160, 3840), seed=13))
    got = color_cuda.grey(x.to(dev), OUT[out_dt])
    assert torch.equal(got.cpu(), color_cuda.grey_reference(x, OUT[out_dt]))


@pytest.mark.cuda
def test_one_launch_an_unscaled_ecc_burst(dev):
    from _torch_parity import burst
    from libstacker_tpu_torch import (EccMatchParameters, MotionType,
                                      ecc_match_arrays)

    frames, _ = burst(9, 4, 192, 256, max_shift=4.0, max_angle=0.4)
    p = EccMatchParameters(MotionType.Homography, max_count=50, epsilon=1e-4,
                           gauss_filt_size=5, coarse_levels=1)
    before = color_cuda.launch_count
    ecc_match_arrays(frames, p, device=dev)
    assert color_cuda.launch_count - before == 1


@pytest.mark.cuda
def test_one_launch_an_unscaled_keypoint_burst(dev):
    from libstacker_tpu_torch import (KeyPointMatchParameters,
                                      keypoint_match_arrays)
    from libstacker_tpu_torch.utils.synth import make_textured_burst

    frames, _ = make_textured_burst(4, 270, 480, seed=2)
    before = color_cuda.launch_count
    keypoint_match_arrays(frames.numpy(), KeyPointMatchParameters(),
                          device=dev)
    assert color_cuda.launch_count - before == 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(8))
def test_wrapper_refuses_on_the_card(dev, case):
    x, out_dtype = _refused(dev)[case]
    before = color_cuda.launch_count
    with pytest.raises(ValueError):
        color_cuda.grey(x, out_dtype)
    assert color_cuda.launch_count == before
