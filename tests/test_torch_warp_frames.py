"""B5 on interleaved frames (ops/warp_cuda.warp_frames): its plain
version on the CPU, and what the kernel's two forms rely on.

Bars, all bitwise:

- the frames form, for u8, u16 and float32 bursts in each of the six
  border modes, perspective and affine (1/1024 fixed point), equals the
  planar route the keypoint path took before it: ``color.to_unit_f32``,
  the channels to planes, one ``warp_bilinear_reference`` slot per plane;
- integer frames widened per tap equal float32 frames fed with
  ``color.to_unit_f32(frames)`` (the kernel widens each tap as
  ``(float)v * float32(1/255)`` or ``1/65535``);
- the accumulate form equals a frame-by-frame numpy float32 sum of the
  frames form, ``acc = acc + warped[n] * valid[n]`` in frame order, and a
  dropped frame adds nothing, even with a non-finite map;
- ``warp_frames_batch`` (one frames-form call) keeps its [N,H,W] and
  [N,H,W,C] shapes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("scipy")

from _torch_parity import n, rotation_inverse_map, smooth, t  # noqa: E402
from libstacker_tpu_torch.ops import color, warp_batch, warp_cuda  # noqa: E402

torch.set_num_threads(2)

MODES = ["constant", "transparent", "replicate", "reflect", "reflect101",
         "wrap"]
BV = [0.25, 0.5, 0.75]


def _burst(dtype, nf=3, h=37, w=53, seed=0):
    """A small RGB burst of ``dtype`` and ``nf`` inverse maps that move
    taps past every edge (8-11 degrees, 10 % zoom, shifts of ~10 px)."""
    rng = np.random.default_rng(seed)
    f = np.stack([smooth(rng, (h, w, 3)) for _ in range(nf)])
    if dtype == np.uint16:
        frames = np.clip(np.round(f * 257.0), 0, 65535).astype(np.uint16)
    elif dtype == np.uint8:
        frames = np.clip(np.round(f), 0, 255).astype(np.uint8)
    else:
        frames = (f / 255.0).astype(np.float32)
    minv = np.stack([
        rotation_inverse_map(h, w, a, 1.1, 9.0 * s, -10.5 * s,
                             persp=(2e-4 * s, -1e-4))
        for a, s in ((8.0, 1.0), (-11.0, -1.0), (0.5, 0.3))[:nf]
    ]).astype(np.float32)
    return t(frames), t(minv)


def _planar(frames, minv, bv, mode, quant_affine):
    """The keypoint path's former route: widen, planes, one B5 slot each."""
    nf, h, w, c = frames.shape
    src = color.to_unit_f32(frames).permute(0, 3, 1, 2).reshape(nf * c, h, w)
    out = warp_cuda.warp_bilinear_reference(
        src.contiguous(), minv.repeat_interleave(c, dim=0),
        torch.tensor(bv, dtype=torch.float32).repeat(nf),
        quant_affine=quant_affine, border_mode=mode)
    return out.reshape(nf, c, h, w).permute(0, 2, 3, 1)


@pytest.mark.parametrize("quant_affine", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_frames_form_equals_planar_route(dtype, mode, quant_affine):
    frames, minv = _burst(dtype)
    got = warp_cuda.warp_frames(frames, minv, BV, mode, quant_affine)
    want = _planar(frames, minv, BV, mode, quant_affine)
    assert got.shape == frames.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(n(got), n(want))
    # the per-tap widening equals feeding the widened burst
    wide = warp_cuda.warp_frames(color.to_unit_f32(frames), minv, BV, mode,
                                 quant_affine)
    np.testing.assert_array_equal(n(got), n(wide))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_accumulate_form_is_a_frame_order_sum(dtype, mode):
    frames, minv = _burst(dtype)
    valid = torch.tensor([True, False, True])
    warped = n(warp_cuda.warp_frames(frames, minv, BV, mode))
    acc = np.zeros(warped.shape[1:], np.float32)
    for i, v in enumerate(n(valid).astype(np.float32)):
        if v:
            acc = acc + warped[i] * v
    got = warp_cuda.warp_frames(frames, minv, BV, mode, valid=valid)
    assert got.shape == frames.shape[1:] and got.dtype == torch.float32
    np.testing.assert_array_equal(n(got), acc)
    # a dropped frame adds nothing, whatever its map
    wild = minv.clone()
    wild[1] = float("nan")
    np.testing.assert_array_equal(
        n(warp_cuda.warp_frames(frames, wild, BV, mode, valid=valid)), acc)
    # float weights, and every frame dropped
    np.testing.assert_array_equal(
        n(warp_cuda.warp_frames(frames, minv, BV, mode,
                                valid=valid.to(torch.float32))), acc)
    none = warp_cuda.warp_frames(frames, minv, BV, mode,
                                 valid=torch.zeros(3, dtype=torch.bool))
    assert float(none.abs().max()) == 0.0


def test_accumulate_form_matches_former_keypoint_stack():
    """The keypoint path's stack with BORDER_REPLICATE: the former
    ``torch.sum(warped * valid, dim=0)`` differs from the frame-order sum
    by float32 rounding only."""
    frames, minv = _burst(np.uint8)
    valid = torch.tensor([True, True, False])
    old = torch.sum(_planar(frames, minv, BV, "replicate", False)
                    * valid.to(torch.float32)[:, None, None, None], dim=0)
    new = warp_cuda.warp_frames(frames, minv, BV, "replicate", valid=valid)
    np.testing.assert_allclose(n(new), n(old), rtol=0, atol=1e-6)


def test_warp_frames_batch_shapes_and_guards():
    frames, minv = _burst(np.float32)
    fwd = torch.linalg.inv(minv)
    out = warp_batch.warp_frames_batch(frames, fwd, border_value=BV,
                                       border_mode="wrap")
    np.testing.assert_array_equal(
        n(out), n(warp_cuda.warp_frames(frames, torch.linalg.inv(fwd), BV,
                                        "wrap")))
    grey = warp_batch.warp_frames_batch(frames[..., 1], fwd,
                                        border_value=0.5)
    assert grey.shape == frames.shape[:3]
    np.testing.assert_array_equal(n(grey), n(warp_cuda.warp_frames(
        frames[..., 1:2].contiguous(), torch.linalg.inv(fwd), 0.5))[..., 0])
    with pytest.raises(ValueError, match="C in 1..4"):
        warp_cuda.warp_frames(frames[..., 0], minv)
    with pytest.raises(ValueError, match="dtype"):
        warp_cuda.warp_frames(frames.to(torch.float64), minv)
    with pytest.raises(ValueError, match="minv"):
        warp_cuda.warp_frames(frames, minv[:2])
    with pytest.raises(ValueError, match="valid"):
        warp_cuda.warp_frames(frames, minv, valid=torch.ones(2))
    with pytest.raises(ValueError, match="border_value"):
        warp_cuda.warp_frames(frames, minv, [1.0, 2.0])
