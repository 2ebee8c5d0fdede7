"""``sharpness_roofline`` on synthetic traced windows: the least time of
each profiled call's ``sharpness_all`` over the device time of the
kernel's two launches by name, None where the trace has neither, and the
frozen launch geometry against the kernel's at the cell's shapes."""

from types import SimpleNamespace

import pytest

from stackbench import harness
from stackbench.roofline import peaks, sharpness

H, W = 2160, 3840


def _read(ctx):
    return harness.load_file(harness.HERE / "metrics"
                             / "sharpness_roofline.py").read(ctx)


def _ctx(events, profiled, frames=32):
    calls = [{"b": 0, "stats": None, "frames": frames, "stacked": frames - 1}
             for _ in range(max(profiled, 1))]
    return SimpleNamespace(calls=calls, events=list(events),
                           profiled_calls=profiled, hw=(H, W))


def test_share_over_both_launches():
    bound, by = sharpness.bound_s(32, H, W)
    assert by == "operations"
    assert bound == pytest.approx(32 * H * W * 30 / peaks.PEAK_OPS_S)
    # 8 profiled calls, each 4x its bound: 3x in the sums, 1x in the
    # finalisation; PyTorch's own kernels are not counted
    events = []
    for _ in range(8):
        events += [("void (anonymous namespace)::sharpness_kernel<unsigned "
                    "char, 3>(unsigned char const*, double*, int, int)",
                    0.0, 3e6 * bound),
                   ("void (anonymous namespace)::sharpness_finalize(double "
                    "const*, double*, float*, int, int, double)", 0.0,
                    1e6 * bound),
                   ("void at::native::elementwise_kernel<128, 2>", 0.0, 5e4)]
    assert _read(_ctx(events, 8)) == pytest.approx(25.0)


def test_none_without_the_kernel():
    events = [("void at::native::elementwise_kernel<128, 2>", 0.0, 5e4),
              ("void at::native::reflection_pad2d_out_kernel", 0.0, 1e4)]
    assert _read(_ctx(events, 8)) is None
    assert _read(_ctx([], 0)) is None


@pytest.mark.parametrize("frames,want", [(32, 5 * 13 + 63), (100, 5 * 5 + 63),
                                         (1, 5 * 66 + 63)])
def test_slots_follow_the_kernel_geometry(frames, want):
    """5 strips of 768 columns; 2048 blocks aimed at, segments of at
    least 32 rows (67 of 33 rows cover 2158 in 66); the rim's 11992
    pixels in blocks of 192."""
    assert sharpness.slots(frames, H, W) == want
