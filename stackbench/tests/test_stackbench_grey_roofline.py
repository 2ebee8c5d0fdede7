"""``grey_roofline`` on synthetic traced windows: the least time of a
call's float32 grey over the device time of each ``grey_f32_kernel``
launch by name, the uint8 grey and PyTorch's kernels left out, a launch
the tracer lost left out of the work too, and None where the trace has
no such kernel."""

from types import SimpleNamespace

import pytest

from stackbench import harness
from stackbench.roofline import grey, peaks

H, W = 2160, 3840


def _read(ctx):
    return harness.load_file(harness.HERE / "metrics"
                             / "grey_roofline.py").read(ctx)


def _ctx(events, profiled, stacked=100):
    calls = [{"b": 0, "stats": None, "frames": stacked, "stacked": stacked}
             for _ in range(max(profiled, 1))]
    return SimpleNamespace(calls=calls, events=list(events),
                           profiled_calls=profiled, hw=(H, W))


def test_share_of_the_float32_kernel():
    bound, by = grey.bound_s(100, H, W)
    assert by == "bytes"
    assert bound == pytest.approx(100 * H * W * 7 / peaks.PEAK_BYTES_S)
    assert bound == pytest.approx(1.733e-3, rel=1e-3)
    # 6 profiled calls, each at 1.25x its bound; the ranked loop's uint8
    # greys and PyTorch's own kernels are not counted
    events = []
    for _ in range(6):
        events += [("void (anonymous namespace)::grey_f32_kernel<unsigned "
                    "char>(unsigned char const*, float*, long long, bool, "
                    "unsigned int)", 0.0, 1.25e6 * bound),
                   ("void (anonymous namespace)::grey_u8_kernel<unsigned "
                    "char>(unsigned char const*, unsigned char*, long long, "
                    "bool, unsigned int)", 0.0, 4e3),
                   ("void at::native::elementwise_kernel<128, 2>", 0.0, 5e4)]
    assert _read(_ctx(events, 6)) == pytest.approx(80.0)
    # the tracer lost the window's first operation, the first launch
    assert _read(_ctx(events[1:], 6)) == pytest.approx(80.0)


def test_none_without_the_kernel():
    events = [("void at::native::elementwise_kernel<128, 4>", 0.0, 5e4),
              ("void at::native::vectorized_elementwise_kernel<4>", 0.0, 1e4)]
    assert _read(_ctx(events, 6)) is None
    assert _read(_ctx([], 0)) is None
