"""ORB at the candidates and the kept keypoints (kernels B3h and B3d,
csrc/orb_describe.cu): their plain versions on the CPU, and numpy
emulations of what the kernels rely on to equal them bitwise.

Bars, all bitwise:

- ``candidate_harris`` -> ``topk_stable`` -> ``describe`` (the detector's
  route since B3h / B3d) selects the same keypoints, with the same
  responses, angles and descriptors, as the former route: B3's 43x43
  patches for every candidate, Harris on their centres, the kept
  patches gathered, then the angle, blur and rBRIEF chain.  Random u8
  levels, with centres at and beyond every clamp edge, and invalid
  candidates at -inf;
- B3h: the exact int32 block sums over the kernel's lane split and warp
  reduction equal the float64 sums the plain version casts once, also on
  0/255 content whose sums pass 2^24 (where a float32 sum can round), and
  the response evaluated term by term in float32 equals the plain one;
- B3d: the IC moments, summed in any order, are the same float32 value
  (exact integers below 2^24); the rows-then-columns blur on the flat
  43x43 / 37x43 / 37x37 shared tiles, each product and sum rounded,
  equals ``_blur_patches_valid``; the steered taps rint(x cos - y sin),
  rint(x sin + y cos) at multiples of 90 degrees and on .5 boundaries
  round half to even as ``torch.round`` does; the ballot words stored
  little-endian are the LSB-first descriptor bytes; the device buffer
  holds ORB_PATTERN and the circle's row extents.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import n, t  # noqa: E402
from libstacker_tpu_torch.ops import fast, filters, orb_cuda  # noqa: E402
from libstacker_tpu_torch.ops._orb_pattern import ORB_PATTERN  # noqa: E402

torch.set_num_threads(2)

R = orb_cuda.BLUR_RADIUS
SIDE = orb_cuda.BLUR_SIDE
PS = orb_cuda.PATCH_SIDE


def _level(seed, nf=2, h=90, w=140, k=40, binary=False):
    rng = np.random.default_rng(seed)
    if binary:
        imgs = rng.integers(0, 2, (nf, h, w)).astype(np.uint8) * 255
    else:
        imgs = rng.integers(0, 256, (nf, h, w)).astype(np.uint8)
    ys = rng.integers(0, h, (nf, k)).astype(np.int32)
    xs = rng.integers(0, w, (nf, k)).astype(np.int32)
    # centres at and beyond every clamp edge
    ys[:, :6] = [0, 3, h - 1, h + 5, -7, R]
    xs[:, :6] = [w - 1, -4, 2, w + 9, 0, w - R - 1]
    valid = np.ones((nf, k), bool)
    valid[:, 6:9] = False
    return t(imgs), t(ys), t(xs), t(valid)


@pytest.mark.parametrize("seed", [1, 2])
def test_new_route_equals_former_route(seed):
    imgs, ys, xs, valid = _level(seed)
    q = ys.shape[1] // 2
    # former: B3 patches of every candidate, then the chain on them
    patches = orb_cuda.extract_patches_reference(imgs, ys, xs, R)
    o = orb_cuda.HARRIS_ORIGIN
    h_old = fast.harris_from_patches(patches[..., o : o + 9, o : o + 9])
    h_old = torch.where(valid, h_old, torch.full_like(h_old, -math.inf))
    v_old, i_old = fast.topk_stable(h_old, q)
    kept = torch.gather(patches, 1, i_old[..., None, None].expand(
        -1, -1, SIDE, SIDE))
    a_old = orb_cuda._ic_angles_from_patches(kept, center=R)
    d_old = orb_cuda._rbrief_from_patches(
        orb_cuda._blur_patches_valid(kept), a_old)
    # new: B3h at the candidates, B3d at the kept keypoints
    h_new = orb_cuda.candidate_harris(imgs, ys, xs, valid)
    np.testing.assert_array_equal(n(h_new), n(h_old))
    v_new, i_new = fast.topk_stable(h_new, q)
    np.testing.assert_array_equal(n(i_new), n(i_old))
    a_new, d_new = orb_cuda.describe(imgs, torch.gather(ys, 1, i_new),
                                     torch.gather(xs, 1, i_new))
    assert a_new.dtype == torch.float32 and d_new.dtype == torch.uint8
    assert tuple(d_new.shape) == (ys.shape[0], q, 32)
    np.testing.assert_array_equal(n(a_new), n(a_old))
    np.testing.assert_array_equal(n(d_new), n(d_old))
    assert np.isneginf(n(h_new)[:, 6:9]).all()


def _kernel_harris_sums(block):
    """B3h's integer sums of one 9x9 block: lane l takes positions l and
    l + 32 of the 7x7, then a butterfly (xor-shuffle) sum over 32 lanes."""
    p = block.astype(np.int64)
    lanes = np.zeros((3, 32), np.int64)
    for j in range(49):
        r, q = divmod(j, 7)
        tt = p[r : r + 3, q : q + 3]
        dx = tt[:, 2] - tt[:, 0]
        dy = tt[2, :] - tt[0, :]
        ix = 2 * dx[1] + dx[0] + dx[2]
        iy = 2 * dy[1] + dy[0] + dy[2]
        lanes[:, j % 32] += (ix * ix, iy * iy, ix * iy)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ off]
    assert (np.abs(lanes) < 2 ** 31).all()  # int32 holds every partial
    return lanes[:, 0]


def _response_f32(a, b, c):
    """The kernel's float32 response, term by term."""
    f = np.float32
    af, bf, cf = f(a), f(b), f(c)
    det = f(f(af * bf) - f(cf * cf))
    tr = f(af + bf)
    r = f(det - f(f(orb_cuda.HARRIS_K) * f(tr * tr)))
    return f(r * f(fast.harris_scale4()))


@pytest.mark.parametrize("binary", [False, True])
def test_harris_exact_int32_sums(binary):
    imgs, ys, xs, valid = _level(7, binary=binary)
    got = n(orb_cuda.candidate_harris(imgs, ys, xs, valid))
    patches = n(orb_cuda.extract_patches_reference(imgs, ys, xs, R))
    o = orb_cuda.HARRIS_ORIGIN
    big = 0
    vd = n(valid)
    for f_ in range(patches.shape[0]):
        for k in range(patches.shape[1]):
            block = patches[f_, k, o : o + 9, o : o + 9]
            a, b, c = _kernel_harris_sums(block)
            big += max(a, b) > 2 ** 24
            want = _response_f32(a, b, c) if vd[f_, k] else -np.inf
            assert got[f_, k] == want, (f_, k)
    if binary:
        assert big > 0  # sums past 2^24


def test_harris_float32_sum_rounds_where_exact_does_not():
    """Why B3h sums in integers: on a 0/255 checkerboard of 2-px columns
    with a few flipped pixels the squared gradients are near 1020^2 and
    some are odd multiples of 255^2, so a float32 running sum passes 2^24
    and rounds where the exact sum does not."""
    rng = np.random.default_rng(3)
    stripes = np.repeat((np.arange(9) // 2 % 2)[None, :], 9, axis=0)
    rounded = 0
    for _ in range(50):
        flip = rng.random((9, 9)) < 0.15
        block = ((stripes ^ flip) * 255).astype(np.float32)
        a, b, c = _kernel_harris_sums(block)
        tt = block.astype(np.int64)
        dx = tt[:, 2:] - tt[:, :-2]
        ix = (2 * dx[1:-1] + dx[:-2] + dx[2:]).ravel()
        assert a == int((ix * ix).sum())
        run = np.float32(0)
        for v in (ix * ix).astype(np.float32):
            run = np.float32(run + v)
        rounded += int(run) != a
        got = fast.harris_from_patches(t(block[None]))
        assert n(got)[0] == _response_f32(a, b, c)
    assert rounded > 0


def test_ic_moments_any_order():
    """Products of u8 pixels and |u|, |v| <= 15 summed over the circle:
    every partial is an integer below 2^24, so a float32 sum in any order
    (torch's, the kernel's thread-strided one) is exact."""
    rng = np.random.default_rng(11)
    win = rng.integers(0, 256, (2 * 15 + 1,) * 2).astype(np.float32)
    win[:] = np.maximum(win, 200)  # near the largest moments
    wu, wv = orb_cuda._ic_angle_weights()
    umax = orb_cuda._ic_umax()
    assert len(umax) == 16
    inside = np.abs(np.arange(-15, 16))[None, :] <= np.array(
        [umax[abs(v)] for v in range(-15, 16)])[:, None]
    np.testing.assert_array_equal(wu, np.arange(-15, 16)[None, :] * inside)
    want10 = float(torch.sum(t(win) * t(wu)))
    prods = (win * wu).ravel()[inside.ravel()]
    for seed in range(5):
        order = np.random.default_rng(seed).permutation(prods.size)
        acc = np.float32(0)
        for v in prods[order]:
            acc = np.float32(acc + v)
        assert acc == want10
    # the kernel's split: 128 threads over j = v * 31 + u, then warps
    per_thread = np.zeros(128, np.int64)
    for j in range(31 * 31):
        v, u = divmod(j, 31)
        if abs(u - 15) <= umax[abs(v - 15)]:
            per_thread[j % 128] += (u - 15) * int(win[v, u])
    assert float(per_thread.sum()) == want10
    assert abs(want10) < 2 ** 24


def test_blur_in_the_kernels_staged_layout():
    rng = np.random.default_rng(5)
    patches = rng.integers(0, 256, (3, SIDE, SIDE)).astype(np.float32)
    k = np.asarray(filters.gaussian_kernel(7, 2.0), np.float32)
    want = n(orb_cuda._blur_patches_valid(t(patches)))
    for p, w in zip(patches, want):
        win = p.ravel()
        rows = np.empty(PS * SIDE, np.float32)
        for j in range(PS * SIDE):
            acc = np.float32(k[0] * win[j])
            for tap in range(1, 7):
                acc = np.float32(acc + np.float32(k[tap] * win[j + tap * SIDE]))
            rows[j] = acc
        blur = np.empty(PS * PS, np.float32)
        for j in range(PS * PS):
            r, c = divmod(j, PS)
            acc = np.float32(k[0] * rows[r * SIDE + c])
            for tap in range(1, 7):
                acc = np.float32(acc + np.float32(k[tap] * rows[r * SIDE + c + tap]))
            blur[j] = acc
        np.testing.assert_array_equal(blur.reshape(PS, PS), w)


def _taps(x, y, ca, sa):
    """B3d's steered tap: rint(x cos - y sin), rint(x sin + y cos)."""
    f = np.float32
    x, y, ca, sa = f(x), f(y), f(ca), f(sa)
    return (int(np.rint(f(f(x * ca) - f(y * sa)))),
            int(np.rint(f(f(x * sa) + f(y * ca)))))


def test_rbrief_taps_quarter_turns_and_half_boundaries():
    pat = ORB_PATTERN.astype(np.float32)
    px = np.concatenate([pat[:, 0], pat[:, 2]])
    py = np.concatenate([pat[:, 1], pat[:, 3]])
    for deg in (0.0, 90.0, 180.0, 270.0, 359.99997, 45.0, 123.4):
        ang = torch.tensor([deg], dtype=torch.float32) * (math.pi / 180.0)
        ca, sa = float(torch.cos(ang)), float(torch.sin(ang))
        a, b = torch.tensor(ca), torch.tensor(sa)
        rx = torch.round(t(px) * a - t(py) * b).to(torch.int64)
        ry = torch.round(t(px) * b + t(py) * a).to(torch.int64)
        got = np.array([_taps(x, y, ca, sa) for x, y in zip(px, py)])
        np.testing.assert_array_equal(got[:, 0], n(rx))
        np.testing.assert_array_equal(got[:, 1], n(ry))
        assert np.abs(got).max() <= orb_cuda.PATCH_RADIUS
        if deg == 90.0:  # a quarter turn maps (x, y) to (-y, x)
            np.testing.assert_array_equal(got, np.stack([-py, px], 1))
    # .5 boundaries round half to even, as torch.round does
    for x, ca, want in ((5.0, 0.5, 2), (7.0, 0.5, 4), (-5.0, 0.5, -2),
                        (3.0, 0.5, 2), (1.0, 0.5, 0)):
        assert _taps(x, 0.0, ca, 0.0)[0] == want
        assert int(torch.round(torch.tensor(np.float32(x * ca)))) == want


def test_descriptor_words_and_device_buffer():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, 256).astype(np.uint32)
    words = np.array([int((bits[32 * w : 32 * w + 32] << np.arange(32,
                      dtype=np.uint32)).sum()) for w in range(8)], np.uint32)
    np.testing.assert_array_equal(words.view(np.uint8),
                                  np.packbits(bits.astype(np.uint8),
                                              bitorder="little"))
    buf = n(orb_cuda._describe_constants_on(torch.device("cpu")))
    assert buf.dtype == np.int32 and buf.shape == (256 + 16,)
    np.testing.assert_array_equal(buf[:256].view(np.int8).reshape(256, 4),
                                  ORB_PATTERN)
    assert tuple(buf[256:]) == orb_cuda._ic_umax()


def test_guards():
    imgs, ys, xs, valid = _level(1)
    with pytest.raises(ValueError, match="uint8"):
        orb_cuda.candidate_harris(imgs.float(), ys, xs, valid)
    with pytest.raises(ValueError, match="valid"):
        orb_cuda.candidate_harris(imgs, ys, xs, valid[:, :3])
    with pytest.raises(ValueError, match="smaller"):
        orb_cuda.describe(imgs[:, :40], ys, xs)
