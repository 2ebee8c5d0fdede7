"""ORB at the candidates and the kept keypoints (kernels B3h and B3d,
csrc/orb_describe.cu): their plain versions on the CPU, and numpy
emulations of what the kernels rely on to equal them bitwise.

Bars, all bitwise:

- ``select_keypoints`` -> ``describe`` (the detector's route since B3h /
  B3d) selects the same keypoints, with the same responses, angles and
  descriptors, as the former route: B3's 43x43 patches for every
  candidate, Harris on their centres, ``topk_stable``, the kept patches
  gathered, then the angle, blur and rBRIEF chain.  Random u8 levels,
  with centres at and beyond every clamp edge, and invalid candidates at
  -inf;
- B3h: the exact int32 block sums in the kernel's order (a thread a
  candidate, three block rows at a time) equal the float64 sums the
  plain version casts once, also on 0/255 content whose sums pass 2^24
  (where a float32 sum can round), and the response evaluated term by
  term in float32 equals the plain one; the 64-bit sort words (the
  order-preserving key above, the index's complement below) sorted
  descending give ``topk_stable``'s order, -0.0 below +0.0 and -inf ties
  by index;
- B3d: the IC moments, summed in any order, are the same float32 value
  (exact integers below 2^24), also in the kernel's split (a lane a
  column, then a butterfly); the rows-then-columns blur in the kernel's
  tiles (rows of 11 float4, 4 columns by 5 rows a row-blur task, each
  window row added to the sums it reaches in tap order; 4 columns from
  12 row-blur values a column task), each product and sum rounded,
  equals ``_blur_patches_valid``; the steered taps rint(x cos - y sin),
  rint(x sin + y cos) by the 1.5 * 2^23 add at multiples of 90 degrees
  and on .5 boundaries round half to even as ``torch.round`` does; the
  ballot words stored little-endian are the LSB-first descriptor bytes;
  the device buffer holds ORB_PATTERN and the circle's row extents.

``csrc/orb_describe.cu`` itself, compiled for the host with ``g++``
through ``tests/_cuda_host_shim.h`` (its shuffles and ballots exchange
through the shim's warp barriers; its dynamic shared memory is the
launch's bytes; ``SELECT_SHARED_BYTES`` shrunk to 64 sort words, so a
level of more than 64 candidates sorts in its scratch rows), is held
bitwise to the plain versions: B3h on random, flat and binary levels
(no math library in its result), all-invalid frames, ``quota == K`` and
K on both sides of the shrunk capacity and of a block's threads; B3d on
levels whose windows are symmetric about the keypoint's row or column,
so that the moments make an angle of 0, 90, 180 or 270 degrees (or both
are 0), which the host's atan2f, cosf and sinf give as the card's and
PyTorch's do: its window staging at every byte alignment and row pitch,
the blur and the steered compares decide the result.
"""

import ctypes
import math
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import n, t  # noqa: E402
from test_torch_warp_design import host_launches  # noqa: E402
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
    # new: B3h's selection at the candidates, B3d at the kept keypoints
    v_new, kys, kxs, kvalid = orb_cuda.select_keypoints(imgs, ys, xs, valid,
                                                        q)
    np.testing.assert_array_equal(n(v_new), n(v_old))
    np.testing.assert_array_equal(n(kys), n(torch.gather(ys, 1, i_old)))
    np.testing.assert_array_equal(n(kxs), n(torch.gather(xs, 1, i_old)))
    np.testing.assert_array_equal(
        n(kvalid), n(torch.isfinite(v_old) & torch.gather(valid, 1, i_old)))
    a_new, d_new = orb_cuda.describe(imgs, kys, kxs)
    assert a_new.dtype == torch.float32 and d_new.dtype == torch.uint8
    assert tuple(d_new.shape) == (ys.shape[0], q, 32)
    np.testing.assert_array_equal(n(a_new), n(a_old))
    np.testing.assert_array_equal(n(d_new), n(d_old))
    assert np.isneginf(n(h_old)[:, 6:9]).all()


def _kernel_harris_sums(block):
    """B3h's integer sums of one 9x9 block in the kernel's order: one
    thread, the block rows three at a time, the 7 positions of each
    output row in turn, every partial an int32."""
    p = block.astype(np.int64)
    acc = np.zeros(3, np.int64)
    for r in range(7):
        for q in range(7):
            tt = p[r : r + 3, q : q + 3]
            dx = tt[:, 2] - tt[:, 0]
            dy = tt[2, :] - tt[0, :]
            ix = 2 * dx[1] + dx[0] + dx[2]
            iy = 2 * dy[1] + dy[0] + dy[2]
            acc += (ix * ix, iy * iy, ix * iy)
            assert (np.abs(acc) < 2 ** 31).all()  # int32 holds every partial
    return acc


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
    got = n(orb_cuda.candidate_harris_reference(imgs, ys, xs, valid))
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
    # the kernel's split: lane u + 15 sums its column over the circle's
    # rows, times u, then a butterfly over 32 lanes (lane 31 outside)
    lanes = np.zeros(32, np.float32)
    for u in range(-15, 17):
        col = np.float32(0)
        for v in range(-15, 16):
            if abs(u) <= umax[abs(v)]:
                col = np.float32(col + win[v + 15, u + 15])
        lanes[u + 15] = np.float32(u) * col
    for off in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[np.arange(32) ^ off]).astype(np.float32)
    assert lanes[0] == want10
    assert abs(want10) < 2 ** 24


def test_blur_in_the_kernels_staged_layout():
    rng = np.random.default_rng(5)
    patches = rng.integers(0, 256, (3, SIDE, SIDE)).astype(np.float32)
    k = np.asarray(filters.gaussian_kernel(7, 2.0), np.float32)
    want = n(orb_cuda._blur_patches_valid(t(patches)))
    f = np.float32
    for p, w in zip(patches, want):
        # the window as 46 rows of 44 columns (43 and a spare; the rows
        # past 43 only reach the last task's spare outputs)
        win = np.full((46, 44), np.nan, np.float32)
        win[:SIDE, :SIDE] = p
        rows = np.full((PS * 44 + 4,), np.nan, np.float32)
        for task in range(88):  # 4 columns by 5 rows, window rows in order
            q, r0 = task % 11, task // 11 * 5
            acc = [None] * 5
            for j in range(11):
                wv = win[r0 + j, 4 * q : 4 * q + 4]
                for o in range(5):
                    tap = j - o
                    if tap == 0:
                        acc[o] = (k[0] * wv).astype(f)
                    elif 0 < tap < 7:
                        acc[o] = (acc[o] + (k[tap] * wv).astype(f)).astype(f)
            for o in range(5):
                if r0 + o < PS:
                    rows[(r0 + o) * 44 + 4 * q : (r0 + o) * 44 + 4 * q + 4] = acc[o]
        blur = np.empty((PS, 40), np.float32)
        for task in range(PS * 10):  # 4 columns from 12 row-blur values
            r, q = divmod(task, 10)
            vals = rows[r * 44 + 4 * q : r * 44 + 4 * q + 12]
            for x in range(4):
                acc = f(k[0] * vals[x])
                for tap in range(1, 7):
                    acc = f(acc + f(k[tap] * vals[x + tap]))
                blur[r, 4 * q + x] = acc
        np.testing.assert_array_equal(blur[:, :PS], w)


def _rint_int(v):
    """B3d's rint: v + 1.5 * 2^23 in float32, its bits less 0x4B400000."""
    s = np.array([np.float32(v) + np.float32(12582912.0)], np.float32)
    return int(s.view(np.int32)[0]) - 0x4B400000


def _taps(x, y, ca, sa):
    """B3d's steered tap: rint(x cos - y sin), rint(x sin + y cos)."""
    f = np.float32
    x, y, ca, sa = f(x), f(y), f(ca), f(sa)
    return (_rint_int(f(f(x * ca) - f(y * sa))),
            _rint_int(f(f(x * sa) + f(y * ca))))


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
    # the add is rint for every tap value the pattern can reach
    vals = np.arange(-19.0, 19.0, 1 / 64, dtype=np.float32)
    assert [_rint_int(v) for v in vals] == list(np.rint(vals).astype(int))


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


def _sort_words(harris):
    """B3h's sort words of ``[N,K]`` responses: the order-preserving key,
    offset by 2^31, above the complement of the candidate's index."""
    bits = n(harris).astype(np.float32).view(np.int32).astype(np.int64)
    key = np.where(bits >= 0, bits, bits ^ 0x7FFFFFFF) + 2 ** 31
    idx = np.arange(harris.shape[-1], dtype=np.uint64)
    return (key.astype(np.uint64) << np.uint64(32)) | (
        np.uint64(0xFFFFFFFF) - idx)


def test_sort_words_order_is_topk_stable():
    """Sorting the words descending gives topk_stable's order and values:
    -0.0 below +0.0, -inf ties and equal responses by index."""
    rng = np.random.default_rng(4)
    vals = np.float32([0.0, -0.0, -np.inf, 1e-30, -1e-30, 3.5, -2.0,
                       np.finfo(np.float32).max, -np.finfo(np.float32).max,
                       np.finfo(np.float32).tiny])
    harris = t(rng.choice(vals, (3, 57)).astype(np.float32))
    words = _sort_words(harris)
    order = np.flip(np.sort(words, axis=1), axis=1)
    for q in (1, 20, 57):
        want_v, want_i = fast.topk_stable(harris, q)
        got_i = (np.uint64(0xFFFFFFFF) - (order[:, :q] & np.uint64(0xFFFFFFFF))
                 ).astype(np.int64)
        np.testing.assert_array_equal(got_i, n(want_i))
        key = (order[:, :q] >> np.uint64(32)).astype(np.int64) - 2 ** 31
        bits = np.where(key >= 0, key, key ^ 0x7FFFFFFF).astype(np.int32)
        np.testing.assert_array_equal(bits.view(np.float32).view(np.int32),
                                      n(want_v).view(np.int32))


def test_guards():
    imgs, ys, xs, valid = _level(1)
    with pytest.raises(ValueError, match="uint8"):
        orb_cuda.select_keypoints(imgs.float(), ys, xs, valid, 3)
    with pytest.raises(ValueError, match="valid"):
        orb_cuda.select_keypoints(imgs, ys, xs, valid[:, :3], 3)
    with pytest.raises(ValueError, match="quota"):
        orb_cuda.select_keypoints(imgs, ys, xs, valid, ys.shape[1] + 1)
    with pytest.raises(ValueError, match="smaller"):
        orb_cuda.describe(imgs[:, :40], ys, xs)


# --- the kernel source on the host --------------------------------------

_SHIM = Path(__file__).with_name("_cuda_host_shim.h")
_SOURCE = Path(orb_cuda.__file__).parents[1] / "csrc" / "orb_describe.cu"


# the sort words a host build's block keeps in shared memory: a level of
# more candidates (rounded up to a power of two) sorts in scratch
HOST_SHARED_WORDS = 64


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/orb_describe.cu built for the host with g++ and the shim
    (launches rewritten as shim calls; -ffp-contract=off as nvcc's
    --fmad=false; SELECT_SHARED_BYTES shrunk to HOST_SHARED_WORDS)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    d = tmp_path_factory.mktemp("orb_describe_host")
    (d / "cuda_runtime.h").write_text(_SHIM.read_text())
    (d / "orb_describe.cpp").write_text(host_launches(_SOURCE.read_text()))
    lib = d / "liborb_describe_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off",
                    "-fno-fast-math", "-fPIC", "-shared", "-I", str(d),
                    f"-DSELECT_SHARED_BYTES={8 * HOST_SHARED_WORDS}",
                    "-o", str(lib), str(d / "orb_describe.cpp")],
                   check=True, capture_output=True)
    h = ctypes.CDLL(str(lib))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    h.select_keypoints.argtypes = [vp] * 9 + [ci] * 5 + [cf, cf, vp]
    h.select_shared_words.restype = ci
    h.orb_describe.argtypes = ([vp] * 4 + [ctypes.POINTER(cf)] + [vp] * 2
                               + [ci] * 4 + [cf, cf, vp])
    assert h.select_shared_words() == HOST_SHARED_WORDS
    return h


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _host_describe(host, imgs, ys, xs):
    nf, h, w = imgs.shape
    q = ys.shape[1]
    angle = torch.empty((nf, q), dtype=torch.float32)
    desc = torch.empty((nf, q, 32), dtype=torch.uint8)
    consts = orb_cuda._describe_constants_on(torch.device("cpu"))
    ys32, xs32 = ys.to(torch.int32).contiguous(), xs.to(torch.int32).contiguous()
    assert host.orb_describe(
        _ptr(imgs), _ptr(ys32), _ptr(xs32), _ptr(consts), orb_cuda._blur_taps(),
        _ptr(angle), _ptr(desc), nf, q, h, w, 180.0 / math.pi,
        math.pi / 180.0, None) == 0
    return angle, desc


def _mirrored_level(seed, nf, h, w, axis):
    """Random u8 levels mirrored about their middle row (``axis`` 0) or
    column (1), and keypoints on it: every window centred there is
    symmetric, so m01 (or m10) is 0; the other coordinate runs over every
    byte alignment, the clamped edges and beyond."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (nf, h, w)).astype(np.uint8)
    if axis == 0:
        imgs = np.concatenate([imgs[:, : h // 2 + 1],
                               imgs[:, : h // 2][:, ::-1]], axis=1)
    else:
        imgs = np.concatenate([imgs[:, :, : w // 2 + 1],
                               imgs[:, :, : w // 2][:, :, ::-1]], axis=2)
    mid = (imgs.shape[1 + axis] - 1) // 2
    span = imgs.shape[2 - axis]
    along = np.array([0, 1, 2, 3, 21, 22, 23, 24, span // 2, span - 23,
                      span - 22, span - 1, span + 4, -5, 40, 41], np.int32)
    along = np.tile(along, (nf, 1))
    across = np.full_like(along, mid)
    ys, xs = (across, along) if axis == 0 else (along, across)
    return t(np.ascontiguousarray(imgs)), t(ys), t(xs)


@pytest.mark.parametrize("w", [43, 140, 141, 142, 143])
@pytest.mark.parametrize("axis", [0, 1])
def test_describe_kernel_source_on_host(host_kernel, axis, w):
    """B3d bitwise on windows whose angle is a quarter turn (or 0 when a
    window is flat), at every row pitch modulo 4 and a level of exactly
    one window."""
    for seed, flat in ((w + axis, False), (w + 7, True)):
        imgs, ys, xs = _mirrored_level(seed, 3, 43 if w == 43 else 61, w, axis)
        if flat:  # both moments 0: atan2(0, 0)
            imgs = torch.full_like(imgs, 77)
            imgs[:, ::5] = 200
        ang, desc = _host_describe(host_kernel, imgs, ys, xs)
        ang_want, desc_want = orb_cuda.describe_reference(imgs, ys, xs)
        assert np.isin(np.round(n(ang_want), 3),
                       [0.0, 90.0, 180.0, 270.0]).all()
        np.testing.assert_array_equal(n(ang), n(ang_want))
        np.testing.assert_array_equal(n(desc), n(desc_want))


def _host_select(host, imgs, ys, xs, valid, quota):
    """The host build's select_keypoints, launched as the wrapper
    launches it (scratch rows where the words pass the shared
    capacity); returns the scratch too (None where unused)."""
    nf, h, w = imgs.shape
    k = ys.shape[1]
    n2 = max(32, 1 << (k - 1).bit_length())
    scratch = (torch.empty((nf, n2), dtype=torch.int64)
               if n2 > host.select_shared_words() else None)
    hval = torch.empty((nf, quota), dtype=torch.float32)
    kys = torch.empty((nf, quota), dtype=torch.int32)
    kxs = torch.empty_like(kys)
    kvalid = torch.empty((nf, quota), dtype=torch.bool)
    ys32, xs32 = ys.to(torch.int32).contiguous(), xs.to(torch.int32).contiguous()
    vb = valid.to(torch.bool).contiguous()
    assert host.select_keypoints(
        _ptr(imgs), _ptr(ys32), _ptr(xs32), _ptr(vb),
        None if scratch is None else _ptr(scratch), _ptr(hval), _ptr(kys),
        _ptr(kxs), _ptr(kvalid), nf, k, quota, h, w, orb_cuda.HARRIS_K,
        fast.harris_scale4(), None) == 0
    return (hval, kys, kxs, kvalid), scratch


def _assert_selection(got, imgs, ys, xs, valid, quota):
    want = orb_cuda.select_keypoints_reference(imgs, ys, xs, valid, quota)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype
        np.testing.assert_array_equal(n(g).view(np.uint8), n(w_).view(np.uint8))


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_harris_kernel_source_on_host(host_kernel, seed, binary):
    """B3h bitwise: exact int32 sums, invalid candidates, centres at and
    beyond every edge, the words sorted in shared memory (K = 40)."""
    imgs, ys, xs, valid = _level(seed, binary=binary, w=137 + seed)
    got, scratch = _host_select(host_kernel, imgs, ys, xs, valid, 20)
    assert scratch is None
    _assert_selection(got, imgs, ys, xs, valid, 20)


# (case, K, quota): the level's content or validity, candidates a frame
# and slots; K = 100 and 600 pass the host build's 64 shared words (the
# scratch path), 600 a block's 512 threads
SELECT_CASES = [("random", 100, 37), ("random", 600, 300), ("flat", 64, 64),
                ("binary", 45, 45), ("invalid", 30, 10),
                ("invalid", 100, 100), ("zeros", 77, 50), ("random", 1, 1),
                ("random", 513, 2)]


@pytest.mark.parametrize("case,k,quota", SELECT_CASES)
def test_select_kernel_source_on_host(host_kernel, case, k, quota):
    """B3h bitwise on equal responses (a flat level: every response +0.0;
    a binary one), all-invalid frames (every response -inf, kept by
    index), a level whose flat and edged windows give +0.0, negative and
    positive responses, centres at and beyond every edge, K not a
    multiple of a block's threads, quota == K, and K past the shared
    capacity (the scratch rows)."""
    imgs, ys, xs, valid = _level(k + quota, nf=3, h=70, w=101, k=max(k, 9),
                                 binary=case == "binary")
    ys, xs, valid = ys[:, :k], xs[:, :k], valid[:, :k]
    if case == "flat":
        imgs = torch.full_like(imgs, 99)
    if case == "zeros":  # flat halves: responses +0.0 beside edges
        imgs[:, :, : imgs.shape[2] // 2] = 17
    if case == "invalid":
        valid = valid.clone()
        valid[1] = False  # one frame all invalid
    got, scratch = _host_select(host_kernel, imgs, ys, xs, valid, quota)
    n2 = max(32, 1 << (k - 1).bit_length())
    assert (scratch is not None) == (n2 > HOST_SHARED_WORDS)
    _assert_selection(got, imgs, ys, xs, valid, quota)
    hval = n(got[0])
    if case == "flat":
        assert (hval[n(got[3])].view(np.int32) == 0).all()  # +0.0
    if case == "zeros":
        h = n(orb_cuda.candidate_harris_reference(imgs, ys, xs, valid))
        assert (h.view(np.int32) == 0).any() and (h < 0).any() and (h > 0).any()
    if case == "invalid":
        assert np.isneginf(hval[1]).all() and not n(got[3])[1].any()
        np.testing.assert_array_equal(n(got[1])[1], n(ys)[1, :quota])
