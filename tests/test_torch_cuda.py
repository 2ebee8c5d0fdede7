"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Phases 2-4, 6-8, 10-14, 17-21, 23-24 and 26 of chip_smoke.py at small sizes.  Every test needs CUDA and
the ``nvcc`` toolchain, is marked ``cuda`` and skips without a card.
This file imports no JAX, so on a machine with the card run it without
the suite's JAX-configuring conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Bars: moments per group norm-relative < 1e-4 (the kernel sums in float32
partials then double, the plain version in double, and both bin every
coordinate identically: the kernels are built with --fmad=false), B1
also at an odd width, with taps off the image, with every lane inactive
and with a ragged mask; warp-accumulate max abs < 1e-3 and u8 source ==
f32 source bitwise; slice: equal ok flags, warps within 0.03, stacked
interior within 0.02; FAST (B8), patch extraction (B3), Harris at the
candidates and the level's selection (B3h) and the angle and descriptor
at the kept keypoints (B3d) bitwise equal to their plain versions, B3h
also on the host-shim cases of tests/test_torch_orb_design.py and past
the card's shared capacity, B8 also with every pixel a
candidate, with
none, with corners on the tile and warp edges and at the pyramid's
widths; keypoint slice: equal ``dropped``, homographies mapping the
image corners within 0.5 px, stacked interior within 0.02.  B1's masked
form at B1's bar; B4's S0 / C0 bitwise and S1 / S2 within 1e-6 of the
group's largest value (summed in the same frame order, so equal unless
the compiler reorders); B5 in every border mode (its planar form, also on
the host-shim cases of tests/test_torch_warp_design.py, and its
frames and accumulate forms on u8, u16 and f32 frames, both also on the
host-shim cases of tests/test_torch_warp_frames_design.py)
and B9 bitwise, B3d also on the host-shim cases of
tests/test_torch_orb_design.py; the
sigma-clip and masked ECC slices and the BORDER_REPLICATE keypoint slice
on the card against the CPU path at the slice bars above.  B7 at B1's
bar; B6 within 1e-5 of the largest value (the taps are the same, the
weights go through the two math libraries' exp); the lazy and IC
solvers, the rotation start and super-resolution on the card against
the CPU path at the slice bars (the keypoint SR image, whose RANSAC
draws differ between devices, at a mean abs of 0.01); the n == 1
upsample of both entry points within 1e-6 of the CPU path.  B2 and B4
bitwise for u8, u16 and f32 sources, affine, perspective, 30-degree and
strongly perspective maps, ties and near-ties of the 1/32 and 1/1024
rounding, coordinates on the coverage edges, rows where sw == 0, odd
sizes (W 1, 2, 3, 5, 3841; H 1), N = 0 and 1 and every frame dropped; B7
across its tile and warp edges; the native loader where it builds.  B6's
image form (``sr_image``) bitwise for u8 / u16 / f32, factors 2-4, sigma
0.3 and 0.1, affine and perspective maps, scalar and 16-byte stores, and
over more frames than a block stages at once; B6's deposit form with
16-byte stores at its bar, and the CUDA SR stack through one image
launch; B9 bitwise for 1, 3 and 17 lanes, odd and aligned widths, both
map forms.  The sharpness metrics on the card within rel 1e-5 of the
CPU path; the chunk uploader's copies equal their chunks; the ECC and
keypoint streams (mean and sigma-clip) on the card against the CPU
streams at the slice bars (keypoint: p99 < 0.02 and mean < 0.01, the
draws differing), through their kernels; a sigma-clip stream killed and
resumed on the card bitwise equal to an uninterrupted one; the streams
and ``mesh=`` on 48-bit PNG files with ``preserve_depth=True`` against
the CPU path on the same files at those bars.  B5's row
origins (a strip of rows warped with the global map) bitwise against the
plain version and the whole frame's rows; ``mesh=`` on shards of the
card against the same mesh on the CPU (ECC mean and SR through B6's
deposit form at the slice bars, the keypoint mean at p99 < 0.02), and
the row-band warp bitwise against the dense one.  The ECC solve's
Gaussian pre-filter (``csrc/ecc_blur.cu``) bitwise against
``filters.gaussian_blur`` for ksize 1-15 at N 1 and 7, W % 4 == 0 and
!= 0, H and W just above 2r, and on the host-shim cases of
tests/test_torch_ecc_blur.py (ksize 19 and 21 through its direct form),
aligned and one float past a 16-byte boundary; a CUDA solve ('forward'
with and without an octave, 'lazy', 'ic') launches it twice a solved
level and returns bitwise what the plain pre-filter's solve returns.
RANSAC's refit kernels (``csrc/ransac_refit.cu``) on the cases of
tests/test_torch_ransac_refit.py at its bars (float64 kernels: 1e-3 px
at a 4K frame's corners from the plain versions in float64, 0.01 px
from the float32 ones), the same bits on a second run; ORB detection
and ``_match_and_estimate`` under ``set_sync_debug_mode("error")`` but
for RANSAC's one read a slab.  The one-pass sharpness kernel
(``csrc/sharpness.cu``) on the host-shim cases of
tests/test_torch_sharpness_kernel.py through the wrapper, against the
plain version on the CPU: u8 sums at ksize 1 and 3 equal, the others
within rel 1e-12, the metrics the plain finalisation of the kernel's
sums bit for bit, two launches a call and two runs bitwise equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("scipy")

import test_torch_ecc_blur as blur_design  # noqa: E402
import test_torch_orb_design as orb_design  # noqa: E402
import test_torch_ransac_refit as refit_design  # noqa: E402
import test_torch_sharpness_kernel as sharp_design  # noqa: E402
import test_torch_warp_design as warp_design  # noqa: E402
import test_torch_warp_frames_design as frames_design  # noqa: E402
from _torch_parity import burst, rotation_inverse_map, smooth  # noqa: E402
from libstacker_tpu_torch import EccMatchParameters, MotionType  # noqa: E402
from libstacker_tpu_torch.ops import (  # noqa: E402
    color, ecc, ecc_cuda, fast_cuda, filters, orb_cuda, sharpness_cuda, warp,
    warp_accum_cuda, warp_cuda,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _group_rel(got, want, p):
    bounds = [(k, k + 1) for k in range(6)]
    bounds += [(6, 6 + p), (6 + p, 6 + 2 * p), (6 + 2 * p, got.shape[1])]
    worst = 0.0
    for lo, hi in bounds:
        err = np.abs(got[:, lo:hi] - want[:, lo:hi]).max(axis=1)
        scale = np.abs(want[:, lo:hi]).max(axis=1) + 1e-6
        worst = max(worst, float((err / scale).max()))
    return worst


@pytest.mark.parametrize("motion", list(MotionType))
@pytest.mark.parametrize("with_hessian", [True, False])
def test_moments_kernel_matches_plain(dev, motion, with_hessian):
    rng = np.random.default_rng(3)
    h, w = 200, 333
    img = torch.from_numpy(smooth(rng, (h, w))).to(dev)
    srcs = torch.stack(ecc._input_fields(img, 5)).contiguous()
    tmpl = torch.from_numpy(np.stack([smooth(rng, (h, w))] * 3)).to(dev)
    persp = (1e-5, -2e-5) if motion == MotionType.Homography else (0, 0)
    m3 = torch.from_numpy(np.stack([
        rotation_inverse_map(h, w, a, 1.0, 2.5 * a, -1.25, persp=persp)
        for a in (0.0, 0.7, -1.1)
    ])).to(dev)
    active = torch.tensor([True, False, True], device=dev)
    kw = dict(quant_affine=motion != MotionType.Homography, active=active,
              with_hessian=with_hessian)
    got = ecc_cuda.ecc_iteration_moments(srcs, tmpl, m3, motion, **kw)
    want = ecc_cuda.ecc_iteration_moments_reference(srcs, tmpl, m3, motion,
                                                    **kw)
    torch.cuda.synchronize()
    g, wn = got.double().cpu().numpy(), want.double().cpu().numpy()
    assert g.shape == (3, ecc_cuda.moments_layout(motion, with_hessian)[1])
    np.testing.assert_array_equal(g[1], 0.0)
    assert _group_rel(g, wn, motion.num_params) < 1e-4


def _moments_vs_plain(dev, srcs, tmpl, m3, motion, with_hessian=True,
                      active=None):
    """B1 (texels packed once, as the solver does) and its plain version
    on the same inputs -> (kernel, plain) as float64 numpy."""
    kw = dict(quant_affine=motion != MotionType.Homography, active=active,
              with_hessian=with_hessian)
    tex = ecc_cuda.pack_texels(srcs)
    got = ecc_cuda.ecc_iteration_moments(srcs, tmpl, m3, motion, texels=tex,
                                         **kw)
    want = ecc_cuda.ecc_iteration_moments_reference(srcs, tmpl, m3, motion,
                                                    **kw)
    torch.cuda.synchronize()
    return got.double().cpu().numpy(), want.double().cpu().numpy()


@pytest.mark.parametrize("motion", [MotionType.Affine, MotionType.Homography])
@pytest.mark.parametrize("with_hessian", [True, False])
def test_moments_kernel_odd_width(dev, motion, with_hessian):
    """B1 on a width that is no multiple of the 128-column tile, nor of 4
    (a pyramid width of the keypoint path): texel rows start unaligned."""
    rng = np.random.default_rng(31)
    h, w = 61, 1423
    img = torch.from_numpy(smooth(rng, (h, w))).to(dev)
    srcs = torch.stack(ecc._input_fields(img, 5)).contiguous()
    tmpl = torch.from_numpy(np.stack([smooth(rng, (h, w))] * 2)).to(dev)
    persp = (1e-5, -2e-5) if motion == MotionType.Homography else (0, 0)
    m3 = torch.from_numpy(np.stack([
        rotation_inverse_map(h, w, a, 1.0, 2.5 * a, -1.25, persp=persp)
        for a in (0.4, -0.9)
    ])).to(dev)
    g, wn = _moments_vs_plain(dev, srcs, tmpl, m3, motion, with_hessian)
    assert _group_rel(g, wn, motion.num_params) < 1e-4


def test_moments_kernel_taps_off_image(dev):
    """Lanes whose warps put most taps (or all of them) outside the
    source: the BORDER_CONSTANT taps and the validity mask at the edges."""
    rng = np.random.default_rng(32)
    h, w = 150, 260
    img = torch.from_numpy(smooth(rng, (h, w))).to(dev)
    srcs = torch.stack(ecc._input_fields(img, 5)).contiguous()
    tmpl = torch.from_numpy(np.stack([smooth(rng, (h, w))] * 4)).to(dev)
    m3 = torch.from_numpy(np.stack([
        rotation_inverse_map(h, w, 0.0, 1.0, 0.9 * w, 0.5),  # 10 % inside
        rotation_inverse_map(h, w, 35.0, 1.3, -40.0, 70.0,
                             persp=(2e-4, -1e-4)),
        rotation_inverse_map(h, w, 0.0, 1.0, -0.97 * w, -0.95 * h),
        rotation_inverse_map(h, w, 0.0, 1.0, 2.0 * w, 0.0),  # all outside
    ])).to(dev)
    g, wn = _moments_vs_plain(dev, srcs, tmpl, m3, MotionType.Homography)
    assert 0.0 < wn[0, 0] < 0.2 * h * w and wn[3, 0] == 0.0
    np.testing.assert_array_equal(g[3], 0.0)
    assert _group_rel(g, wn, 8) < 1e-4


@pytest.mark.parametrize("planes", [3, 4])
def test_moments_kernel_all_lanes_inactive(dev, planes):
    """With no lane active every row is zero, masked form included."""
    rng = np.random.default_rng(33)
    h, w = 70, 90
    img = torch.from_numpy(smooth(rng, (h, w))).to(dev)
    if planes == 3:
        srcs = torch.stack(ecc._input_fields(img, 5)).contiguous()
    else:
        mask = torch.ones((h, w), device=dev)
        srcs = ecc._prepare_masked_input(img, mask, 5).contiguous()
    tmpl = torch.from_numpy(np.stack([smooth(rng, (h, w))] * 3)).to(dev)
    m3 = torch.eye(3, device=dev).repeat(3, 1, 1).contiguous()
    active = torch.zeros(3, dtype=torch.bool, device=dev)
    g, wn = _moments_vs_plain(dev, srcs, tmpl, m3, MotionType.Homography,
                              active=active)
    np.testing.assert_array_equal(g, 0.0)
    np.testing.assert_array_equal(wn, 0.0)


@pytest.mark.parametrize("with_hessian", [True, False])
def test_masked_moments_kernel_ragged_mask(dev, with_hessian):
    """B1's 4-plane form with a ragged mask (thresholded noise blobs) at
    an odd width: the nearest tap of the texels' 4th component."""
    rng = np.random.default_rng(34)
    h, w = 90, 333
    img = torch.from_numpy(smooth(rng, (h, w))).to(dev)
    blobs = smooth(rng, (h, w), sigma=4.0)
    mask = torch.from_numpy((blobs > np.median(blobs)).astype(np.float32))
    srcs = ecc._prepare_masked_input(img, mask.to(dev), 5).contiguous()
    tmpl = torch.from_numpy(np.stack([smooth(rng, (h, w))] * 3)).to(dev)
    m3 = torch.from_numpy(np.stack([
        rotation_inverse_map(h, w, a, 1.0, 3.0 * a, -2.0, persp=(1e-5, 0.0))
        for a in (0.0, 1.5, -3.0)
    ])).to(dev)
    active = torch.tensor([True, True, False], device=dev)
    g, wn = _moments_vs_plain(dev, srcs, tmpl, m3, MotionType.Homography,
                              with_hessian, active)
    assert 0.3 * h * w < wn[0, 0] < 0.7 * h * w
    np.testing.assert_array_equal(g[2], 0.0)
    assert _group_rel(g, wn, 8) < 1e-4


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.float32])
@pytest.mark.parametrize("quant_affine", [False, True])
def test_warp_accum_kernel_matches_plain(dev, dtype, quant_affine):
    frames, truth = burst(4, 4, 150, 211)
    frames = torch.from_numpy(frames).to(dev)
    if dtype == torch.uint16:
        frames = frames.to(torch.int32).mul(257).to(torch.uint16)
    elif dtype == torch.float32:
        frames = color.to_unit_f32(frames)
    minv = warp.invert_3x3(torch.from_numpy(truth).float().to(dev))
    valid = torch.tensor([True, True, False, True], device=dev)
    bv = [0.1, 0.2, 0.3]
    got = warp_accum_cuda.warp_accum_rgb(frames, minv, valid, bv, quant_affine)
    want = warp_accum_cuda.warp_accum_rgb_reference(frames, minv, valid, bv,
                                                    quant_affine)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) < 1e-3
    if dtype == torch.uint8:
        f32 = warp_accum_cuda.warp_accum_rgb(color.to_unit_f32(frames), minv,
                                             valid, bv, quant_affine)
        assert float((got - f32).abs().max()) == 0.0


def test_slice_cuda_matches_cpu(dev):
    from libstacker_tpu_torch import ecc_match_arrays

    frames, _ = burst(9, 4, 192, 256, max_shift=4.0, max_angle=0.4)
    p = EccMatchParameters(MotionType.Homography, max_count=50, epsilon=1e-4,
                           gauss_filt_size=5, coarse_levels=1)
    cpu, st_cpu = ecc_match_arrays(frames, p, return_stats=True, device="cpu")
    gpu, st_gpu = ecc_match_arrays(frames, p, return_stats=True, device=dev)
    assert st_cpu.frames_kept == st_gpu.frames_kept == 4
    np.testing.assert_allclose(st_gpu.ecc_rho, st_cpu.ecc_rho, atol=1e-3)
    assert np.abs(gpu[8:-8, 8:-8] - cpu[8:-8, 8:-8]).max() < 0.02


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("border", [0, 31])
def test_fast_kernel_matches_plain(dev, dtype, border):
    rng = np.random.default_rng(5)
    imgs = np.stack([smooth(rng, (150, 331), sigma=1.0) for _ in range(3)])
    imgs = torch.from_numpy(imgs).to(dev)
    imgs = imgs.round().to(torch.uint8) if dtype == torch.uint8 else imgs
    got = fast_cuda.fast_scores(imgs, 20, border)
    want = fast_cuda.fast_scores_reference(imgs, 20, border)
    torch.cuda.synchronize()
    assert int((want > 0).sum()) > 100
    assert torch.equal(got, want)


def _fast_vs_plain(imgs, threshold=20, border=0):
    got = fast_cuda.fast_scores(imgs, threshold, border)
    want = fast_cuda.fast_scores_reference(imgs, threshold, border)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    return want


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_fast_kernel_every_or_no_pixel_a_candidate(dev, dtype):
    """A 0/255 checkerboard puts every pixel past the compass test (the
    candidate queue full), a flat frame none."""
    ys, xs = np.mgrid[0:70, 0:300]
    board = ((ys + xs) % 2 * 255).astype(np.uint8)
    imgs = torch.from_numpy(np.stack([board, np.full_like(board, 128)]))
    imgs = imgs.to(dev).to(dtype)
    want = _fast_vs_plain(imgs)
    assert int((want[1] > 0).sum()) == 0


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_fast_kernel_corners_at_tile_edges(dev, dtype):
    """Squares of random brightness on textured content, their corners on
    and beside the 128x16 tile edges and the 32-column warp edges."""
    rng = np.random.default_rng(36)
    img = np.stack([smooth(rng, (100, 400), sigma=1.0) for _ in range(2)])
    for y in (13, 15, 16, 29, 31, 32, 47, 48, 63, 64):
        for x in (29, 32, 62, 95, 126, 128, 255):
            img[0, y : y + 4, x : x + 4] = rng.uniform(200, 255)
            img[1, y : y + 3, x : x + 5] = rng.uniform(0, 40)
    imgs = torch.from_numpy(img).to(dev)
    imgs = imgs.round().to(torch.uint8) if dtype == torch.uint8 else imgs
    want = _fast_vs_plain(imgs)
    edges = want[:, 12:20, :].sum() + want[:, :, 124:133].sum()
    assert int((want > 0).sum()) > 100 and float(edges) > 0.0


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("w", [3200, 2667, 1423])
def test_fast_kernel_pyramid_widths(dev, dtype, w):
    """Widths of the keypoint path's pyramid: 4-pixel groups load as one
    vector where the rows allow it (3200), byte by byte where not; and
    a base address off the vector alignment."""
    rng = np.random.default_rng(35)
    imgs = np.stack([smooth(rng, (40, w), sigma=1.0) for _ in range(2)])
    imgs = torch.from_numpy(imgs).to(dev)
    imgs = imgs.round().to(torch.uint8) if dtype == torch.uint8 else imgs
    want = _fast_vs_plain(imgs)
    assert int((want > 0).sum()) > 100
    buf = torch.zeros(imgs.numel() + 1, dtype=dtype, device=dev)
    buf[1:] = imgs.reshape(-1)
    _fast_vs_plain(buf[1:].view(imgs.shape), border=5)


@pytest.mark.parametrize("radius", [orb_cuda.BLUR_RADIUS, orb_cuda.PATCH_RADIUS])
def test_extract_kernel_matches_plain(dev, radius):
    rng = np.random.default_rng(6)
    imgs = torch.from_numpy(
        rng.integers(0, 256, (2, 120, 200)).astype(np.uint8)).to(dev)
    ys = torch.from_numpy(rng.integers(0, 120, (2, 33)).astype(np.int32)).to(dev)
    xs = torch.from_numpy(rng.integers(0, 200, (2, 33)).astype(np.int32)).to(dev)
    ys[:, :3] = torch.tensor([0, 119, 140], dtype=torch.int32)
    xs[:, :3] = torch.tensor([-5, 199, 3], dtype=torch.int32)
    for src in (imgs, imgs.float()):
        got = orb_cuda.extract_patches(src, ys, xs, radius)
        want = orb_cuda.extract_patches_reference(src, ys, xs, radius)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_keypoint_slice_cuda_matches_cpu(dev):
    from libstacker_tpu_torch import KeyPointMatchParameters, keypoint_match_arrays
    from libstacker_tpu_torch.models import keypoint
    from libstacker_tpu_torch.ops import orb
    from libstacker_tpu_torch.utils.synth import make_textured_burst

    frames, _ = make_textured_burst(4, 270, 480, seed=2)
    frames = frames.numpy()
    p = KeyPointMatchParameters()
    hs = []
    for device in ("cpu", dev):
        grey = color.burst_grey_u8(torch.from_numpy(frames).to(device))
        feats = orb.orb_detect_and_compute(grey)
        gen = torch.Generator(device=device).manual_seed(0)
        h, ok, _, _ = keypoint._match_and_estimate(
            feats, gen, p.method, p.ransac_reproj_threshold,
            p.match_keep_ratio, p.match_ratio)
        assert bool(ok.all())
        hs.append(h.double().cpu().numpy())
    corners = np.array([[0, 0, 1], [479, 0, 1], [0, 269, 1], [479, 269, 1.0]])
    for a, b in zip(*hs):
        pa, pb = corners @ a.T, corners @ b.T
        assert np.abs(pa[:, :2] / pa[:, 2:] - pb[:, :2] / pb[:, 2:]).max() < 0.5
    d_cpu, cpu = keypoint_match_arrays(frames, p, device="cpu")
    d_gpu, gpu = keypoint_match_arrays(frames, p, device=dev)
    assert d_cpu == d_gpu == 0
    assert np.abs(gpu[16:-16, 16:-16] - cpu[16:-16, 16:-16]).max() < 0.02


@pytest.mark.parametrize("motion", [MotionType.Affine, MotionType.Homography])
def test_masked_moments_kernel_matches_plain(dev, motion):
    """B1's 4-plane form: the mask plane's nearest tap replaces the
    validity mask."""
    rng = np.random.default_rng(8)
    h, w = 200, 333
    img = torch.from_numpy(smooth(rng, (h, w))).to(dev)
    mask = torch.ones((h, w), device=dev)
    mask[: h // 2, : w // 4] = 0.0
    srcs = ecc._prepare_masked_input(img, mask, 5).contiguous()
    tmpl = torch.from_numpy(np.stack([smooth(rng, (h, w))] * 2)).to(dev)
    persp = (1e-5, -2e-5) if motion == MotionType.Homography else (0, 0)
    m3 = torch.from_numpy(np.stack([
        rotation_inverse_map(h, w, a, 1.0, 2.5 * a, -1.25, persp=persp)
        for a in (0.7, -1.1)
    ])).to(dev)
    kw = dict(quant_affine=motion != MotionType.Homography)
    before = ecc_cuda.masked_launch_count
    got = ecc_cuda.ecc_iteration_moments(srcs, tmpl, m3, motion, **kw)
    want = ecc_cuda.ecc_iteration_moments_reference(srcs, tmpl, m3, motion,
                                                    **kw)
    torch.cuda.synchronize()
    assert ecc_cuda.masked_launch_count == before + 1
    g, wn = got.double().cpu().numpy(), want.double().cpu().numpy()
    assert _group_rel(g, wn, motion.num_params) < 1e-4


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.float32])
@pytest.mark.parametrize("quant_affine", [False, True])
def test_warp_moments_kernel_matches_plain(dev, dtype, quant_affine):
    """B4: the moments pass, then the clip pass fed with its mu and a
    tolerance; S0 and C0 bitwise, S1 / S2 within 1e-6 relative."""
    frames, truth = burst(4, 4, 150, 211)
    frames[1, 40:70, 30:150] = 255  # a glitch for the clip pass to remove
    frames = torch.from_numpy(frames).to(dev)
    if dtype == torch.uint16:
        frames = frames.to(torch.int32).mul(257).to(torch.uint16)
    elif dtype == torch.float32:
        frames = color.to_unit_f32(frames)
    minv = warp.invert_3x3(torch.from_numpy(truth).float().to(dev))
    valid = torch.tensor([True, True, False, True], device=dev)
    got = warp_accum_cuda.warp_moments_rgb(frames, minv, valid,
                                           quant_affine=quant_affine)
    want = warp_accum_cuda.warp_moments_rgb_reference(
        frames, minv, valid, quant_affine=quant_affine)
    mu = (want[1] / want[0].clamp(min=1.0)).contiguous()
    tol = torch.full_like(mu, 0.03)
    got_c = warp_accum_cuda.warp_moments_rgb(frames, minv, valid, mu, tol,
                                             quant_affine)
    want_c = warp_accum_cuda.warp_moments_rgb_reference(
        frames, minv, valid, mu, tol, quant_affine)
    torch.cuda.synchronize()
    for g, wn in ((got, want), (got_c, want_c)):
        assert torch.equal(g[0], wn[0])
        for a, b in zip(g[1:], wn[1:]):
            assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    assert float((got_c[0] - got[0]).min()) < 0.0  # the clip removed some


@pytest.mark.parametrize("mode", ["constant", "transparent", "replicate",
                                  "reflect", "reflect101", "wrap"])
@pytest.mark.parametrize("quant_affine", [False, True])
def test_warp_kernel_matches_plain(dev, mode, quant_affine):
    """B5 in every border mode, with shared sources and an output grid
    other than the source's: bitwise equal to its plain version."""
    rng = np.random.default_rng(9)
    h, w = 97, 150
    src = torch.from_numpy(np.stack([smooth(rng, (h, w)) for _ in range(2)]))
    src = src.to(dev)
    persp = (0.0, 0.0) if quant_affine else (2e-4, -1e-4)
    m = torch.from_numpy(np.stack([
        rotation_inverse_map(h, w, a, 1.1, 9.0 * a, -7.5, persp=persp)
        for a in (8.0, -3.0, 0.5)
    ])).to(dev)
    sidx = torch.tensor([1, 0, 1], device=dev)
    bv = torch.tensor([5.0, 6.0, 7.0], device=dev)
    for out_hw in (None, (h + 11, w - 13)):
        got = warp_cuda.warp_bilinear(src, m, bv, sidx, out_hw, quant_affine,
                                      mode)
        want = warp_cuda.warp_bilinear_reference(src, m, bv, sidx, out_hw,
                                                 quant_affine, mode)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("shape", list(warp_design.SHAPES))
@pytest.mark.parametrize("kind", warp_design.KINDS)
@pytest.mark.parametrize("mode", warp_design.MODES)
def test_warp_kernel_design_cases(dev, mode, kind, shape):
    """B5's planar form on the host-shim cases of
    tests/test_torch_warp_design.py (ties, sw == 0 rows, edges, far and
    shifted maps, odd widths, runs of equal maps, row origins), through
    the wrapper with host-side borders and source indices, bitwise equal
    to its plain version on the card."""
    for src, minv, bv, sidx, out_hw, rows in warp_design.planar_cases(
            kind, shape):
        src, minv = src.to(dev), minv.to(dev)
        for qa in (False, True):
            got = warp_cuda.warp_bilinear(src, minv, bv, sidx, out_hw, qa,
                                          mode, rows)
            want = warp_cuda.warp_bilinear_reference(src, minv, bv, sidx,
                                                     out_hw, qa, mode, rows)
            torch.cuda.synchronize()
            assert warp_design.bitwise(got, want), (qa, out_hw, rows)


@pytest.mark.parametrize("types", range(len(frames_design.TYPES)))
@pytest.mark.parametrize("kind", frames_design.KINDS)
@pytest.mark.parametrize("mode", warp_design.MODES)
def test_accum_kernel_design_cases(dev, mode, kind, types):
    """B5's accumulate form on the host-shim cases of
    tests/test_torch_warp_frames_design.py (ties, sw == 0 rows, edges,
    far and shifted maps, 1, 3 and 4 channels of u8, u16 and f32, odd
    widths, dropped frames with non-finite maps inside and across a
    block's staged chunk, row origins) through the wrapper, bitwise equal
    to its plain version on the card."""
    dtype, c = frames_design.TYPES[types]
    for frames, minv, valid, border, rows in frames_design.frames_cases(
            kind, dtype, c):
        frames, minv, valid = frames.to(dev), minv.to(dev), valid.to(dev)
        for qa in (False, True):
            got = warp_cuda.warp_frames(frames, minv, border, mode, qa, valid,
                                        rows)
            want = warp_cuda.warp_frames_reference(frames, minv, border, mode,
                                                   qa, valid, rows)
            torch.cuda.synchronize()
            assert warp_design.bitwise(got, want), (frames.shape, qa, rows)


@pytest.mark.parametrize("types", range(len(frames_design.TYPES)))
@pytest.mark.parametrize("kind", frames_design.KINDS)
@pytest.mark.parametrize("mode", warp_design.MODES)
def test_frames_kernel_design_cases(dev, mode, kind, types):
    """B5's frames form on the same cases with every frame warped (no
    ``valid``), bitwise equal to its plain version on the card."""
    dtype, c = frames_design.TYPES[types]
    for frames, minv, _, border, rows in frames_design.frames_cases(
            kind, dtype, c, drop=False):
        frames, minv = frames.to(dev), minv.to(dev)
        for qa in (False, True):
            got = warp_cuda.warp_frames(frames, minv, border, mode, qa, None,
                                        rows)
            want = warp_cuda.warp_frames_reference(frames, minv, border, mode,
                                                   qa, None, rows)
            torch.cuda.synchronize()
            assert warp_design.bitwise(got, want), (frames.shape, qa, rows)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.float32])
@pytest.mark.parametrize("mode", ["constant", "transparent", "replicate",
                                  "reflect", "reflect101", "wrap"])
@pytest.mark.parametrize("quant_affine", [False, True])
def test_warp_frames_kernel_matches_plain(dev, dtype, mode, quant_affine):
    """B5 on interleaved frames, both forms, bitwise against the plain
    version: taps past every edge, a dropped frame with a non-finite map,
    RGB and one-channel frames."""
    frames, _ = _burst_of(dev, dtype, 3, 97, 150)
    h, w = frames.shape[1:3]
    persp = (0.0, 0.0) if quant_affine else (2e-4, -1e-4)
    minv = torch.from_numpy(np.stack([
        rotation_inverse_map(h, w, a, 1.1, 9.0 * a, -7.5, persp=persp)
        for a in (8.0, -3.0, 0.5)
    ])).to(dev)
    valid = torch.tensor([True, False, True], device=dev)
    wild = minv.clone()
    wild[1] = float("nan")
    bv = [0.1, 0.2, 0.3]
    for src in (frames, frames[..., 1:2].contiguous()):
        b = bv[: src.shape[-1]]
        got = warp_cuda.warp_frames(src, minv, b, mode, quant_affine)
        want = warp_cuda.warp_frames_reference(src, minv, b, mode,
                                               quant_affine)
        acc = warp_cuda.warp_frames(src, wild, b, mode, quant_affine, valid)
        acc_want = warp_cuda.warp_frames_reference(src, wild, b, mode,
                                                   quant_affine, valid)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(acc, acc_want)


def _orb_level(dev, nf, h, w, k, seed):
    rng = np.random.default_rng(seed)
    imgs = torch.from_numpy(
        rng.integers(0, 256, (nf, h, w)).astype(np.uint8)).to(dev)
    ys = rng.integers(0, h, (nf, k)).astype(np.int32)
    xs = rng.integers(0, w, (nf, k)).astype(np.int32)
    ys[:, :6] = [0, 3, h - 1, h + 5, -7, 21]
    xs[:, :6] = [w - 1, -4, 2, w + 9, 0, w - 22]
    valid = np.ones((nf, k), bool)
    valid[:, 6:9] = False
    return (imgs, torch.from_numpy(ys).to(dev), torch.from_numpy(xs).to(dev),
            torch.from_numpy(valid).to(dev))


@pytest.mark.parametrize("shape", [(2, 120, 200), (3, 61, 1423), (1, 43, 43)])
def test_orb_harris_and_describe_kernels_match_plain(dev, shape):
    """B3h and B3d bitwise against their plain versions: centres at and
    beyond every clamp edge, invalid candidates, odd pyramid widths and a
    level of exactly one window."""
    nf, h, w = shape
    imgs, ys, xs, valid = _orb_level(dev, nf, h, w, 300, seed=h + w)
    for quota in (1, 150, 300):
        got = orb_cuda.select_keypoints(imgs, ys, xs, valid, quota)
        want = orb_cuda.select_keypoints_reference(imgs, ys, xs, valid,
                                                   quota)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    ang, desc = orb_cuda.describe(imgs, ys, xs)
    ang_want, desc_want = orb_cuda.describe_reference(imgs, ys, xs)
    torch.cuda.synchronize()
    assert torch.equal(ang, ang_want)
    assert torch.equal(desc, desc_want)


@pytest.mark.parametrize("case,k,quota", orb_design.SELECT_CASES
                         + [("random", 20000, 9000)])
def test_select_kernel_design_cases(dev, case, k, quota):
    """B3h on the host-shim cases of tests/test_torch_orb_design.py (flat,
    binary and all-invalid levels, +0.0 beside negative responses, K on
    both sides of a block's threads, quota == K) bitwise against its
    plain version on the card, and 20000 candidates a frame, past the
    card's shared capacity (the scratch rows)."""
    imgs, ys, xs, valid = orb_design._level(
        k + quota, nf=3, h=70, w=101, k=max(k, 9), binary=case == "binary")
    ys, xs, valid = ys[:, :k], xs[:, :k], valid[:, :k]
    if case == "flat":
        imgs = torch.full_like(imgs, 99)
    if case == "zeros":
        imgs[:, :, : imgs.shape[2] // 2] = 17
    if case == "invalid":
        valid = valid.clone()
        valid[1] = False
    args = [a.to(dev).contiguous() for a in (imgs, ys, xs, valid)]
    got = orb_cuda.select_keypoints(*args, quota)
    want = orb_cuda.select_keypoints_reference(*args, quota)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))


@pytest.mark.parametrize("w", [43, 140, 141, 142, 143])
@pytest.mark.parametrize("axis", [0, 1])
def test_describe_kernel_design_cases(dev, axis, w):
    """B3d on the host-shim cases of tests/test_torch_orb_design.py
    (windows mirrored about the keypoint's row or column, flat windows,
    every row pitch modulo 4, every byte alignment of a window) bitwise
    against its plain version on the card."""
    for seed in (w + axis, w + 7):
        imgs, ys, xs = orb_design._mirrored_level(
            seed, 3, 43 if w == 43 else 61, w, axis)
        imgs, ys, xs = imgs.to(dev), ys.to(dev), xs.to(dev)
        ang, desc = orb_cuda.describe(imgs, ys, xs)
        ang_want, desc_want = orb_cuda.describe_reference(imgs, ys, xs)
        torch.cuda.synchronize()
        assert torch.equal(ang, ang_want)
        assert torch.equal(desc, desc_want)


def test_orb_detect_builds_no_patch_tensor(dev):
    """On a CUDA level the detector runs B3h and B3d, not B3."""
    from libstacker_tpu_torch.ops import orb
    from libstacker_tpu_torch.utils.synth import make_textured_burst

    frames, _ = make_textured_burst(2, 270, 480, seed=2)
    grey = color.burst_grey_u8(frames.to(dev))
    before = (orb_cuda.launch_count, orb_cuda.harris_launch_count,
              orb_cuda.describe_launch_count)
    gpu = orb.orb_detect_and_compute(grey)
    cpu = orb.orb_detect_and_compute(grey.cpu())
    torch.cuda.synchronize()
    after = (orb_cuda.launch_count, orb_cuda.harris_launch_count,
             orb_cuda.describe_launch_count)
    assert after[0] == before[0]
    assert after[1] > before[1] and after[2] > before[2]
    for g, c in zip(gpu, cpu):
        assert g.shape == c.shape


def test_warp3_kernel_matches_plain(dev):
    rng = np.random.default_rng(10)
    h, w = 120, 181
    srcs = torch.from_numpy(np.stack([smooth(rng, (h, w)) for _ in range(3)]))
    srcs = srcs.to(dev)
    m = torch.from_numpy(np.stack([
        rotation_inverse_map(h, w, a, 1.0, 2.0 * a, 1.5, persp=(1e-4, 0.0))
        for a in (0.5, -2.0)
    ])).to(dev)
    for quant_affine in (False, True):
        got = warp_cuda.warp3_bilinear(srcs, m, quant_affine)
        want = warp_cuda.warp3_bilinear_reference(srcs, m, quant_affine)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_variant_slices_cuda_match_cpu(dev):
    """Sigma-clip and masked ECC, and the keypoint path with
    BORDER_REPLICATE, on the card against the port's CPU path."""
    from libstacker_tpu_torch import (KeyPointMatchParameters, ecc_match_arrays,
                                      keypoint_match_arrays)
    from libstacker_tpu_torch import constants
    from libstacker_tpu_torch.utils.synth import make_textured_burst

    frames, _ = burst(9, 4, 192, 256, max_shift=4.0, max_angle=0.4)
    mask = np.ones((192, 256), np.uint8)
    mask[:96, :64] = 0
    for kw in (dict(params=dict(stacking="sigma_clip", sigma_kappa=2.0)),
               dict(mask=mask)):
        kw = dict(kw)
        p = EccMatchParameters(MotionType.Homography, max_count=50,
                               epsilon=1e-4, gauss_filt_size=5,
                               coarse_levels=1, **kw.pop("params", {}))
        cpu, st_cpu = ecc_match_arrays(frames, p, return_stats=True,
                                       device="cpu", **kw)
        gpu, st_gpu = ecc_match_arrays(frames, p, return_stats=True,
                                       device=dev, **kw)
        assert st_cpu.frames_kept == st_gpu.frames_kept == 4
        np.testing.assert_allclose(st_gpu.ecc_rho, st_cpu.ecc_rho, atol=1e-3)
        assert np.abs(gpu[8:-8, 8:-8] - cpu[8:-8, 8:-8]).max() < 0.02
    kframes, _ = make_textured_burst(4, 270, 480, seed=2)
    kp = KeyPointMatchParameters(border_mode=constants.BORDER_REPLICATE)
    d_cpu, cpu = keypoint_match_arrays(kframes.numpy(), kp, device="cpu")
    d_gpu, gpu = keypoint_match_arrays(kframes.numpy(), kp, device=dev)
    assert d_cpu == d_gpu == 0
    assert np.abs(gpu[16:-16, 16:-16] - cpu[16:-16, 16:-16]).max() < 0.02


@pytest.mark.parametrize("motion", list(MotionType))
@pytest.mark.parametrize("with_hessian", [True, False])
def test_ic_moments_kernel_matches_plain(dev, motion, with_hessian):
    """B7 against its plain version at B1's bar; an inactive lane gives a
    zero row."""
    rng = np.random.default_rng(17)
    h, w = 200, 333
    img = torch.from_numpy(smooth(rng, (h, w))).to(dev)
    src = ecc._input_fields(img, 5)[0].contiguous()
    tmpl = torch.from_numpy(np.stack([smooth(rng, (h, w))] * 3)).to(dev)
    persp = (1e-5, -2e-5) if motion == MotionType.Homography else (0, 0)
    m3 = torch.from_numpy(np.stack([
        rotation_inverse_map(h, w, a, 1.0, 2.5 * a, -1.25, persp=persp)
        for a in (0.0, 0.7, -1.1)
    ])).to(dev)
    active = torch.tensor([True, False, True], device=dev)
    kw = dict(quant_affine=motion != MotionType.Homography, active=active,
              with_hessian=with_hessian)
    got = ecc_cuda.ecc_ic_iteration_moments(src, tmpl, m3, motion, **kw)
    want = ecc_cuda.ecc_ic_iteration_moments_reference(src, tmpl, m3, motion,
                                                       **kw)
    torch.cuda.synchronize()
    g, wn = got.double().cpu().numpy(), want.double().cpu().numpy()
    assert g.shape == (3, ecc_cuda.moments_layout(motion, with_hessian)[1])
    assert np.all(g[1] == 0.0)
    assert _group_rel(g, wn, motion.num_params) < 1e-4


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.float32])
@pytest.mark.parametrize("perspective", [False, True])
@pytest.mark.parametrize("sigma", [0.3, 0.1])
def test_sr_deposit_kernel_matches_plain(dev, dtype, perspective, sigma):
    """B6 against its plain version: the same taps, and weights that may
    differ by an ulp of exp between the kernel's expf and PyTorch's."""
    from libstacker_tpu_torch.ops import sr_cuda

    rng = np.random.default_rng(23)
    h, w, f = 97, 131, 3
    frames = rng.integers(0, 256, (4, h, w, 3))
    if dtype == torch.uint16:
        frames = frames * 257
    frames = torch.from_numpy(frames.astype(
        {torch.uint8: np.uint8, torch.uint16: np.uint16,
         torch.float32: np.float32}[dtype])).to(dev)
    if dtype == torch.float32:
        frames = frames / 255.0
    persp = (1e-4, -5e-5) if perspective else (0.0, 0.0)
    minv = torch.from_numpy(np.stack([
        rotation_inverse_map(h, w, a, 1.0, 0.37 * a, -0.6, persp=persp)
        for a in (0.0, 0.8, -1.3, 2.1)
    ])).to(dev)
    valid = torch.tensor([True, True, False, True], device=dev)
    got = sr_cuda.sr_deposit(frames, minv, valid, f, sigma, perspective,
                             sigma < 0.15)
    want = sr_cuda.sr_deposit_reference(frames, minv, valid, f, sigma,
                                        perspective, sigma < 0.15)
    torch.cuda.synchronize()
    assert len(got) == len(want) == (4 if sigma < 0.15 else 2)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        d = (a - b).abs()
        assert float(d.max()) <= 1e-5 * max(float(b.abs().max()), 1.0)


def _sr_burst(dev, dtype, n_frames, h, w, seed=29):
    """A random ``[N,H,W,3]`` burst in ``dtype`` on the card."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n_frames, h, w, 3))
    if dtype == torch.uint16:
        frames = frames * 257
    np_dtype = {torch.uint8: np.uint8, torch.uint16: np.uint16,
                torch.float32: np.float32}[dtype]
    frames = torch.from_numpy(frames.astype(np_dtype)).to(dev)
    return frames / 255.0 if dtype == torch.float32 else frames


def _sr_maps(dev, kind, n_frames, h, w):
    """Inverse maps: frame 0 the identity, the others rotated, scaled,
    shifted by fractions of a pixel, with a perspective row or not."""
    persp = (1e-4, -5e-5) if kind == "homography" else (0.0, 0.0)
    mats = [np.eye(3, dtype=np.float32)] + [
        rotation_inverse_map(h, w, a, 1.0 + 0.01 * a, 0.37 * a, -0.6,
                             persp=persp)
        for a in np.linspace(-1.3, 2.1, n_frames - 1)]
    return torch.from_numpy(np.stack(mats)).to(dev)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.float32])
@pytest.mark.parametrize("factor", [2, 3, 4])
@pytest.mark.parametrize("sigma", [0.3, 0.1])
@pytest.mark.parametrize("kind", ["affine", "homography"])
@pytest.mark.parametrize("w", [131, 128])
def test_sr_image_kernel_matches_plain(dev, dtype, factor, sigma, kind, w):
    """B6's image form (``sr_image``) bitwise against its plain version:
    u8 / u16 / f32 frames, factors 2-4, sigma 0.3 and 0.1 (the fallback
    form), affine and perspective maps, frame 2 dropped; at w = 131 the
    fine widths 262 and 393 take the scalar stores, 524 and every fine
    width of w = 128 the 16-byte ones."""
    from libstacker_tpu_torch.ops import sr_cuda

    h = 45
    frames = _sr_burst(dev, dtype, 5, h, w)
    minv = _sr_maps(dev, kind, 5, h, w)
    valid = torch.tensor([True, True, False, True, True], device=dev)
    args = (frames, minv, valid, factor, sigma, kind == "homography",
            sigma < 0.15)
    before = sr_cuda.image_launch_count
    got = sr_cuda.sr_image(*args)
    want = sr_cuda.sr_image_reference(*args)
    torch.cuda.synchronize()
    assert sr_cuda.image_launch_count == before + 1
    assert got.shape == want.shape == (h * factor, w * factor, 3)
    assert torch.equal(got, want)


@pytest.mark.parametrize("sigma", [0.3, 0.1])
def test_sr_kernels_stage_frames_twice(dev, sigma):
    """More frames than a block stages at once (64): both forms sweep
    them in two stages, a dropped frame in each; the deposit at its
    bar, the image bitwise."""
    from libstacker_tpu_torch.ops import sr_cuda

    n_frames, h, w = 70, 24, 40
    frames = _sr_burst(dev, torch.uint8, n_frames, h, w, seed=30)
    minv = _sr_maps(dev, "homography", n_frames, h, w)
    valid = torch.ones(n_frames, dtype=torch.bool, device=dev)
    valid[[7, 66]] = False
    args = (frames, minv, valid, 2, sigma, True, sigma < 0.15)
    got_i = sr_cuda.sr_image(*args)
    want_i = sr_cuda.sr_image_reference(*args)
    got = sr_cuda.sr_deposit(*args)
    want = sr_cuda.sr_deposit_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got_i, want_i)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * max(float(b.abs().max()),
                                                        1.0)


@pytest.mark.parametrize("sigma", [0.3, 0.1])
def test_sr_deposit_kernel_vector_stores(dev, sigma):
    """B6's deposit form where fW % 4 == 0 (16-byte stores of the
    interleaved sums, the weights and the fallback sums) at the deposit's
    bar, and the CUDA super-resolution stack through one image launch
    and no deposit launch, bitwise to the image's plain version."""
    from libstacker_tpu_torch.ops import sr_cuda, stack

    h, w = 40, 64
    frames = _sr_burst(dev, torch.uint8, 4, h, w, seed=31)
    minv = _sr_maps(dev, "homography", 4, h, w)
    valid = torch.tensor([True, False, True, True], device=dev)
    args = (frames, minv, valid, 2, sigma, True, sigma < 0.15)
    got = sr_cuda.sr_deposit(*args)
    want = sr_cuda.sr_deposit_reference(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * max(float(b.abs().max()),
                                                        1.0)
    mats = torch.linalg.inv(minv[1:])
    dep, img = sr_cuda.launch_count, sr_cuda.image_launch_count
    out = stack.super_res_stack(frames, mats, valid[1:], factor=2,
                                kernel_sigma=sigma)
    assert sr_cuda.launch_count == dep
    assert sr_cuda.image_launch_count == img + 1
    mats_all, oks_all = stack._prepare_lanes(mats, valid[1:], frames.device)
    minv_all = warp.invert_3x3(mats_all).contiguous()
    assert torch.equal(out, sr_cuda.sr_image_reference(
        frames, minv_all, oks_all, 2, sigma, True, sigma < 0.15))


@pytest.mark.parametrize("lanes", [1, 3, 17])
@pytest.mark.parametrize("w", [181, 256])
@pytest.mark.parametrize("quant_affine", [False, True])
def test_warp3_kernel_bitwise(dev, lanes, w, quant_affine):
    """B9 bitwise against its plain version for 1, 3 and 17 lanes, an
    odd width (scalar stores) and a width of 256 (16-byte stores), the
    homography form and the quantised affine one."""
    rng = np.random.default_rng(40 + lanes)
    h = 67
    srcs = torch.from_numpy(np.stack([smooth(rng, (h, w)) for _ in range(3)]))
    srcs = srcs.to(dev)
    persp = (0.0, 0.0) if quant_affine else (1e-4, -3e-5)
    m = torch.from_numpy(np.stack([
        rotation_inverse_map(h, w, a, 1.0 + 0.02 * a, 1.7 * a, -0.8,
                             persp=persp)
        for a in np.linspace(-3.0, 3.0, lanes)
    ])).to(dev)
    before = warp_cuda.warp3_launch_count
    got = warp_cuda.warp3_bilinear(srcs, m, quant_affine)
    want = warp_cuda.warp3_bilinear_reference(srcs, m, quant_affine)
    torch.cuda.synchronize()
    assert warp_cuda.warp3_launch_count == before + 1
    assert torch.equal(got, want)


def test_opt_in_paths_cuda_match_cpu(dev):
    """The lazy and IC solvers, the rotation start and super-resolution
    on the card against the port's CPU path."""
    from libstacker_tpu_torch import (KeyPointMatchParameters, ecc_match_arrays,
                                      keypoint_match_arrays)
    from libstacker_tpu_torch.utils.synth import make_textured_burst

    frames, _ = burst(11, 4, 192, 256, max_shift=4.0, max_angle=0.4)
    for opt in (dict(solver="lazy"), dict(solver="ic"),
                dict(phase_init_rotation=True), dict(output_scale=2)):
        p = EccMatchParameters(MotionType.Homography, max_count=50,
                               epsilon=1e-4, gauss_filt_size=5,
                               coarse_levels=1, **opt)
        cpu, st_cpu = ecc_match_arrays(frames, p, return_stats=True,
                                       device="cpu")
        gpu, st_gpu = ecc_match_arrays(frames, p, return_stats=True,
                                       device=dev)
        assert st_cpu.frames_kept == st_gpu.frames_kept == 4, opt
        np.testing.assert_allclose(st_gpu.ecc_rho, st_cpu.ecc_rho, atol=1e-3)
        c = 8 * p.output_scale
        assert np.abs(gpu[c:-c, c:-c] - cpu[c:-c, c:-c]).max() < 0.02, opt
    kframes, _ = make_textured_burst(4, 270, 480, seed=2)
    kp = KeyPointMatchParameters(output_scale=2)
    d_cpu, cpu = keypoint_match_arrays(kframes.numpy(), kp, device="cpu")
    d_gpu, gpu = keypoint_match_arrays(kframes.numpy(), kp, device=dev)
    assert d_cpu == d_gpu == 0 and gpu.shape == (540, 960, 3)
    assert np.abs(gpu[32:-32, 32:-32] - cpu[32:-32, 32:-32]).mean() < 0.01


def test_single_frame_output_scale_on_card(dev):
    """n == 1 with ``output_scale=2``: frame 0 upsampled on the card
    (the result stays there with ``device_output``) against the CPU
    path."""
    from libstacker_tpu_torch import (KeyPointMatchParameters, ecc_match_arrays,
                                      keypoint_match_arrays)

    frames, _ = burst(12, 1, 96, 128, max_shift=0.0, max_angle=0.0)
    p = EccMatchParameters(MotionType.Homography, output_scale=2)
    cpu = ecc_match_arrays(frames, p, device="cpu")
    gpu = ecc_match_arrays(frames, p, device=dev, device_output=True)
    assert gpu.device.type == "cuda" and tuple(gpu.shape) == (192, 256, 3)
    np.testing.assert_allclose(gpu.cpu().numpy(), cpu, atol=1e-6)
    on_card = torch.from_numpy(frames).to(dev)
    np.testing.assert_allclose(ecc_match_arrays(on_card, p), cpu, atol=1e-6)
    _, kgpu = keypoint_match_arrays(
        frames, KeyPointMatchParameters(output_scale=2), device=dev)
    np.testing.assert_allclose(kgpu, cpu, atol=1e-6)


def _burst_of(dev, dtype, n_frames, h, w, seed=4):
    frames, truth = burst(seed, n_frames, h, w)
    frames = torch.from_numpy(frames).to(dev)
    if dtype == torch.uint16:
        frames = frames.to(torch.int32).mul(257).to(torch.uint16)
    elif dtype == torch.float32:
        frames = color.to_unit_f32(frames)
    return frames, warp.invert_3x3(torch.from_numpy(truth).float().to(dev))


def _maps(dev, kind, n_frames, h, w):
    """``n_frames`` inverse maps of one kind: near-identity affine or
    perspective, 30 degrees, or a strong perspective term; shifts that
    put s*32 on a rounding tie (k + 1/2) or a few ulps off it (and s*1024
    for the affine form's ties); coordinates on the coverage edges 0 and
    W-1 / H-1; a row where sw == 0 with sw <= 1e-6 beyond it."""
    mats = []
    for i in range(n_frames):
        sign = 1 - 2 * (i % 2)
        if kind == "ties":
            e = (2 * i + 1) / 64.0
            m = [[1, 0, e - 3], [0, 1, -e], [0, 0, 1]]
        elif kind == "near_ties":
            e = float(np.nextafter(np.float32(1 / 64.0), np.float32(sign),
                                   dtype=np.float32)) * (i + 1)
            m = [[1, 0, e], [0, 1, -e], [0, 0, 1]]
        elif kind == "affine_ties":
            e = (2 * i + 1) / 2048.0
            m = [[1, 0, e], [0, 1, -e + 1 / 32.0], [0, 0, 1]]
        elif kind == "edges":
            m = [[1, 0, 0], [0, 1, 0], [0, 0, 1]] if i % 2 else [
                [(w - 1) / max(w - 1.0, 1.0), 0, 0], [0, 1, 0], [0, 0, 1]]
        elif kind == "horizon":
            row = max(h // 2, 1)
            m = [[1, 0.01, 0.5], [0.02, 1, -0.25], [1e-7 * i, -1.0 / row, 1.0]]
        else:
            deg, persp = {"affine": (0.5, (0, 0)),
                          "perspective": (0.5, (2e-5, -3e-5)),
                          "rot30": (30.0, (0, 0)),
                          "strong": (4.0, (2e-3, 1e-3))}[kind]
            m = rotation_inverse_map(h, w, deg * sign, 1.0, 2.5, -1.5,
                                     persp=persp)
        mats.append(np.asarray(m, np.float32))
    return torch.from_numpy(np.stack(mats) if mats else
                            np.zeros((0, 3, 3), np.float32)).to(dev)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.float32])
@pytest.mark.parametrize("kind", ["affine", "perspective", "rot30", "strong",
                                  "ties", "near_ties", "affine_ties",
                                  "edges", "horizon"])
@pytest.mark.parametrize("shape", [(4, 150, 211), (1, 97, 33), (2, 1, 5),
                                   (1, 3, 1), (2, 4, 2), (1, 5, 3),
                                   (0, 6, 5), (2, 3, 3841), (258, 3, 5),
                                   (513, 2, 33), (2, 3, 6001), (1, 2, 8200)])
@pytest.mark.parametrize("drop", ["last", "all"])
def test_warp_accum_bitwise(dev, dtype, kind, shape, drop):
    """B2 and B4 (moments and clip pass) bitwise against their plain
    versions, at near-identity, 30-degree and strongly perspective maps,
    ties and near-ties of the 1/32 (and affine 1/1024) rounding,
    coordinates on the coverage edges, rows where sw == 0 and sw <= 1e-6,
    widths that are no multiple of a thread's pixels (1, 2, 3, 5, 3841),
    H = 1, N = 0 and 1, more frames than a block stages at once (258,
    513), widths past the affine bins' range (6001 inside 2^13, 8200
    beyond), one frame or every frame dropped, and a border value per
    channel."""
    n_frames, h, w = shape
    if n_frames:
        frames, _ = _burst_of(dev, dtype, n_frames, h, w)
    else:
        frames = torch.zeros((0, h, w, 3), dtype=dtype, device=dev)
    minv = _maps(dev, kind, n_frames, h, w)
    qa = kind in ("affine", "affine_ties")
    valid = torch.ones(n_frames, dtype=torch.bool, device=dev)
    if n_frames:
        valid[-1] = n_frames == 1
    if drop == "all":
        valid[:] = False
    bv = [0.1, 0.2, 0.3]
    got = warp_accum_cuda.warp_accum_rgb(frames, minv, valid, bv, qa)
    want = warp_accum_cuda.warp_accum_rgb_reference(frames, minv, valid, bv,
                                                    qa)
    mom = warp_accum_cuda.warp_moments_rgb(frames, minv, valid,
                                           quant_affine=qa)
    mom_want = warp_accum_cuda.warp_moments_rgb_reference(
        frames, minv, valid, quant_affine=qa)
    mu = (mom_want[1] / mom_want[0].clamp(min=1.0)).contiguous()
    tol = torch.full_like(mu, 0.03)
    clip = warp_accum_cuda.warp_moments_rgb(frames, minv, valid, mu, tol, qa)
    clip_want = warp_accum_cuda.warp_moments_rgb_reference(
        frames, minv, valid, mu, tol, qa)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for g, wn in zip(mom + clip, mom_want + clip_want):
        assert torch.equal(g, wn)


def test_warp_accum_every_frame_dropped(dev):
    frames, minv = _burst_of(dev, torch.uint8, 3, 150, 211)
    valid = torch.zeros(3, dtype=torch.bool, device=dev)
    got = warp_accum_cuda.warp_accum_rgb(frames, minv, valid)
    mom = warp_accum_cuda.warp_moments_rgb(frames, minv, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, warp_accum_cuda.warp_accum_rgb_reference(
        frames, minv, valid))
    assert float(got.abs().max()) == 0.0
    assert all(float(s.abs().max()) == 0.0 for s in mom)


@pytest.mark.parametrize("motion", [MotionType.Affine, MotionType.Homography])
@pytest.mark.parametrize("with_hessian", [True, False])
def test_ic_moments_kernel_tile_edges(dev, motion, with_hessian):
    """B7 where the column walk meets the tile's and the warps' edges: a
    height no multiple of the 64-row tile, a width crossing two 128-column
    tiles and not a multiple of 32; an inactive lane stays zero."""
    rng = np.random.default_rng(23)
    h, w = 131, 269
    img = torch.from_numpy(smooth(rng, (h, w))).to(dev)
    src = ecc._input_fields(img, 5)[0].contiguous()
    tmpl = torch.from_numpy(np.stack([smooth(rng, (h, w))] * 3)).to(dev)
    persp = (1e-5, -2e-5) if motion == MotionType.Homography else (0, 0)
    m3 = torch.from_numpy(np.stack([
        rotation_inverse_map(h, w, a, 1.0, 1.5 * a, 0.75, persp=persp)
        for a in (0.3, -0.8, 1.2)
    ])).to(dev)
    active = torch.tensor([True, True, False], device=dev)
    kw = dict(quant_affine=motion != MotionType.Homography, active=active,
              with_hessian=with_hessian)
    got = ecc_cuda.ecc_ic_iteration_moments(src, tmpl, m3, motion, **kw)
    want = ecc_cuda.ecc_ic_iteration_moments_reference(src, tmpl, m3, motion,
                                                       **kw)
    torch.cuda.synchronize()
    g, wn = got.double().cpu().numpy(), want.double().cpu().numpy()
    assert np.all(g[2] == 0.0)
    assert _group_rel(g, wn, motion.num_params) < 1e-4


def test_native_loader_on_card(tmp_path, dev):
    """The native loader where it builds on the card's host: a 16-bit PNG
    written by ``save_image`` decodes at full depth."""
    from libstacker_tpu_torch.utils import io, native_loader

    if not native_loader.available():
        pytest.skip(f"native loader not built: {native_loader.build_error()}")
    rgb16 = np.random.default_rng(1).integers(0, 65536, (33, 47, 3),
                                              dtype=np.uint16)
    io.save_image(tmp_path / "a.png", rgb16, bit_depth=16)
    got = io.load_frames([tmp_path / "a.png"], preserve_depth=True)
    np.testing.assert_array_equal(got[0], rgb16)


def test_stack_burst_preserve_depth_on_card(tmp_path, dev):
    """The workflow on 48-bit PNGs with ``--preserve-depth``: the uint16
    burst is reordered on the card (CUDA gathers no uint16) and stacked
    to 16-bit PNGs."""
    from libstacker_tpu_torch import stack_burst
    from libstacker_tpu_torch.utils import io
    from libstacker_tpu_torch.utils.synth import make_textured_burst

    frames = make_textured_burst(4, 270, 480, seed=3)[0].numpy()
    rgb16 = (frames.astype(np.uint16) << 8) | np.random.default_rng(
        3).integers(0, 256, frames.shape, dtype=np.uint16)
    (tmp_path / "in").mkdir()
    for i, f in enumerate(rgb16):
        io.save_image(tmp_path / "in" / f"f{i}.png", f, bit_depth=16)
    rc = stack_burst.main([str(tmp_path / "in"), "--out",
                           str(tmp_path / "out"), "--device", "cuda",
                           "--max-count", "50", "--coarse-levels", "1",
                           "--preserve-depth", "--out-depth", "16"])
    assert rc == 0
    outs = sorted((tmp_path / "out").iterdir())
    assert len(outs) == 4
    for p in outs:
        img = io.load_frames([p], preserve_depth=True)[0]
        assert img.dtype == np.uint16 and img.shape == (270, 480, 3)


def _rgb16_files(d, frames, seed):
    """u8 frames in the high byte, seeded noise in the low -> 48-bit PNG
    files in ``d`` (written through the native library where it loads)."""
    from libstacker_tpu_torch.utils import io

    rgb16 = (frames.astype(np.uint16) << 8) | np.random.default_rng(
        seed).integers(0, 256, frames.shape, dtype=np.uint16)
    d.mkdir(parents=True, exist_ok=True)
    files = [str(d / f"f{i:02d}.png") for i in range(len(rgb16))]
    for f, img in zip(files, rgb16):
        io.save_image(f, img, bit_depth=16)
    np.testing.assert_array_equal(io.load_frames(files, preserve_depth=True),
                                  rgb16)
    return files


@pytest.mark.parametrize("path", ["ecc_stream", "ecc_stream_sigma",
                                  "ecc_mesh", "keypoint_stream",
                                  "keypoint_mesh"])
def test_16bit_files_on_card(dev, tmp_path, path):
    """48-bit PNG files with ``preserve_depth=True`` through the streams and
    ``mesh=`` on the card (uint16 chunks and shards on CUDA) against the
    CPU path on the same files, at the slice bars."""
    import dataclasses

    from libstacker_tpu_torch import (
        KeyPointMatchParameters, ecc_match, ecc_match_stream, keypoint_match,
        keypoint_match_stream,
    )
    from libstacker_tpu_torch.parallel import make_mesh
    from libstacker_tpu_torch.utils.synth import make_textured_burst

    if path.startswith("ecc"):
        frames = burst(9, 6, 192, 256, max_shift=4.0, max_angle=0.4)[0]
        files = _rgb16_files(tmp_path, frames, 9)
        p = EccMatchParameters(MotionType.Homography, max_count=50,
                               epsilon=1e-4, gauss_filt_size=5,
                               coarse_levels=1)
        if path == "ecc_stream_sigma":
            p = dataclasses.replace(p, stacking="sigma_clip", sigma_iters=2)
        if path == "ecc_mesh":
            def run(d):
                return ecc_match(files, p, preserve_depth=True,
                                 mesh=make_mesh([d] * 3))
        else:
            def run(d):
                return ecc_match_stream(files, p, chunk_size=2,
                                        preserve_depth=True, device=d)
        gpu, cpu = run(dev), run("cpu")
        assert gpu.shape == cpu.shape == (192, 256, 3)
        assert np.abs(gpu[8:-8, 8:-8] - cpu[8:-8, 8:-8]).max() < 0.02
        return
    frames = make_textured_burst(5, 270, 480, seed=2)[0].numpy()
    files = _rgb16_files(tmp_path, frames, 2)
    params = KeyPointMatchParameters()
    if path == "keypoint_mesh":
        def run(d):
            return keypoint_match(files, params, preserve_depth=True,
                                  mesh=make_mesh([d] * 2))
    else:
        def run(d):
            return keypoint_match_stream(files, params, chunk_size=2,
                                         preserve_depth=True, device=d)
    (d_gpu, gpu), (d_cpu, cpu) = run(dev), run("cpu")
    assert d_gpu == d_cpu == 0 and gpu.shape == (270, 480, 3)
    diff = np.abs(gpu[16:-16, 16:-16] - cpu[16:-16, 16:-16])
    assert np.quantile(diff, 0.99) < 0.02 and diff.mean() < 0.01


def _png_files(d, frames):
    from PIL import Image

    d.mkdir(parents=True, exist_ok=True)
    files = []
    for i, f in enumerate(frames):
        Image.fromarray(np.ascontiguousarray(f)).save(d / f"f{i:02d}.png")
        files.append(str(d / f"f{i:02d}.png"))
    return files


def test_sharpness_cuda_matches_cpu(dev):
    from libstacker_tpu_torch import sharpness_all, sharpness_tenengrad

    rng = np.random.default_rng(5)
    grey = rng.integers(0, 256, (3, 270, 481), np.uint8)
    cpu = sharpness_all(grey, device="cpu")
    gpu = sharpness_all(grey, device=dev)
    for k in cpu:
        assert gpu[k].device.type == "cuda"
        rel = ((gpu[k].cpu().double() - cpu[k].double()).abs()
               / cpu[k].double().abs()).max()
        assert float(rel) <= 1e-5, k
    for k in (1, 5, 7):
        a = sharpness_tenengrad(torch.from_numpy(grey).to(dev), k).cpu()
        b = sharpness_tenengrad(torch.from_numpy(grey), k)
        assert float(((a.double() - b.double()) / b.double()).abs().max()) <= 1e-5


def test_chunk_uploader_cuda(dev):
    from libstacker_tpu_torch.utils.device import ChunkUploader

    rng = np.random.default_rng(6)
    up = ChunkUploader(dev)
    chunks = [rng.integers(0, 256, (n, 33, 47, 3), np.uint8) for n in (4, 4, 3, 4)]
    handles, outs = [], []
    for c in chunks:  # three puts in flight before the first is read
        handles.append(up.put(c))
        if len(handles) > 1:
            outs.append(up.ready(handles[-2]))
    outs.append(up.ready(handles[-1]))
    for c, o in zip(chunks, outs):
        assert o.device.type == "cuda"
        np.testing.assert_array_equal(o.cpu().numpy(), c)


def test_ecc_streams_cuda_match_cpu(dev, tmp_path):
    """Mean and sigma-clip ECC streams on the card against the port's CPU
    streams at the slice bars, through B1 + B2 and B1 + B4."""
    import dataclasses

    from libstacker_tpu_torch import ecc_match_stream

    frames, _ = burst(9, 6, 192, 256, max_shift=4.0, max_angle=0.4)
    files = _png_files(tmp_path, frames)
    p = EccMatchParameters(MotionType.Homography, max_count=50, epsilon=1e-4,
                           gauss_filt_size=5, coarse_levels=1)
    for params, kernel in (
        (p, "launch_count"),
        (dataclasses.replace(p, stacking="sigma_clip", sigma_iters=2),
         "moments_launch_count"),
    ):
        b1 = ecc_cuda.launch_count
        stack_launches = getattr(warp_accum_cuda, kernel)
        gpu, st_gpu = ecc_match_stream(files, params, chunk_size=2,
                                       return_stats=True, device=dev)
        torch.cuda.synchronize()
        assert ecc_cuda.launch_count > b1
        assert getattr(warp_accum_cuda, kernel) > stack_launches
        cpu, st_cpu = ecc_match_stream(files, params, chunk_size=2,
                                       return_stats=True, device="cpu")
        assert st_cpu.frames_kept == st_gpu.frames_kept == 6
        np.testing.assert_allclose(st_gpu.ecc_rho, st_cpu.ecc_rho, atol=1e-3)
        assert np.abs(gpu[8:-8, 8:-8] - cpu[8:-8, 8:-8]).max() < 0.02


def test_keypoint_streams_cuda_match_cpu(dev, tmp_path):
    """Mean and sigma-clip keypoint streams on the card against the CPU
    streams (RANSAC's draws differ between devices: p99 and mean bars),
    detecting through B8, B3h and B3d and never B3."""
    from libstacker_tpu_torch import KeyPointMatchParameters, keypoint_match_stream
    from libstacker_tpu_torch.utils.synth import make_textured_burst

    frames = make_textured_burst(5, 270, 480, seed=2)[0].numpy()
    files = _png_files(tmp_path, frames)
    for params in (KeyPointMatchParameters(),
                   KeyPointMatchParameters(stacking="sigma_clip")):
        before = (fast_cuda.launch_count, orb_cuda.harris_launch_count,
                  orb_cuda.describe_launch_count, orb_cuda.launch_count)
        d_gpu, gpu = keypoint_match_stream(files, params, chunk_size=2,
                                           device=dev)
        torch.cuda.synchronize()
        after = (fast_cuda.launch_count, orb_cuda.harris_launch_count,
                 orb_cuda.describe_launch_count, orb_cuda.launch_count)
        assert all(a > b for a, b in zip(after[:3], before[:3]))
        assert after[3] == before[3]
        d_cpu, cpu = keypoint_match_stream(files, params, chunk_size=2,
                                           device="cpu")
        assert d_cpu == d_gpu == 0
        diff = np.abs(gpu[16:-16, 16:-16] - cpu[16:-16, 16:-16])
        assert np.quantile(diff, 0.99) < 0.02 and diff.mean() < 0.01


def test_stream_resume_cuda_bitwise(dev, tmp_path, monkeypatch):
    """A stream killed inside the sigma-clip sweeps on the card resumes
    from its checkpoint and equals the uninterrupted run bitwise."""
    from libstacker_tpu_torch import ecc_match_stream
    from libstacker_tpu_torch.utils import io as io_mod
    from test_torch_stream_resume import _CallCrasher

    frames, _ = burst(4, 7, 96, 128, max_shift=3.0, max_angle=0.3)
    files = _png_files(tmp_path / "b", frames)
    p = EccMatchParameters(MotionType.Homography, max_count=50, epsilon=1e-4,
                           stacking="sigma_clip", sigma_iters=2)
    ref = ecc_match_stream(files, p, chunk_size=2, device=dev)
    ck = tmp_path / "ck.npz"
    monkeypatch.setattr(io_mod, "prefetched_chunks",
                        _CallCrasher(crash_call=2, limit=2))
    with pytest.raises(RuntimeError, match="simulated crash"):
        ecc_match_stream(files, p, chunk_size=2, checkpoint_path=ck,
                         checkpoint_every=1, device=dev)
    assert ck.exists()
    resume = _CallCrasher()
    monkeypatch.setattr(io_mod, "prefetched_chunks", resume)
    out = ecc_match_stream(files, p, chunk_size=2, checkpoint_path=ck,
                           checkpoint_every=1, device=dev)
    assert resume.starts == [4, 0]
    np.testing.assert_array_equal(out, ref)
    assert not ck.exists()


@pytest.mark.parametrize("quant_affine", [False, True])
def test_warp_row_origins_kernels_match_plain(dev, quant_affine):
    """B5's row origins on the card (planar and accumulate forms): a strip
    of source rows warped with the global map equals the plain version
    and the whole frame's rows bitwise."""
    rng = np.random.default_rng(4)
    h, w = 96, 130
    src = torch.from_numpy(np.stack([smooth(rng, (h, w)) for _ in range(3)]))
    persp = (0.0, 0.0) if quant_affine else (2e-4, -1e-4)
    minv = torch.from_numpy(np.stack([
        rotation_inverse_map(h, w, a, 1.0, 2.0 * a, -1.5, persp=persp)
        for a in (1.5, -0.5, 0.25)]))
    lo, hi, halo = 40, 64, 16
    valid = torch.tensor([True, False, True])
    frames = src.permute(1, 2, 0)[None].expand(3, h, w, 3).contiguous()
    for d in (dev, torch.device("cpu")):
        s, m, f, v = src.to(d), minv.to(d), frames.to(d), valid.to(d)
        full = warp_cuda.warp_bilinear(s, m, quant_affine=quant_affine)
        band = warp_cuda.warp_bilinear(
            s[:, lo - halo : hi + halo].contiguous(), m, out_hw=(hi - lo, w),
            quant_affine=quant_affine, rows=(lo, lo - halo))
        acc = warp_cuda.warp_frames(f, m, quant_affine=quant_affine, valid=v)
        bacc = warp_cuda.warp_frames(
            f[:, lo - halo : hi + halo].contiguous(), m,
            quant_affine=quant_affine, valid=v, rows=(lo - halo, lo - halo))
        assert torch.equal(band, full[:, lo:hi])
        assert torch.equal(bacc[halo:-halo], acc[lo:hi])
        if d.type == "cuda":
            on_card = (band.cpu(), bacc.cpu())
    assert torch.equal(on_card[0], band) and torch.equal(on_card[1], bacc)


def test_mesh_paths_cuda_match_cpu(dev):
    """``mesh=`` on shards of the card against the same mesh on the CPU:
    ECC mean and SR (B6's deposit form, never its image form), the
    keypoint mean, and the row-band warp bitwise against the dense one."""
    from libstacker_tpu_torch import (
        KeyPointMatchParameters, ecc_match_arrays, keypoint_match_arrays,
    )
    from libstacker_tpu_torch.ops import sr_cuda
    from libstacker_tpu_torch.parallel import make_mesh, warp_rows_sharded
    from libstacker_tpu_torch.utils.synth import make_textured_burst

    frames, _ = burst(6, 5, 96, 128, max_shift=3.0, max_angle=0.3)
    gpu_mesh, cpu_mesh = make_mesh([dev] * 3), make_mesh(["cpu"] * 3)
    for params in (EccMatchParameters(MotionType.Homography, max_count=50,
                                      epsilon=1e-4),
                   EccMatchParameters(MotionType.Homography, max_count=50,
                                      epsilon=1e-4, output_scale=2)):
        before = (sr_cuda.launch_count, sr_cuda.image_launch_count)
        gpu = ecc_match_arrays(frames, params, mesh=gpu_mesh)
        torch.cuda.synchronize()
        if params.output_scale > 1:
            assert sr_cuda.launch_count > before[0]
            assert sr_cuda.image_launch_count == before[1]
        cpu = ecc_match_arrays(frames, params, mesh=cpu_mesh)
        c = 8 * params.output_scale
        assert np.abs(gpu[c:-c, c:-c] - cpu[c:-c, c:-c]).max() < 0.02
    kp = make_textured_burst(4, 240, 320, seed=1)[0].numpy()
    d_gpu, k_gpu = keypoint_match_arrays(kp, KeyPointMatchParameters(),
                                         mesh=make_mesh([dev] * 2))
    d_cpu, k_cpu = keypoint_match_arrays(kp, KeyPointMatchParameters(),
                                         mesh=make_mesh(["cpu"] * 2))
    diff = np.abs(k_gpu[16:-16, 16:-16] - k_cpu[16:-16, 16:-16])
    assert d_gpu == d_cpu == 0
    assert np.quantile(diff, 0.99) < 0.02 and diff.mean() < 0.01
    img = torch.from_numpy(smooth(np.random.default_rng(3), (128, 160)))
    m3 = np.array([[1.0, 0.01, 2.5], [-0.01, 1.0, -6.0], [0, 0, 1]],
                  np.float32)
    got = warp_rows_sharded(img.to(dev), m3, make_mesh([dev] * 4, data=1,
                                                         spatial=4), halo=16)
    minv = warp.invert_3x3(torch.from_numpy(m3)).to(dev)
    want = warp_cuda.warp_bilinear(img.to(dev)[None], minv[None])[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _blur_planes(dev, n_, h, w, seed, offset=0):
    """``test_torch_ecc_blur.planes`` on the card; with ``offset`` the
    planes start that many floats into their buffer (still contiguous)."""
    x = torch.from_numpy(blur_design.planes(n_, h, w, seed))
    buf = torch.empty(x.numel() + offset, dtype=torch.float32, device=dev)
    buf[offset:] = x.reshape(-1).to(dev)
    return buf[offset:].view(n_, h, w)


@pytest.mark.parametrize("ksize", [1, 3, 5, 7, 9, 11, 15])
@pytest.mark.parametrize("n_", [1, 7])
@pytest.mark.parametrize("shape", ["aligned", "odd", "least"])
def test_blur_kernel_bitwise(dev, ksize, n_, shape):
    """The Gaussian pre-filter (csrc/ecc_blur.cu) against the plain
    version on the card: W % 4 == 0 across strips and row segments, W % 4
    != 0, and H and W just above 2r."""
    r = ksize // 2
    h, w = {"aligned": (301, 1928), "odd": (75, 1001),
            "least": (2 * r + 1, 2 * r + 2)}[shape]
    x = _blur_planes(dev, n_, h, w, seed=ksize * 10 + n_)
    before = ecc_cuda.blur_launch_count
    got = ecc_cuda.gaussian_prefilter(x, ksize)
    want = filters.gaussian_blur(x, ksize)
    torch.cuda.synchronize()
    assert ecc_cuda.blur_launch_count == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("case", blur_design.CASES)
@pytest.mark.parametrize("offset", [0, 1])
def test_blur_kernel_design_cases(dev, case, offset):
    """``test_torch_ecc_blur.CASES`` (the direct form above ksize 17
    among them) through the wrapper, on planes 16-byte aligned and one
    float past."""
    ksize, n_, h, w = case
    x = _blur_planes(dev, n_, h, w, seed=h * w + ksize, offset=offset)
    got = ecc_cuda.gaussian_prefilter(x, ksize)
    want = filters.gaussian_blur(x, ksize)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("mode,coarse_levels", [
    ("forward", 0), ("forward", 1), ("lazy", 0), ("ic", 0)])
def test_solve_through_the_blur_kernel(dev, monkeypatch, mode,
                                       coarse_levels):
    """A CUDA solve blurs through the kernel, one launch for the templates
    and one for the input image a solved level, and returns bitwise what
    the same solve returns with the plain pre-filter."""
    frames, _ = burst(5, 4, 160, 224, max_shift=3.0, max_angle=0.3)
    grey = torch.from_numpy(frames.astype(np.float32).mean(-1)).to(dev)

    def solve():
        return ecc.find_transform_ecc_batched(
            grey[1:].contiguous(), grey[0], MotionType.Homography,
            num_iters=30, eps=1e-4, gauss_filt_size=5,
            coarse_levels=coarse_levels, mode=mode)

    before = ecc_cuda.blur_launch_count
    got = solve()
    torch.cuda.synchronize()
    assert ecc_cuda.blur_launch_count - before == 2 * (1 + coarse_levels)
    monkeypatch.setattr(ecc_cuda, "gaussian_prefilter",
                        lambda x, k: filters.gaussian_blur(x, k))
    want = solve()
    for name in ("warp_matrix", "rho", "ok", "num_iters"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("seed", refit_design.SEEDS)
def test_ransac_refit_kernels_near_plain(dev, seed):
    """The DLT and polish kernels on the card against their plain
    versions on the CPU, in float64 and in float32, at the bars of
    tests/test_torch_ransac_refit.py; a second launch gives the same
    bits."""
    from libstacker_tpu_torch.ops import ransac, ransac_cuda

    p, wts, start = refit_design.refit_inputs(seed)
    on = [x.to(dev) for x in (p.src_n, p.dst_n, wts, start, p.src, p.dst)]
    src_n, dst_n, w, h0, src, dst = on
    dlt = [ransac_cuda.dlt(src_n, dst_n, w) for _ in range(2)]
    ref = [ransac_cuda.refine(h0, src, dst, w) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(dlt[0], dlt[1]) and torch.equal(ref[0], ref[1])
    got = refit_design.pixels(p, dlt[0].cpu())
    for dtype, bar in ((torch.float64, refit_design.BAR64),
                       (torch.float32, refit_design.BAR32)):
        plain = ransac._dlt_least_squares(p.src_n.to(dtype),
                                          p.dst_n.to(dtype), wts.to(dtype))
        plain = refit_design.pixels(p, plain)
        assert refit_design.corner_gap(got, plain) < bar
        plain = ransac._gauss_newton_refine(start.to(dtype), p.src.to(dtype),
                                            p.dst.to(dtype), wts.to(dtype))
        assert refit_design.corner_gap(ref[0].cpu(), plain) < bar


def test_detect_and_match_wait_only_for_the_loop(dev, monkeypatch):
    """ORB detection and ``_match_and_estimate`` on the card never make
    the host wait for it, but for RANSAC's one read a slab, which runs
    with the check off and is counted."""
    from libstacker_tpu_torch import KeyPointMatchParameters
    from libstacker_tpu_torch.models import keypoint
    from libstacker_tpu_torch.ops import orb, ransac, ransac_cuda
    from libstacker_tpu_torch.utils.synth import make_textured_burst

    frames, _ = make_textured_burst(6, 540, 960, seed=4, device=dev)
    p = KeyPointMatchParameters()
    gen = torch.Generator(device=dev).manual_seed(0)
    grey = color.burst_grey_u8(frames)
    orb.orb_detect_and_compute(grey)  # kernels loaded, constants copied
    keypoint._match_and_estimate(orb.orb_detect_and_compute(grey), gen,
                                 p.method, p.ransac_reproj_threshold,
                                 p.match_keep_ratio, p.match_ratio)
    torch.cuda.synchronize()
    reads = []
    real_read = ransac._still_active

    def allowed(active):
        torch.cuda.set_sync_debug_mode(0)
        try:
            reads.append(real_read(active))
            return reads[-1]
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(ransac, "_still_active", allowed)
    launches = ransac_cuda.dlt_launch_count, ransac_cuda.refine_launch_count
    torch.cuda.set_sync_debug_mode("error")
    try:
        feats = orb.orb_detect_and_compute(grey)
        hs, ok, _, _ = keypoint._match_and_estimate(
            feats, gen, p.method, p.ransac_reproj_threshold,
            p.match_keep_ratio, p.match_ratio)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert reads == [False]  # one slab meets every lane's bound
    assert bool(ok.all())
    assert (ransac_cuda.dlt_launch_count - launches[0],
            ransac_cuda.refine_launch_count - launches[1]) == (1, 1)


@pytest.mark.parametrize("case", sharp_design.CASES)
def test_sharpness_kernel_design_cases(dev, case):
    """``test_torch_sharpness_kernel.CASES`` through the wrapper, the
    frames aligned or one element past their quads' alignment."""
    dtype, k, n_, h, w, offset = case
    x = torch.from_numpy(sharp_design.frames(dtype, n_, h, w,
                                             seed=k * 100 + h + w + offset))
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=dev)
    buf[offset:].copy_(x.reshape(-1))
    xd = buf[offset:].view(n_, h, w)
    before = sharpness_cuda.launch_count
    got_s, got_m = sharpness_cuda.sharpness_sums(xd, k)
    again_s, again_m = sharpness_cuda.sharpness_sums(xd, k)
    torch.cuda.synchronize()
    assert sharpness_cuda.launch_count == before + 4
    assert torch.equal(got_s, again_s) and torch.equal(got_m, again_m)
    want_s, _ = sharpness_cuda.sharpness_sums_reference(x, k)
    sharp_design.assert_sums_match(got_s.cpu().numpy(), want_s.numpy(),
                                   sharp_design.exact(dtype, k))
    fin = sharpness_cuda.metrics_from_sums(got_s.cpu(), h * w)
    assert torch.equal(got_m.cpu().view(torch.int32), fin.view(torch.int32))
