"""PyTorch port vs libstacker_tpu: the building blocks of
``parallel/mesh.py`` called directly, on CPU meshes
(``make_mesh(["cpu"] * k)``) against the JAX package's on its 8 virtual
CPU devices, with ``tests/test_parallel.py``'s inputs and bars:

- ``ecc_stack_step`` on ``tests/_dcn_scenarios.py``'s translation burst
  and ``tests/test_parallel.py``'s burst: against the JAX package's step
  within 1e-4 (``tests/test_distributed.py:126-147``), against the
  port's one-shard mesh within 1e-5 (``tests/test_parallel.py:52-54``);
  ``lane_valid`` drops lanes;
- the sharded sigma-clip: against the one-shard mesh (``(d > 1e-5).mean()
  < 2e-3``, max < 0.06) and the streak suppressed (ghost < 0.25 of the
  mean's), ``tests/test_parallel.py:384-456``;
- ``keypoint_stack_step`` against the one-shard mesh (max < 0.05, mean
  < 1e-4, ``tests/test_parallel.py:262-310``), with ``lane_valid``;
- ``sharpness_teng_spatial`` at rel 1e-5 against both packages'
  ``sharpness_tenengrad``; ``warp_rows_sharded`` against the dense warp
  (``(diff > 1e-4).mean() < 1e-3``, max < 3.0) and against the JAX
  package's; ``ecc_stack_step_spatial`` against the dense scaled
  pipeline (interior max < 1e-5) and the known shifts (p99 < 0.005);
- the halos: zero rows at the global top and bottom, neighbours' rows
  inside.
"""

import os
import sys

import cv2
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from libstacker_tpu import params as jparams  # noqa: E402
from libstacker_tpu.ops import color as jcolor  # noqa: E402
from libstacker_tpu.ops import sharpness as jsharp  # noqa: E402
from libstacker_tpu.parallel import mesh as jmesh  # noqa: E402

import libstacker_tpu_torch as P  # noqa: E402
from libstacker_tpu_torch.ops import color, orb, sharpness, warp  # noqa: E402
from libstacker_tpu_torch.ops import warp_cuda  # noqa: E402
from libstacker_tpu_torch.parallel import mesh as pmesh  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _dcn_scenarios as sc  # noqa: E402

torch.set_num_threads(2)
T = P.MotionType.Translation


def _grey(frame):
    return color.rgb_to_gray_u8(torch.from_numpy(frame)).to(torch.float32)


@pytest.fixture(scope="module")
def burst():
    """``tests/test_parallel.py``'s module burst, from a local rng."""
    rng = np.random.default_rng(12345)
    h, w = 64, 80
    base = cv2.GaussianBlur(
        (rng.random((h * 2, w * 2)) * 255).astype(np.uint8), (0, 0), 3.0)
    frames = []
    for _ in range(8):
        dx, dy = rng.uniform(-2, 2, 2)
        m = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
        cur = cv2.warpAffine(
            base, m, (w * 2, h * 2),
            flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        )[h // 2 : h // 2 + h, w // 2 : w // 2 + w]
        frames.append(np.stack([cur] * 3, -1))
    return np.stack(frames)


def test_make_mesh_errors_and_shapes():
    m = pmesh.make_mesh(["cpu"] * 8, data=4, spatial=2)
    assert m.shape == {"data": 4, "spatial": 2}
    assert m.axis_names == ("data", "spatial") and m.devices.shape == (4, 2)
    assert m.group is None and (m.rank, m.world) == (0, 1)
    assert pmesh.make_mesh(["cpu"] * 6, spatial=2).shape["data"] == 3
    with pytest.raises(ValueError, match=r"data\(3\) \* spatial\(2\)"):
        pmesh.make_mesh(["cpu"] * 8, data=3, spatial=2)
    with pytest.raises(ValueError, match="devices"):
        jmesh.make_mesh(jax.devices(), data=3, spatial=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pmesh.make_mesh()
        with pytest.raises(RuntimeError, match="cuda"):
            pmesh.make_mesh(["cuda:0"])
    sf = pmesh.shard_frames(np.zeros((8, 4, 4, 3), np.uint8), m)
    assert len(sf.shards) == 4 and sf.n_loc == 2 and sf.shape[0] == 8
    with pytest.raises(ValueError, match="must divide the data axis"):
        pmesh.shard_frames(np.zeros((6, 4, 4, 3), np.uint8), m)


@pytest.mark.parametrize("data", [2, 4])
def test_ecc_stack_step_matches_jax(data):
    """The translation scenario of ``tests/_dcn_scenarios.py`` through both
    packages' ``ecc_stack_step`` (every lane, frame 0 included, solved
    against the reference grey)."""
    frames, base = sc.make_burst("translation")
    jm = jmesh.make_mesh(jax.devices()[:data], data=data, spatial=1)
    with jm:
        want, ok_w = jmesh.ecc_stack_step(
            jmesh.shard_frames(jnp.asarray(frames), jm),
            jcolor.rgb_to_gray_u8(jnp.asarray(base)).astype(jnp.float32), jm,
            motion_type=jparams.MotionType.Translation, num_iters=3, eps=1e-3)
    got, ok = pmesh.ecc_stack_step(
        frames, _grey(base), pmesh.make_mesh(["cpu"] * data),
        motion_type=T, num_iters=3, eps=1e-3)
    np.testing.assert_array_equal(ok, np.asarray(ok_w))
    assert ok.all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_ecc_stack_step_sharded_equals_one_shard(burst):
    ref = _grey(burst[0])
    kw = dict(motion_type=T, num_iters=10, eps=1e-4)
    m = pmesh.make_mesh(["cpu"] * 8, data=4, spatial=2)
    stacked, ok, rho, iters = pmesh.ecc_stack_step(
        pmesh.shard_frames(burst, m), ref, m, return_extras=True, **kw)
    assert ok.all() and rho.shape == iters.shape == (8,)
    stacked1, ok1 = pmesh.ecc_stack_step(burst, ref, pmesh.make_mesh(["cpu"]),
                                         **kw)
    np.testing.assert_array_equal(ok, ok1)
    np.testing.assert_allclose(stacked.numpy(), stacked1.numpy(), atol=1e-5)
    # lane_valid: dropped lanes add nothing and report ok=False
    valid = np.ones(8, bool)
    valid[[2, 7]] = False
    part, okv = pmesh.ecc_stack_step(burst, ref, m, lane_valid=valid, **kw)
    np.testing.assert_array_equal(okv, valid)
    lone, _ = pmesh.ecc_stack_step(burst[valid], ref,
                                   pmesh.make_mesh(["cpu"] * 2), **kw)
    np.testing.assert_allclose(part.numpy(), lone.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="stacking"):
        pmesh.ecc_stack_step(burst, ref, m, stacking="median", **kw)
    with pytest.raises(ValueError, match="sigma_clip"):
        pmesh.ecc_stack_step(burst, ref, m, stacking="sigma_clip",
                             output_scale=2, **kw)


def test_threads_per_distinct_device(burst):
    """Shards on distinct devices run on one host thread each
    (``parallel.mesh._run``): four CPU devices named apart
    (``cpu:0``..``cpu:3``), so four threads, with a short switch
    interval, give what one thread gives for the same layout, and every
    shard's call ran on its own device's thread."""
    import threading

    ref = _grey(burst[0])
    kw = dict(motion_type=T, num_iters=10, eps=1e-4)
    one, ok1 = pmesh.ecc_stack_step(burst, ref, pmesh.make_mesh(["cpu"] * 4),
                                    **kw)
    apart = pmesh.make_mesh([f"cpu:{k}" for k in range(4)])
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        # the four calls meet at a barrier: they run at once, each on
        # its own thread
        meet = threading.Barrier(4, timeout=30)
        names = pmesh._run(list(apart.devices[:, 0]),
                           lambda k: (meet.wait(), threading.get_ident()))
        got, ok = pmesh.ecc_stack_step(burst, ref, apart, **kw)
    finally:
        sys.setswitchinterval(switch)
    assert len({t for _, t in names}) == 4
    np.testing.assert_array_equal(ok, ok1)
    assert torch.equal(got, one)


def test_sharded_sigma_clip_stack():
    """``tests/test_parallel.py``'s streak burst (local rng 23): the
    sharded clip against the one-shard mesh, and the streak suppressed
    where the sharded mean ghosts it."""
    lrng = np.random.default_rng(23)
    h, w = 64, 80
    base = cv2.GaussianBlur(
        (lrng.random((h * 2, w * 2)) * 255).astype(np.uint8), (0, 0), 3.0)
    frames = []
    for _ in range(8):
        dx, dy = lrng.uniform(-2, 2, 2)
        mm = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
        cur = cv2.warpAffine(
            base, mm, (w * 2, h * 2),
            flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        )[h // 2 : h // 2 + h, w // 2 : w // 2 + w]
        frames.append(np.stack([cur] * 3, -1))
    clean = np.stack(frames)
    dirty = clean.copy()
    streaked = dirty[5].copy()
    cv2.line(streaked, (8, 10), (70, 50), (255, 255, 255), 2)
    dirty[5] = streaked
    streak = np.zeros(dirty.shape[1:3], np.uint8)
    cv2.line(streak, (8, 10), (70, 50), 1, 2)

    m = pmesh.make_mesh(["cpu"] * 8, data=4, spatial=2)
    ref = _grey(dirty[0])
    kw = dict(motion_type=T, num_iters=10, eps=1e-4)
    sig = dict(stacking="sigma_clip", sigma_kappa=2.5, sigma_iters=2, **kw)
    img, ok = pmesh.ecc_stack_step(dirty, ref, m, **sig)
    assert ok.all()
    img1, _ = pmesh.ecc_stack_step(dirty, ref, pmesh.make_mesh(["cpu"]), **sig)
    d = np.abs(img.numpy() - img1.numpy())
    assert (d > 1e-5).mean() < 2e-3, (d > 1e-5).mean()
    assert d.max() < 0.06, d.max()
    mean_sum, mok = pmesh.ecc_stack_step(dirty, ref, m, **kw)
    clean_sum, cok = pmesh.ecc_stack_step(clean, ref, m, **kw)
    mean_img = mean_sum.numpy() / mok.sum()
    clean_img = clean_sum.numpy() / cok.sum()
    band = cv2.dilate(streak, np.ones((11, 11))).astype(bool)
    band[:6] = band[-6:] = False
    band[:, :6] = band[:, -6:] = False
    ghost_mean = np.abs(mean_img - clean_img)[band].max()
    ghost_sig = np.abs(img.numpy() - clean_img)[band].max()
    assert ghost_mean > 0.04, ghost_mean
    assert ghost_sig < 0.25 * ghost_mean, (ghost_sig, ghost_mean)


def _block_burst(seed=51, n=8):
    """``tests/test_parallel.py``'s keypoint burst (local rng 51)."""
    local = np.random.default_rng(seed)
    h, w, pad = 160, 320, 16
    small = local.integers(
        0, 256, ((h + 2 * pad) // 8, (w + 2 * pad) // 8), np.uint8)
    base = cv2.resize(small, (w + 2 * pad, h + 2 * pad),
                      interpolation=cv2.INTER_NEAREST)
    base = cv2.GaussianBlur(base, (3, 3), 0.8)
    frames = []
    for i in range(n):
        if i == 0:
            cur = base
        else:
            dx, dy = local.uniform(-3, 3, 2)
            m = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
            cur = cv2.warpAffine(
                base, m, (w + 2 * pad, h + 2 * pad),
                flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
        frames.append(np.stack([cur[pad:pad + h, pad:pad + w]] * 3, -1))
    return np.stack(frames)


def test_keypoint_stack_step_sharded_equals_one_shard():
    frames = _block_burst()
    feats0 = orb.orb_detect_and_compute(
        color.burst_grey_u8(torch.from_numpy(frames[:1])))
    ref_feats = orb.OrbFeatures(*(t[0] for t in feats0))  # no leading axis
    m4 = pmesh.make_mesh(["cpu"] * 8, data=4, spatial=2)
    stacked, ok, mc, ic = pmesh.keypoint_stack_step(
        frames, ref_feats, m4, seed=3, return_extras=True)
    assert ok.all() and (mc >= ic).all() and (ic > 0).all()
    stacked1, ok1 = pmesh.keypoint_stack_step(
        frames, ref_feats, pmesh.make_mesh(["cpu"]), seed=3)
    assert ok1.all()
    d = np.abs(stacked.numpy() - stacked1.numpy())
    assert d.max() < 0.05, d.max()
    assert d.mean() < 1e-4, d.mean()
    valid = np.arange(8) != 6
    part, okv = pmesh.keypoint_stack_step(frames, ref_feats, m4, seed=3,
                                          lane_valid=valid)
    np.testing.assert_array_equal(okv, valid)
    assert np.abs(part.numpy() - stacked.numpy()).max() > 0.01
    hs, oks, mcs, ics = pmesh.keypoint_solve_step(frames, feats0, m4, seed=3)
    assert hs.shape == (8, 3, 3) and oks.all()
    np.testing.assert_array_equal(mcs, mc)
    with pytest.raises(ValueError, match="BORDER_CONSTANT"):
        pmesh.keypoint_stack_step(frames, ref_feats, m4,
                                  stacking="sigma_clip", border_mode=1)


def test_shard_generators_follow_the_global_shard():
    """RANSAC's generators are seeded by (seed[, chunk], global shard):
    the same shard draws the same numbers whatever process holds it."""
    a = pmesh._shard_generator(3, 2, "cpu")
    b = pmesh._shard_generator(3, 2, "cpu")
    c = pmesh._shard_generator(3, 1, "cpu")
    d = pmesh._shard_generator(3, 2, "cpu", chunk=0)
    x = [torch.rand(4, generator=g) for g in (a, b, c, d)]
    assert torch.equal(x[0], x[1])
    assert not torch.equal(x[0], x[2]) and not torch.equal(x[0], x[3])


def test_spatial_sharpness_matches_dense(burst):
    greys = color.rgb_to_gray_u8(torch.from_numpy(burst)).to(torch.float32)
    m = pmesh.make_mesh(["cpu"] * 8, data=4, spatial=2)
    got = pmesh.sharpness_teng_spatial(greys, m)
    dense = sharpness.sharpness_tenengrad(greys, 3, device="cpu").numpy()
    np.testing.assert_allclose(got, dense, rtol=1e-5)
    want = np.asarray(jsharp.sharpness_tenengrad(jnp.asarray(greys.numpy()),
                                                 3))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for k in (1, 5):
        m2 = pmesh.make_mesh(["cpu"] * 4, data=2, spatial=2)
        np.testing.assert_allclose(
            pmesh.sharpness_teng_spatial(greys, m2, k),
            sharpness.sharpness_tenengrad(greys, k, device="cpu").numpy(),
            rtol=1e-5)


def test_warp_rows_sharded_matches_dense():
    """``tests/test_parallel.py``'s rotated frame: rows pushed across band
    edges, bands of 64 rows with halo 32."""
    rng = np.random.default_rng(7)
    h, w = 256, 320
    img = cv2.GaussianBlur(
        (rng.random((h, w)) * 255).astype(np.float32), (0, 0), 2.0)
    rot = cv2.getRotationMatrix2D((w / 2.0, h / 2.0), 1.0, 1.002)
    rot[0, 2] += 3.5
    rot[1, 2] -= 12.0
    m3 = np.vstack([rot, [0, 0, 1]]).astype(np.float32)
    dense = warp.warp_perspective(torch.from_numpy(img), torch.from_numpy(m3),
                                  (h, w)).numpy()
    m = pmesh.make_mesh(["cpu"] * 8, data=2, spatial=4)
    got = pmesh.warp_rows_sharded(img, m3, m, halo=32).numpy()
    diff = np.abs(got - dense)
    assert (diff > 1e-4).mean() < 1e-3, (diff > 1e-4).mean()
    assert diff.max() < 3.0
    # the bands warp at their integer row origins: bitwise the dense rows
    np.testing.assert_array_equal(got, dense)
    jm = jmesh.make_mesh(jax.devices(), data=2, spatial=4)
    img_j = jax.device_put(jnp.asarray(img), jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec("spatial")))
    with jm:
        want = np.asarray(jmesh.warp_rows_sharded(img_j, jnp.asarray(m3), jm,
                                                  halo=32))
    d = np.abs(got - want)
    assert (d > 1e-4).mean() < 1e-3 and d.max() < 3.0
    # channels ride as planes of B5 with one map
    rgb = np.stack([img, img * 0.5, 255.0 - img], -1)
    got3 = pmesh.warp_rows_sharded(rgb, m3, m, halo=32).numpy()
    np.testing.assert_array_equal(got3[..., 0], got)
    with pytest.raises(ValueError, match="spatial axis"):
        pmesh.warp_rows_sharded(img[:250], m3, m, halo=32)
    with pytest.raises(ValueError, match="halo"):
        pmesh.warp_rows_sharded(img, m3, m, halo=65)


@pytest.mark.parametrize("quant_affine", [False, True])
def test_row_origins_equal_whole_frame_rows(quant_affine):
    """B5's row origins (plain versions; the kernels on the card in
    tests/test_torch_cuda.py): a strip of source rows warped with the
    global map and its integer origins equals those rows of the whole
    frame's warp bitwise, planar and on interleaved frames summed."""
    from _torch_parity import rotation_inverse_map, smooth

    rng = np.random.default_rng(4)
    h, w = 96, 130
    src = torch.from_numpy(np.stack([smooth(rng, (h, w)) for _ in range(3)]))
    persp = (0.0, 0.0) if quant_affine else (2e-4, -1e-4)
    minv = torch.from_numpy(np.stack([
        rotation_inverse_map(h, w, a, 1.0, 2.0 * a, -1.5, persp=persp)
        for a in (1.5, -0.5, 0.25)]))
    full = warp_cuda.warp_bilinear(src, minv, quant_affine=quant_affine)
    frames = src.permute(1, 2, 0)[None].expand(3, h, w, 3).contiguous()
    valid = torch.tensor([True, False, True])
    acc = warp_cuda.warp_frames(frames, minv, quant_affine=quant_affine,
                                valid=valid)
    lo, hi, halo = 40, 64, 16
    strip = src[:, lo - halo : hi + halo]
    band = warp_cuda.warp_bilinear(strip, minv, out_hw=(hi - lo, w),
                                   quant_affine=quant_affine,
                                   rows=(lo, lo - halo))
    assert torch.equal(band, full[:, lo:hi])
    fstrip = frames[:, lo - halo : hi + halo].contiguous()
    bacc = warp_cuda.warp_frames(fstrip, minv, quant_affine=quant_affine,
                                 valid=valid, rows=(lo - halo, lo - halo))
    assert torch.equal(bacc[halo:-halo], acc[lo:hi])


@pytest.mark.parametrize("src,dst", [(128, 32), (100, 37), (97, 61)])
def test_band_resize_rows_equal_whole_image(src, dst):
    """The spatial step's INTER_AREA: each band's output rows (those
    whose first source row is the band's, from its rows and the next
    band's first few) equal the whole image's row pass bitwise, at
    integer and fractional ratios."""
    from libstacker_tpu_torch import constants
    from libstacker_tpu_torch.ops import resize

    rng = np.random.default_rng(src)
    x = torch.from_numpy(rng.integers(0, 256, (2, src, 40)).astype(np.uint8))
    whole = resize._resize_axis(x.to(torch.float32), -2, dst,
                                constants.INTER_AREA)
    nsp = 4
    h_loc = -(-src // nsp)
    first = np.argmax(resize._area_weights(src, dst) != 0, axis=1)
    owned = np.searchsorted(first, np.arange(nsp + 1) * h_loc)
    parts = []
    for j in range(nsp):
        a0, a1 = int(owned[j]), int(owned[j + 1])
        if a0 == a1:
            continue
        lo, hi = resize.row_span(src, dst, a0, a1)
        assert lo >= j * h_loc
        parts.append(resize.resize_rows(x[:, j * h_loc : hi], src, dst, a0,
                                        a1, j * h_loc))
    assert torch.equal(torch.cat(parts, dim=1), whole)


def test_halo_edges():
    """A band's strip holds its neighbours' rows inside the frame and zero
    rows at the global top and bottom; the Sobel's edge rows reflect."""
    x = torch.arange(12 * 3, dtype=torch.float32).reshape(12, 3) + 1.0
    bands = list(x.split(4))
    ext = pmesh._halo_ext(bands, 2, 0)
    assert torch.equal(ext[0][:2], torch.zeros(2, 3))
    assert torch.equal(ext[0][2:], x[:6])
    assert torch.equal(ext[1], x[2:10])
    assert torch.equal(ext[2][:6], x[6:])
    assert torch.equal(ext[2][6:], torch.zeros(2, 3))
    refl = pmesh._halo_ext([b[None] for b in bands], 1, 1,
                           lambda b, top: (b[:, 1:2] if top else b[:, -2:-1]))
    assert torch.equal(refl[0][0, 0], x[1]) and torch.equal(refl[2][0, -1],
                                                            x[10])
    # a warp that reaches above the frame reads zeros, as the dense one
    img = np.ones((16, 8), np.float32)
    m3 = np.array([[1, 0, 0], [0, 1, 3], [0, 0, 1]], np.float32)
    m = pmesh.make_mesh(["cpu"] * 4, data=1, spatial=4)
    got = pmesh.warp_rows_sharded(img, m3, m, halo=4).numpy()
    dense = warp_cuda.warp_bilinear(
        torch.from_numpy(img)[None], warp.invert_3x3(
            torch.from_numpy(m3))[None]).numpy()[0]
    np.testing.assert_array_equal(got, dense)
    assert (got[:3] == 0).all() and (got[3:] == 1).all()


def test_spatial_end_to_end_matches_dense():
    """``tests/test_parallel.py``'s scaled burst (local rng 48): rows split
    for the whole step against the dense scaled pipeline and the known
    shifts."""
    rng = np.random.default_rng(48)
    h, w = 128, 96
    base = cv2.GaussianBlur(
        (rng.random((h * 2, w * 2)) * 255).astype(np.uint8), (0, 0), 1.2)
    frames, shifts = [], []
    for i in range(5):
        if i == 0:
            cur = base[h // 2 : h // 2 + h, w // 2 : w // 2 + w]
            shifts.append((0.0, 0.0))
        else:
            dx, dy = rng.uniform(-2, 2, 2)
            shifts.append((dx, dy))
            mm = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
            cur = cv2.warpAffine(
                base, mm, (w * 2, h * 2),
                flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
            )[h // 2 : h // 2 + h, w // 2 : w // 2 + w]
        frames.append(np.stack([cur] * 3, -1))
    frames = np.stack(frames)
    acc = frames[0].astype(np.float32) / 255.0
    for i in range(1, 5):
        mm = np.array([[1, 0, shifts[i][0]], [0, 1, shifts[i][1]]],
                      np.float32)
        acc += cv2.warpAffine(frames[i].astype(np.float32) / 255.0, mm,
                              (w, h))
    truth = acc / 5.0
    params = P.EccMatchParameters(T, max_count=50, epsilon=1e-5,
                                  gauss_filt_size=5)
    scale_w = 64.0
    dense = P.ecc_match_arrays(frames, params, scale_down_width=scale_w,
                               device="cpu")
    from libstacker_tpu_torch.ops import resize

    scale_hw = resize.scale_image_size(h, w, scale_w)
    m = pmesh.make_mesh(["cpu"] * 8, data=4, spatial=2)
    stacked, ok = pmesh.ecc_stack_step_spatial(
        frames[1:], frames[0], m, scale_hw, motion_type=T, num_iters=50,
        eps=1e-5, gauss_filt_size=5, halo=32)
    assert ok.all()
    got = stacked.numpy() / (1 + ok.sum())
    mgn = 4
    d = np.abs(got - dense)[mgn:-mgn, mgn:-mgn]
    assert d.max() < 1e-5, d.max()
    # and everywhere: the small grid, the solve and the band warps are
    # the dense path's
    np.testing.assert_allclose(got, dense, atol=1e-6)
    dt = np.abs(got - truth)[mgn:-mgn, mgn:-mgn]
    assert np.quantile(dt, 0.99) < 0.005, np.quantile(dt, 0.99)
    # a lane whose vertical motion leaves the halo is dropped
    tall = frames.copy()
    tall[3] = np.roll(frames[0], 40, axis=0)
    _, ok2 = pmesh.ecc_stack_step_spatial(
        tall[1:], tall[0], m, scale_hw, motion_type=T, num_iters=50,
        eps=1e-5, halo=32)
    assert not ok2[2]
