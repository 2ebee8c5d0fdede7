"""PyTorch port vs libstacker_tpu: every border mode and INTER_NEAREST
(ops/warp.py), ``warp_frames_batch`` (ops/warp_batch.py) and the plain
versions of kernels B5 and B9 (ops/warp_cuda.py).

Bars:

- ``warp_perspective`` / ``warp_affine`` in each of the six border modes,
  INTER_LINEAR and INTER_NEAREST, on float32 and uint8 grids, and
  BORDER_TRANSPARENT over a destination base: bitwise equal to the JAX
  package's XLA path (the same float32 expressions in the same order);
- ``warp_frames_batch`` against the JAX package's (XLA path): bitwise
  equal (both invert the forward maps in float32; the port's inverse is
  held to the same bins by the test);
- B5's and B9's plain versions against ``warp_bilinear_pallas`` /
  ``warp3_bilinear_pallas`` in interpret mode on [0,1] content, with
  shared sources (``src_index``) and an output grid other than the
  source's: tests/test_warp_pallas.py's bar (under 1e-3 of values off by
  more than 1e-5, max < 0.02): the TPU kernel evaluates its coordinates
  in another order, so a few pixels on exact 1/32 boundaries change bin;
- B9's launch plan (``warp3_plan``): the lanes-fastest grid writes every
  output pixel of every lane once, 16-byte stores only where aligned.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("scipy")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import n, rotation_inverse_map, smooth, t  # noqa: E402
from libstacker_tpu.ops import warp as jwarp  # noqa: E402
from libstacker_tpu.ops import warp_batch as jwarp_batch  # noqa: E402
from libstacker_tpu.ops import warp_pallas as jwarp_pallas  # noqa: E402
from libstacker_tpu_torch import constants  # noqa: E402
from libstacker_tpu_torch.ops import warp, warp_batch, warp_cuda  # noqa: E402

torch.set_num_threads(2)

MODES = [constants.BORDER_CONSTANT, constants.BORDER_REPLICATE,
         constants.BORDER_REFLECT, constants.BORDER_WRAP,
         constants.BORDER_REFLECT_101, constants.BORDER_TRANSPARENT]


def _pallas_bar(got, want):
    d = np.abs(n(got) - np.asarray(want))
    assert (d > 1e-5).mean() <= 1e-3, (d > 1e-5).mean()
    assert d.max() < 0.02, d.max()


@pytest.mark.parametrize("kind", ["perspective", "affine"])
@pytest.mark.parametrize("mode", MODES)
def test_border_modes_match_jax(kind, mode):
    """A large warp (7 degrees, 10 % zoom, shifts past the edge) so every
    mode maps many taps; the output grid differs from the source's."""
    rng = np.random.default_rng(100 + mode)
    h, w = 61, 83
    dsize = (h + 5, w - 7)
    m = rotation_inverse_map(h, w, 7.0, 1.1, 15.3, -9.7,
                             persp=(2e-4, -1e-4) if kind == "perspective"
                             else (0.0, 0.0))
    mm = m if kind == "perspective" else m[:2]
    fp, fj = ((warp.warp_perspective, jwarp.warp_perspective)
              if kind == "perspective" else
              (warp.warp_affine, jwarp.warp_affine))
    f32 = smooth(rng, (h, w, 3))
    u8 = np.clip(np.round(f32), 0, 255).astype(np.uint8)
    bv = [10.0, 20.0, 30.0]
    for img in (f32, u8, f32[..., 0]):
        for interp in (constants.INTER_LINEAR, constants.INTER_NEAREST):
            b = bv if img.ndim == 3 else bv[0]
            got = n(fp(t(img), t(mm), dsize, border_mode=mode,
                       border_value=b, inverse_map=True,
                       interpolation=interp))
            want = np.asarray(fj(jnp.asarray(img), jnp.asarray(mm), dsize,
                                 border_mode=mode,
                                 border_value=jnp.asarray(b),
                                 inverse_map=True, interpolation=interp))
            assert got.dtype == want.dtype, (img.dtype, interp)
            np.testing.assert_array_equal(got, want)


def test_transparent_destination_base_and_guards():
    rng = np.random.default_rng(7)
    h, w = 40, 56
    img = smooth(rng, (h, w, 3))
    base = smooth(rng, (h, w, 3))
    m = rotation_inverse_map(h, w, 3.0, 1.0, 12.5, -6.25)
    for interp in (constants.INTER_LINEAR, constants.INTER_NEAREST):
        got = warp.warp_perspective(
            t(img), t(m), border_mode=constants.BORDER_TRANSPARENT,
            inverse_map=True, interpolation=interp, dst=t(base))
        want = jwarp.warp_perspective(
            jnp.asarray(img), jnp.asarray(m),
            border_mode=constants.BORDER_TRANSPARENT, inverse_map=True,
            interpolation=interp, dst=jnp.asarray(base))
        np.testing.assert_array_equal(n(got), np.asarray(want))
    with pytest.raises(ValueError, match="interpolation"):
        warp.warp_perspective(t(img), t(m), interpolation=constants.INTER_AREA)
    with pytest.raises(ValueError, match="border mode"):
        warp.warp_perspective(t(img), t(m), border_mode=7)


@pytest.mark.parametrize("mode", MODES)
def test_warp_frames_batch_matches_jax(mode):
    rng = np.random.default_rng(200 + mode)
    nf, h, w = 3, 48, 64
    frames = np.stack([smooth(rng, (h, w, 3)) / 255.0 for _ in range(nf)])
    mats = np.stack([rotation_inverse_map(h, w, a, 1.0, dx, dy,
                                          persp=(1e-4 * a, 0.0))
                     for a, dx, dy in ((0.0, 0.0, 0.0), (2.5, 6.5, -3.25),
                                       (-4.0, -9.0, 5.5))])
    bv = [0.25, 0.5, 0.75]
    for persp, f in ((True, frames), (False, frames[..., 1])):
        m = mats if persp else mats[:, :2]
        b = bv if f.ndim == 4 else 0.125
        got = warp_batch.warp_frames_batch(
            t(f), t(m), perspective=persp, border_value=b, border_mode=mode)
        want = jwarp_batch.warp_frames_batch(
            jnp.asarray(f), jnp.asarray(m), perspective=persp,
            border_value=jnp.asarray(b), allow_pallas=False, border_mode=mode)
        assert got.shape == f.shape and got.dtype == torch.float32
        np.testing.assert_array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize("quant_affine", [False, True])
def test_warp_bilinear_matches_pallas_interpret(quant_affine):
    """B5: three slots over two shared sources, per-slot border values,
    on the source grid and on a wider, shorter one."""
    rng = np.random.default_rng(31)
    h, w = 160, 384
    src = np.stack([smooth(rng, (h, w)) / 255.0 for _ in range(2)])
    persp = 0.0 if quant_affine else 1e-5
    m = np.stack([rotation_inverse_map(h, w, a, 1.0, dx, dy,
                                       persp=(persp * a, 0.0))
                  for a, dx, dy in ((0.5, 1.25, -2.5), (-0.8, 3.1, 0.7),
                                    (0.2, -2.2, 1.9))])
    sidx = np.array([0, 1, 0], np.int32)
    bv = np.array([0.3, 0.0, 0.5], np.float32)
    for out_hw in (None, (150, 400)):
        want = jwarp_pallas.warp_bilinear_pallas(
            jnp.asarray(src), jnp.asarray(m), border_value=jnp.asarray(bv),
            src_index=jnp.asarray(sidx), quant_affine=quant_affine,
            interpret=True, out_hw=out_hw)
        got = warp_cuda.warp_bilinear(t(src), t(m), t(bv), t(sidx), out_hw,
                                      quant_affine)
        assert tuple(got.shape) == (3, *(out_hw or (h, w)))
        _pallas_bar(got, want)


def test_warp3_matches_pallas_interpret():
    """B9: three shared planes per lane, one coordinate set."""
    rng = np.random.default_rng(32)
    h, w = 160, 384
    srcs = np.stack([smooth(rng, (h, w)) / 255.0 for _ in range(3)])
    m = np.stack([rotation_inverse_map(h, w, a, 1.0, dx, dy,
                                       persp=(1e-5 * a, 0.0))
                  for a, dx, dy in ((0.5, 1.25, -2.5), (-0.8, 3.1, 0.7))])
    want = jwarp_pallas.warp3_bilinear_pallas(jnp.asarray(srcs),
                                              jnp.asarray(m), interpret=True)
    got = warp_cuda.warp3_bilinear(t(srcs), t(m))
    assert tuple(got.shape) == (2, 3, h, w)
    _pallas_bar(got, want)
    # each plane is B5's warp of that plane
    one = warp_cuda.warp_bilinear(t(srcs), t(m).repeat_interleave(3, 0),
                                  src_index=torch.tensor([0, 1, 2] * 2))
    np.testing.assert_array_equal(n(got).reshape(6, h, w), n(one))


@pytest.mark.parametrize("lanes", [1, 3, 17])
@pytest.mark.parametrize("h,w", [(9, 181), (12, 256), (1, 3)])
def test_warp3_plan_lanes_fastest(lanes, h, w):
    """B9's launch plan with the grid as csrc/warp.cu reads it (block =
    tile * B + lane; 256 threads of 4 pixels of a row a tile): every
    output pixel of every lane is written once, the B lanes of a tile
    are consecutive blocks, and 16-byte stores only where every quad of
    every output plane starts 16-byte aligned."""
    tiles, vector = warp_cuda.warp3_plan(h, w)
    blocks = np.arange(tiles * lanes)
    lane, tile = blocks % lanes, blocks // lanes
    assert (tile[::lanes] == np.arange(tiles)).all()
    assert all((lane[i * lanes:(i + 1) * lanes] == np.arange(lanes)).all()
               for i in range(tiles))
    qpr = -(-w // 4)
    hits = np.zeros((lanes, h, w), np.int64)
    for b, tl in zip(lane, tile):
        q = tl * 256 + np.arange(256)
        q = q[q < h * qpr]
        y = q // qpr
        x0 = (q - y * qpr) * 4
        npx = np.minimum(4, w - x0)
        for j in range(4):
            on = npx > j
            np.add.at(hits[b], (y[on], x0[on] + j), 1)
        if vector:
            assert (npx == 4).all()
            for c in range(3):
                p0 = (b * 3 + c) * h * w + y * w + x0
                assert ((p0 * 4) % 16 == 0).all()
    assert (hits == 1).all()
    assert vector == (w % 4 == 0)
    assert tiles == -(-(h * qpr) // 256)


def test_warp3_plan_at_scale():
    """The plan on 4K planes: 8100 tiles, 16 lanes -> 129600 blocks."""
    assert warp_cuda.warp3_plan(2160, 3840) == (8100, True)
    assert warp_cuda.warp3_plan(2160, 3841) == (-(-(2160 * 961) // 256),
                                                False)


@pytest.mark.parametrize("mode", MODES[1:])
def test_warp_bilinear_reference_modes(mode):
    """The plain version of B5 in each index-mapping mode is the
    ``ops/warp.py`` warp of the slot's source; BORDER_TRANSPARENT is
    CONSTANT 0 there."""
    rng = np.random.default_rng(40 + mode)
    h, w = 30, 44
    src = np.stack([smooth(rng, (h, w)) for _ in range(2)])
    m = np.stack([rotation_inverse_map(h, w, 9.0, 1.2, 8.0, -5.0,
                                       persp=(3e-4, 0.0))] * 2)
    got = warp_cuda.warp_bilinear(t(src), t(m), 4.0, torch.tensor([1, 0]),
                                  (h + 3, w + 2), border_mode=mode)
    for g, s in zip(n(got), (src[1], src[0])):
        bv = 0.0 if mode == constants.BORDER_TRANSPARENT else 4.0
        want = n(warp.warp_perspective(
            t(s), t(m[0]), (h + 3, w + 2),
            border_mode=(constants.BORDER_CONSTANT
                         if mode == constants.BORDER_TRANSPARENT else mode),
            border_value=bv, inverse_map=True))
        np.testing.assert_array_equal(g, want)


def test_wrapper_checks():
    src = torch.zeros((3, 16, 24))
    m = torch.eye(3).repeat(3, 1, 1)
    with pytest.raises(ValueError, match="S,H,W"):
        warp_cuda.warp_bilinear(src[0], m)
    with pytest.raises(ValueError, match="G,3,3"):
        warp_cuda.warp_bilinear(src, m[:, :2])
    with pytest.raises(ValueError, match="src_index"):
        warp_cuda.warp_bilinear(src, m, src_index=torch.tensor([0, 1]))
    with pytest.raises(ValueError, match="need src_index"):
        warp_cuda.warp_bilinear(src[:2], m)
    with pytest.raises(ValueError, match="border_value"):
        warp_cuda.warp_bilinear(src, m, border_value=[1.0, 2.0])
    with pytest.raises(ValueError, match="3,H,W"):
        warp_cuda.warp3_bilinear(src[:2], m)
