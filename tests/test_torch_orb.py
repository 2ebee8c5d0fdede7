"""PyTorch port vs libstacker_tpu: ORB (ops/orb.py) and the plain version
of kernel B3 (ops/orb_cuda.py).

Same numpy inputs through both packages on the CPU.  Bars:

- B3's plain version equals the interpret-mode Pallas kernel
  ``extract_patches_batched`` bitwise, clamped edges included (a gather
  and a cast: nothing to round);
- the helpers equal the JAX package's (level quotas, the IC weights),
  or agree within float32 summation order (the patch blur, 1e-4 on the
  0..255 scale); rBRIEF from the same patches and angles sets at least
  99% of the descriptors bit for bit (a steered tap ``round(x cos - y
  sin)`` on a .5 boundary flips with an ulp of ``sin`` / ``cos``);
- ``orb_detect_and_compute`` on the pipeline tests' burst: the pyramid
  levels differ from the JAX package's by 1 LSB on a few pixels
  (tests/test_torch_resize.py), which moves Harris responses and angles
  a little.  Measured on two such bursts of 3 frames: 99.8-100% of the
  JAX keypoints found at the same (x, y, octave), angles within 0.48
  degrees, 93.9-97.7% of the descriptors identical, at most 5 bits
  apart.  The bars: >= 98% overlap, angles within 1 degree, >= 90%
  identical descriptors, at most 8 bits apart, the same validity counts
  within 1%;
- ``_orb_pattern`` is a copy, pinned to the original.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import n, t  # noqa: E402
from libstacker_tpu.ops import _orb_pattern as jpattern  # noqa: E402
from libstacker_tpu.ops import orb as jorb  # noqa: E402
from libstacker_tpu.ops import orb_pallas as jorb_pallas  # noqa: E402
from libstacker_tpu_torch.ops import _orb_pattern, orb, orb_cuda  # noqa: E402

torch.set_num_threads(2)


def _textured_grey(seed, n_frames=3, h=240, w=320):
    """tests/test_pipeline_keypoint.py's block texture, shifted per
    frame (grey, uint8)."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, size=(h // 8, w // 8 + 2), dtype=np.uint8)
    base = cv2.resize(small, (w + 16, h), interpolation=cv2.INTER_NEAREST)
    base = cv2.GaussianBlur(base, (3, 3), 0.8)
    return np.stack([base[:, 3 * i : 3 * i + w] for i in range(n_frames)])


@pytest.fixture(scope="module")
def greys():
    return _textured_grey(12345)


@pytest.fixture(scope="module")
def jax_feats(greys):
    f = jax.jit(jax.vmap(jorb.orb_detect_and_compute))(jnp.asarray(greys))
    return jax.tree.map(np.asarray, f)


def test_orb_pattern_pinned():
    np.testing.assert_array_equal(_orb_pattern.ORB_PATTERN,
                                  jpattern.ORB_PATTERN)
    assert _orb_pattern.ORB_PATTERN.dtype == jpattern.ORB_PATTERN.dtype
    assert (orb_cuda.PATCH_RADIUS, orb_cuda.BLUR_RADIUS) == (
        jorb_pallas.PATCH_RADIUS, jorb_pallas.BLUR_RADIUS)


@pytest.mark.parametrize("radius", [orb_cuda.BLUR_RADIUS,
                                    orb_cuda.PATCH_RADIUS])
def test_extract_patches_match_pallas_interpret(radius):
    """B3's plain version vs the TPU kernel in interpret mode, on u8
    levels (the port's input) and float32, with centres at and beyond
    every clamp edge."""
    rng = np.random.default_rng(31)
    imgs = rng.integers(0, 256, (2, 150, 260)).astype(np.uint8)
    h, w = imgs.shape[1:]
    ys = rng.integers(0, h, (2, 24)).astype(np.int32)
    xs = rng.integers(0, w, (2, 24)).astype(np.int32)
    ys[:, :4] = [0, 5, h - 1, h + 3]
    xs[:, :4] = [w - 1, 0, 3, -2]
    want = np.asarray(jorb_pallas.extract_patches_batched(
        jnp.asarray(imgs.astype(np.float32)), jnp.asarray(ys),
        jnp.asarray(xs), interpret=True, radius=radius))
    for src in (imgs, imgs.astype(np.float32)):
        got = n(orb_cuda.extract_patches(t(src), t(ys), t(xs), radius))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_orb_helpers_match(greys):
    assert orb._features_per_level(500, 8, 1.2) == \
        jorb._features_per_level(500, 8, 1.2)
    for a, b in zip(orb_cuda._ic_angle_weights(), jorb._ic_angle_weights()):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(4)
    ys = rng.integers(40, 200, (1, 30)).astype(np.int32)
    xs = rng.integers(40, 280, (1, 30)).astype(np.int32)
    patches = n(orb_cuda.extract_patches(t(greys[:1]), t(ys), t(xs),
                                         orb_cuda.BLUR_RADIUS))[0]
    br = orb_cuda.BLUR_RADIUS
    ang = n(orb_cuda._ic_angles_from_patches(t(patches), center=br))
    jang = np.asarray(jorb._ic_angles_from_patches(jnp.asarray(patches),
                                                   center=br))
    np.testing.assert_allclose(ang, jang, atol=1e-3)
    blur = n(orb_cuda._blur_patches_valid(t(patches)))
    jblur = np.asarray(jorb._blur_patches_valid(jnp.asarray(patches)))
    np.testing.assert_allclose(blur, jblur, rtol=0, atol=1e-4)
    # rBRIEF from identical patches and angles
    desc = n(orb_cuda._rbrief_from_patches(t(jblur), t(jang)))
    jdesc = np.asarray(jorb._rbrief_from_patches(jnp.asarray(jblur),
                                                 jnp.asarray(jang)))
    ham = np.unpackbits(desc ^ jdesc, axis=-1).sum(-1)
    assert (ham == 0).mean() >= 0.99 and ham.max() <= 2


def test_orb_detect_and_compute_matches_jax(greys, jax_feats):
    pf = orb.orb_detect_and_compute(t(greys))
    pf = orb.OrbFeatures(*(n(x) for x in pf))
    jf = jax_feats
    assert pf.xy.shape == jf.xy.shape and pf.descriptors.shape == \
        jf.descriptors.shape
    np.testing.assert_array_equal(pf.octave, jf.octave)
    np.testing.assert_array_equal(pf.size, jf.size)
    for i in range(len(greys)):
        def table(f):
            return {(float(x), float(y), int(o)): k for k, (x, y, o, v) in
                    enumerate(zip(f.xy[i, :, 0], f.xy[i, :, 1], f.octave[i],
                                  f.valid[i])) if v}
        pk, jk = table(pf), table(jf)
        assert abs(len(pk) - len(jk)) <= 0.01 * len(jk)
        common = sorted(set(pk) & set(jk))
        assert len(common) >= 0.98 * len(jk)
        pi = [pk[c] for c in common]
        ji = [jk[c] for c in common]
        da = np.abs(pf.angle[i, pi] - jf.angle[i, ji])
        assert np.minimum(da, 360.0 - da).max() < 1.0
        ham = np.unpackbits(pf.descriptors[i, pi] ^ jf.descriptors[i, ji],
                            axis=-1).sum(-1)
        assert (ham == 0).mean() >= 0.90 and ham.max() <= 8


def test_orb_small_image_and_guards():
    """Every level too small: an all-invalid fixed-capacity set, as the
    JAX package returns (libstacker_tpu/ops/orb.py:296-313)."""
    tiny = np.full((2, 40, 60), 128, np.uint8)
    f = orb.orb_detect_and_compute(t(tiny))
    jf = jax.vmap(jorb.orb_detect_and_compute)(jnp.asarray(tiny))
    for name in f._fields:
        got, want = n(getattr(f, name)), np.asarray(getattr(jf, name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    with pytest.raises(ValueError, match="mask"):
        orb.orb_detect_and_compute(t(tiny), mask=t(np.ones((40, 59))))
    with pytest.raises(ValueError, match="uint8"):
        orb.orb_detect_and_compute(t(tiny.astype(np.float32)))
