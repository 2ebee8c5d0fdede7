"""PyTorch port vs libstacker_tpu: the keypoint path's variants — the
detection mask and the index-mapping border modes of the stack.

Bars:

- ``orb_detect_and_compute(mask=)``: tests/test_torch_orb.py's overlap
  bars (>= 98% of the JAX keypoints at the same (x, y, octave), angles
  within 1 degree, >= 90% identical descriptors, validity counts within
  1%): the mask pyramid goes through the same INTER_LINEAR resize as
  the image, whose u8 residual (ROADMAP.md Queue C) can move a corner
  at a mask edge; and no keypoint inside the masked block;
- the stack stage with fixed homographies in every border mode: ROADMAP
  B5's bar (at most 1e-3 of values off by more than 1e-5, max < 0.05).
  The warps equal the JAX package's bitwise for one inverse map
  (tests/test_torch_warp.py), but the stage inverts the forward maps,
  and ``torch.linalg.inv`` and ``jnp.linalg.inv`` may differ by an ulp,
  which moves a coordinate on a 1/32-px boundary into the next bin
  (measured: 5.7e-4 of values, max 0.011);
- ``keypoint_match_arrays`` with BORDER_REPLICATE / REFLECT_101 / WRAP
  and with ``mask=`` (full and scaled): tests/test_torch_pipeline_keypoint.py's
  bars (equal ``dropped``, both stacks within p99 0.04 of the
  ground-truth-warp stack on the full path, the two stacks within 0.02
  of each other at the 99th percentile; RANSAC's draws differ).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import libstacker_tpu as J  # noqa: E402
import libstacker_tpu_torch as P  # noqa: E402
from _torch_parity import n, t  # noqa: E402
from libstacker_tpu.models import keypoint as jkp  # noqa: E402
from libstacker_tpu.ops import orb as jorb  # noqa: E402
from libstacker_tpu_torch import constants  # noqa: E402
from libstacker_tpu_torch.ops import orb, warp_batch  # noqa: E402
from test_pipeline_keypoint import _textured_burst, _truth_stack  # noqa: E402
from test_torch_orb import _textured_grey  # noqa: E402

torch.set_num_threads(2)

M = 16  # interior margin of the stack comparisons
MODES = [constants.BORDER_CONSTANT, constants.BORDER_REPLICATE,
         constants.BORDER_REFLECT, constants.BORDER_WRAP,
         constants.BORDER_REFLECT_101, constants.BORDER_TRANSPARENT]


def _det_mask(h, w):
    """Valid everywhere but a block at the top left and a thin bar."""
    m = np.ones((h, w), np.uint8)
    m[20 : h // 2, 30 : w // 3] = 0
    m[h - 70 : h - 60, w // 2 :] = 0
    return m


def _p99(a, b):
    return float(np.quantile(np.abs(a[M:-M, M:-M] - b[M:-M, M:-M]), 0.99))


def test_detection_mask_matches_jax():
    greys = _textured_grey(12345)  # test_torch_orb.py's burst
    h, w = greys.shape[1:]
    mask = _det_mask(h, w) * 3  # any nonzero value is valid
    pf = orb.orb_detect_and_compute(t(greys), mask=t(mask))
    pf = orb.OrbFeatures(*(n(x) for x in pf))
    jf = jax.jit(jax.vmap(lambda g: jorb.orb_detect_and_compute(
        g, mask=jnp.asarray(mask))))(jnp.asarray(greys))
    jf = jax.tree.map(np.asarray, jf)
    unmasked = orb.orb_detect_and_compute(t(greys))
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
        # nothing detected inside the masked block (level-0 coordinates)
        xy = pf.xy[i][pf.valid[i]]
        inside = ((xy[:, 1] >= 20) & (xy[:, 1] < h // 2 - 1)
                  & (xy[:, 0] >= 30) & (xy[:, 0] < w // 3 - 1))
        assert not inside.any()
        uxy = n(unmasked.xy[i])[n(unmasked.valid[i])]
        assert ((uxy[:, 1] >= 20) & (uxy[:, 1] < h // 2 - 1)
                & (uxy[:, 0] >= 30) & (uxy[:, 0] < w // 3 - 1)).any()


@pytest.fixture(scope="module")
def burst():
    return _textured_burst(np.random.default_rng(2026))


@pytest.fixture(scope="module")
def truth(burst):
    frames, true_h = burst
    return _truth_stack(frames, true_h, *frames.shape[1:3])


def _params(mod, **kw):
    base = dict(ransac_reproj_threshold=5.0, match_ratio=0.9,
                match_keep_ratio=0.8)
    base.update(kw)
    return mod.KeyPointMatchParameters(**base)


@pytest.mark.parametrize("mode", MODES)
def test_stack_stage_border_modes_match_jax(burst, mode):
    """Stage 3 from the same homographies (a 7-degree rotation and wide
    shifts so every mode fills a large border; one lane dropped)."""
    frames = burst[0]
    h, w = frames.shape[1:3]
    hs = []
    for ang, dx, dy in ((7.0, 14.5, -9.25), (-5.0, -20.0, 6.5), (2.0, 3.0, 30.0)):
        a = np.radians(ang)
        c, s = np.cos(a), np.sin(a)
        hs.append([[c, -s, dx + (1 - c) * w / 2 + s * h / 2],
                   [s, c, dy - s * w / 2 + (1 - c) * h / 2],
                   [1e-5, -2e-5, 1.0]])
    hs = np.asarray(hs, np.float32)
    oks = np.array([True, False, True])
    bv = (0.25, 0.5, 0.75, 0.0)
    got = warp_batch.warp_sum_burst(t(frames), t(hs), t(oks),
                                    border_value=list(bv[:3]),
                                    border_mode=mode)
    want = jkp._warp_and_accumulate(
        jnp.asarray(frames), jnp.asarray(hs), jnp.asarray(oks),
        border_mode=mode, border_value=bv, allow_pallas=False)
    d = np.abs(n(got) - np.asarray(want))
    assert (d > 1e-5).mean() <= 1e-3 and d.max() < 0.05, (
        (d > 1e-5).mean(), d.max())


@pytest.mark.parametrize("mode", [constants.BORDER_REPLICATE,
                                  constants.BORDER_REFLECT_101,
                                  constants.BORDER_WRAP])
def test_border_modes_match_jax(burst, truth, mode):
    frames = burst[0]
    d_got, got = P.keypoint_match_arrays(frames, _params(P, border_mode=mode),
                                         device="cpu")
    d_want, want = J.keypoint_match_arrays(frames,
                                           _params(J, border_mode=mode))
    assert d_got == d_want == 0
    assert got.shape == frames.shape[1:] and got.dtype == np.float32
    assert _p99(got, truth) < 0.04 and _p99(want, truth) < 0.04
    assert _p99(got, want) < 0.02
    # the border is filled from the image, not with the constant 0: the
    # outermost columns stay as bright as frame 0's
    _, const = P.keypoint_match_arrays(frames, _params(P), device="cpu")
    edge = np.abs(got[:, :2] - frames[0][:, :2] / 255.0).mean()
    edge_const = np.abs(const[:, :2] - frames[0][:, :2] / 255.0).mean()
    assert edge < edge_const


@pytest.mark.parametrize("scaled", [False, True])
def test_mask_matches_jax(burst, truth, scaled):
    frames = burst[0]
    h, w = frames.shape[1:3]
    mask = _det_mask(h, w)
    kw = dict(scale_down_width=200.0) if scaled else {}
    d_got, got, st = P.keypoint_match_arrays(
        frames, _params(P), mask=mask, return_stats=True, device="cpu", **kw)
    d_want, want, jst = J.keypoint_match_arrays(
        frames, _params(J), mask=mask, return_stats=True, **kw)
    assert d_got == d_want == 0
    assert _p99(got, want) < 0.02
    if not scaled:
        assert _p99(got, truth) < 0.04
    np.testing.assert_allclose(st.match_counts, jst.match_counts, rtol=0.1)
    # the mask removes candidates: fewer matches than without it
    _, _, st_all = P.keypoint_match_arrays(frames, _params(P),
                                           return_stats=True, device="cpu",
                                           **kw)
    assert sum(st.match_counts) < sum(st_all.match_counts)
    with pytest.raises(P.errors.InvalidParamsError, match="mask must be"):
        P.keypoint_match_arrays(frames, mask=mask[:, :10], device="cpu")
