"""PyTorch port vs libstacker_tpu: ``mesh=`` on the whole-burst entry
points, on a CPU mesh of 4 shards (``make_mesh(["cpu"] * 4)``, the
port's counterpart of the JAX tests' virtual CPU devices).  The keypoint
variants are in ``tests/test_torch_mesh_keypoint.py``.

The bursts and bars are ``tests/test_mesh_public_api.py``'s.  Its mesh
compiles are slow on the CPU, and its own tests already hold its mesh to
its dense path at those bars, so the port's mesh is held to the JAX
package's DENSE entry point at them:

- ECC plain / scaled / masked / u16: atol 2e-4, equal kept count;
  sigma-clip: ``(diff <= 2e-4).mean() > 0.99``, max < 0.05.  The coarse
  variant misses 2e-4 in the port's DENSE path already (two lanes of
  this burst stop one iteration apart from the JAX package's, their
  ``|d rho|`` within 3e-5 of ``eps``: up to 3e-3 on 1.4 % of values), so
  it is held to the slice's dense bar, interior max < 0.02
  (``tests/test_pipeline_ecc.py:73-74``), and to the port's dense path;
- super-resolution (ECC and keypoint): mean < 2e-4 and 0.999 quantile
  < 5e-3 (ECC), mean < 6e-3 and 0.99 quantile < 0.08 (keypoint);
- keypoint plain / scaled / masked: equal drop counts, mean < 5e-3,
  max < 0.06.

The port's mesh is also held to the port's dense path on the same
inputs: within 1e-6 for the ECC and keypoint means and sigma-clip (each
shard runs the dense kernels on its lanes; only the order of the
cross-shard sum differs), and bitwise for ``mesh="auto"`` on the CPU
(a one-shard mesh).
"""

import cv2
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import libstacker_tpu as J  # noqa: E402

import libstacker_tpu_torch as P  # noqa: E402
from libstacker_tpu_torch import errors  # noqa: E402
from libstacker_tpu_torch.ops import sr_cuda, warp  # noqa: E402
from libstacker_tpu_torch.parallel import make_mesh  # noqa: E402

torch.set_num_threads(2)


def _translation_burst(n=6, h=128, w=160, seed=3):
    """``tests/test_mesh_public_api.py``'s ECC burst."""
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(
        rng.random((h * 2, w * 2)).astype(np.float32), (0, 0), 3.0
    ) * 255.0
    frames = []
    shifts = [(0.0, 0.0)] + [
        (float(rng.uniform(-4, 4)), float(rng.uniform(-4, 4)))
        for _ in range(n - 1)
    ]
    for dx, dy in shifts:
        m = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
        cur = cv2.warpAffine(
            base, m, (w * 2, h * 2),
            flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        )[h // 2 : h // 2 + h, w // 2 : w // 2 + w]
        frames.append(np.stack([cur] * 3, -1).astype(np.uint8))
    return np.stack(frames)


def _textured_burst(n=5, h=192, w=256, seed=7):
    """``tests/test_mesh_public_api.py``'s keypoint burst."""
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(
        rng.integers(0, 256, (h * 2, w * 2), np.uint8), (0, 0), 1.2
    )
    frames = []
    shifts = [(0.0, 0.0)] + [
        (float(rng.uniform(-4, 4)), float(rng.uniform(-4, 4)))
        for _ in range(n - 1)
    ]
    for dx, dy in shifts:
        m = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
        cur = cv2.warpAffine(
            base, m, (w * 2, h * 2),
            flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        )[h // 2 : h // 2 + h, w // 2 : w // 2 + w]
        frames.append(np.stack([cur] * 3, -1).astype(np.uint8))
    return np.stack(frames)


@pytest.fixture(scope="module")
def mesh4():
    return make_mesh(["cpu"] * 4, data=4, spatial=1)


@pytest.fixture(scope="module")
def ecc_burst():
    return _translation_burst()


@pytest.fixture(scope="module")
def kp_burst():
    return _textured_burst()


def _ecc_kw(mod):
    return dict(motion_type=mod.MotionType.Translation, max_count=50,
                epsilon=1e-4)


def _ecc_case(variant, frames):
    n, h, w = frames.shape[:3]
    kw, call = {}, dict(on_failure="drop")
    if variant == "scaled":
        call["scale_down_width"] = 100.0
    elif variant == "masked":
        m = np.full((h, w), 255, np.uint8)
        m[: h // 4, : w // 3] = 0
        call["mask"] = m
    elif variant == "u16":
        frames = frames.astype(np.uint16) * 257
    elif variant == "coarse":
        kw["coarse_levels"] = 1
    elif variant == "sigma":
        kw.update(stacking="sigma_clip", sigma_kappa=2.5, sigma_iters=1)
        frames = np.concatenate([frames, frames[:2]], axis=0)
    return frames, kw, call


@pytest.mark.parametrize(
    "variant", ["plain", "scaled", "masked", "u16", "coarse", "sigma"])
def test_ecc_mesh_matches_jax_dense(variant, ecc_burst, mesh4):
    frames, kw, call = _ecc_case(variant, ecc_burst)
    want, jst = J.ecc_match_arrays(
        frames, J.EccMatchParameters(**_ecc_kw(J), **kw), return_stats=True,
        **call)
    got, st = P.ecc_match_arrays(
        frames, P.EccMatchParameters(**_ecc_kw(P), **kw), return_stats=True,
        mesh=mesh4, **call)
    dense, dst = P.ecc_match_arrays(
        frames, P.EccMatchParameters(**_ecc_kw(P), **kw), device="cpu",
        return_stats=True, **call)
    assert got.shape == want.shape
    assert st.frames_kept == jst.frames_kept == frames.shape[0]
    assert len(st.ecc_rho) == frames.shape[0] - 1
    diff = np.abs(got - np.asarray(want))
    if variant == "sigma":
        assert (diff <= 2e-4).mean() > 0.99
        assert diff.max() < 0.05
        assert st.clipped_sample_frac == pytest.approx(
            dst.clipped_sample_frac, abs=1e-6)
    elif variant == "coarse":
        assert diff[8:-8, 8:-8].max() < 0.02
    else:
        np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_allclose(got, dense, atol=1e-6)


def test_ecc_mesh_super_resolution(ecc_burst, mesh4):
    """``output_scale=2``: each shard's deposit (B6's deposit form), the
    accumulators reduced, normalised once; frame 0 deposits through its
    solved lane, as the JAX package's mesh does."""
    want = np.asarray(J.ecc_match_arrays(
        ecc_burst, J.EccMatchParameters(output_scale=2, **_ecc_kw(J)),
        on_failure="drop"))
    got = P.ecc_match_arrays(
        ecc_burst, P.EccMatchParameters(output_scale=2, **_ecc_kw(P)),
        on_failure="drop", mesh=mesh4)
    h, w = ecc_burst.shape[1:3]
    assert got.shape == want.shape == (2 * h, 2 * w, 3)
    diff = np.abs(got - want)
    assert np.mean(diff) < 2e-4, np.mean(diff)
    assert np.quantile(diff, 0.999) < 5e-3, np.quantile(diff, 0.999)


def test_pad_lanes(ecc_burst, kp_burst):
    """N not a multiple of the data axis: the burst pads with copies of
    frame 0 whose lanes are left out (6 ECC frames and 5 keypoint frames
    on 4 shards; 6 on 5 shards)."""
    params = P.EccMatchParameters(**_ecc_kw(P))
    dense, dst = P.ecc_match_arrays(ecc_burst, params, device="cpu",
                                    return_stats=True)
    for k in (4, 5):
        got, st = P.ecc_match_arrays(ecc_burst, params,
                                     mesh=make_mesh(["cpu"] * k),
                                     return_stats=True)
        assert st.frames_total == 6 and st.frames_kept == 6
        assert len(st.ecc_iterations) == 5
        np.testing.assert_allclose(got, dense, atol=1e-6)
    mesh3 = make_mesh(["cpu"] * 3)
    p_drop, pdense = P.keypoint_match_arrays(kp_burst, device="cpu")
    s_drop, got = P.keypoint_match_arrays(kp_burst, mesh=mesh3)
    assert s_drop == p_drop == 0
    np.testing.assert_allclose(got, pdense, atol=1e-6)


def test_mesh_auto(ecc_burst, kp_burst):
    """``mesh="auto"`` with ``device="cpu"`` is a one-shard CPU mesh:
    bitwise the dense path, and the JAX package's auto mesh within its
    bar; with the default device and no card it raises (it never
    becomes a CPU mesh)."""
    params = P.EccMatchParameters(**_ecc_kw(P))
    dense = P.ecc_match_arrays(ecc_burst, params, device="cpu")
    auto = P.ecc_match_arrays(ecc_burst, params, device="cpu", mesh="auto")
    np.testing.assert_array_equal(auto, dense)
    jauto = J.ecc_match_arrays(ecc_burst, J.EccMatchParameters(**_ecc_kw(J)),
                               mesh="auto")
    np.testing.assert_allclose(auto, jauto, atol=2e-4)
    kd = P.keypoint_match_arrays(kp_burst, device="cpu")
    ka = P.keypoint_match_arrays(kp_burst, device="cpu", mesh="auto")
    assert ka[0] == kd[0]
    np.testing.assert_array_equal(ka[1], kd[1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            P.ecc_match_arrays(ecc_burst, params, mesh="auto")


def test_mesh_invalid_values(ecc_burst):
    """The JAX package's refusals, with its messages' keywords."""
    params = P.EccMatchParameters(**_ecc_kw(P))
    with pytest.raises(errors.InvalidParamsError, match="mesh"):
        P.ecc_match_arrays(ecc_burst, params, mesh="bogus", device="cpu")
    with pytest.raises(J.InvalidParamsError, match="mesh"):
        J.ecc_match_arrays(ecc_burst, J.EccMatchParameters(**_ecc_kw(J)),
                           mesh="bogus")

    class NoData:
        axis_names = ("x",)

    with pytest.raises(errors.InvalidParamsError, match="data"):
        P.ecc_match_arrays(ecc_burst, params, mesh=NoData(), device="cpu")
    with pytest.raises(errors.InvalidParamsError, match="mesh"):
        P.keypoint_match_arrays(ecc_burst, mesh="bogus", device="cpu")
    with pytest.raises(errors.InvalidParamsError, match="data"):
        P.ecc_match_stream(["a.png", "b.png"], params, mesh=NoData(),
                           device="cpu")


def test_sr_deposit_then_reduce_equals_image_form(ecc_burst):
    """B6 on one shard: the deposit form summed over two halves of a
    burst and normalised once equals the image form over the whole
    burst (the plain versions; on the card phase 26 holds the kernels)."""
    frames = torch.from_numpy(ecc_burst)
    n, h, w = frames.shape[:3]
    rng = np.random.default_rng(5)
    m = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    m[:, 0, 2] = rng.uniform(-3, 3, n)
    m[:, 1, 2] = rng.uniform(-3, 3, n)
    minv = warp.invert_3x3(torch.from_numpy(m)).contiguous()
    valid = torch.tensor([True, True, False, True, True, True])
    image = sr_cuda.sr_image(frames, minv, valid, 2, 0.3)
    halves = [sr_cuda.sr_deposit(frames[s], minv[s], valid[s], 2, 0.3)
              for s in (slice(0, 3), slice(3, n))]
    reduced = sr_cuda.normalise(tuple(a + b for a, b in zip(*halves)))
    assert image.shape == (2 * h, 2 * w, 3)
    np.testing.assert_allclose(reduced.numpy(), image.numpy(), atol=1e-6)
