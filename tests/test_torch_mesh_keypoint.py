"""PyTorch port vs libstacker_tpu: ``mesh=`` on the keypoint entry point,
on a CPU mesh of 4 shards (``make_mesh(["cpu"] * 4)``); the ECC side and
the shared cases are in ``tests/test_torch_mesh.py``.

The burst and bars are ``tests/test_mesh_public_api.py``'s, held
against the JAX package's DENSE entry point (its mesh's ORB program
compiles for minutes on the CPU; its own tests hold its mesh to its
dense path at these bars): plain / scaled / masked with equal drop
counts, mean < 5e-3, max < 0.06; super-resolution mean < 6e-3 and 0.99
quantile < 0.08.  RANSAC draws per shard under the mesh, so the
agreement with the JAX package is statistical.  The port's mesh is also
held to the port's dense path within 1e-6 (mean, sigma-clip and
BORDER_REPLICATE's B5 accumulate form; this burst's fits do not move
with the draws).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import libstacker_tpu as J  # noqa: E402

import libstacker_tpu_torch as P  # noqa: E402
from libstacker_tpu_torch.parallel import make_mesh  # noqa: E402
from test_torch_mesh import _textured_burst  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def mesh4():
    return make_mesh(["cpu"] * 4, data=4, spatial=1)


@pytest.fixture(scope="module")
def kp_burst():
    return _textured_burst()


def test_keypoint_mesh_super_resolution(kp_burst, mesh4):
    d_drop, want = J.keypoint_match_arrays(
        kp_burst, J.KeyPointMatchParameters(output_scale=2))
    s_drop, got = P.keypoint_match_arrays(
        kp_burst, P.KeyPointMatchParameters(output_scale=2), mesh=mesh4)
    h, w = kp_burst.shape[1:3]
    assert got.shape == np.asarray(want).shape == (2 * h, 2 * w, 3)
    assert s_drop == d_drop
    diff = np.abs(got - np.asarray(want))
    assert np.mean(diff) < 6e-3, np.mean(diff)
    assert np.quantile(diff, 0.99) < 0.08, np.quantile(diff, 0.99)


@pytest.mark.parametrize("variant", ["plain", "scaled", "masked"])
def test_keypoint_mesh_matches_jax_dense(variant, kp_burst, mesh4):
    frames = kp_burst
    h, w = frames.shape[1:3]
    call = {}
    if variant == "scaled":
        call["scale_down_width"] = 96.0
    elif variant == "masked":
        m = np.full((h, w), 255, np.uint8)
        m[:, : w // 4] = 0
        call["mask"] = m
    d_drop, want = J.keypoint_match_arrays(
        frames, J.KeyPointMatchParameters(), **call)
    s_drop, got, st = P.keypoint_match_arrays(
        frames, P.KeyPointMatchParameters(), mesh=mesh4, return_stats=True,
        **call)
    p_drop, dense = P.keypoint_match_arrays(
        frames, P.KeyPointMatchParameters(), device="cpu", **call)
    assert got.shape == np.asarray(want).shape
    assert s_drop == d_drop == p_drop
    assert st.frames_total == 5 and len(st.match_counts) == 4
    np.testing.assert_allclose(got, want, atol=0.06)
    assert np.mean(np.abs(got - np.asarray(want))) < 5e-3
    np.testing.assert_allclose(got, dense, atol=1e-6)


@pytest.mark.parametrize("stacking,border", [
    ("sigma_clip", 0), ("mean", 1),
])
def test_keypoint_mesh_stackers_match_dense(kp_burst, mesh4, stacking,
                                            border):
    """The keypoint mesh's sigma-clip (B4 per shard, moments reduced) and
    index-mapping border (B5's accumulate form per shard) against the
    port's dense path, within 1e-6."""
    params = P.KeyPointMatchParameters(stacking=stacking, border_mode=border)
    d_drop, dense = P.keypoint_match_arrays(kp_burst, params, device="cpu")
    s_drop, got = P.keypoint_match_arrays(kp_burst, params, mesh=mesh4)
    assert s_drop == d_drop == 0
    np.testing.assert_allclose(got, dense, atol=1e-6)
