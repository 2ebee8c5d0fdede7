"""The port's multi-process mesh: two worker processes join one gloo
group (``parallel.init_distributed``), build a global mesh of 2 CPU
shards each (``make_global_mesh``), place their own frames
(``shard_frames_global``) and run the sharded step of each scenario of
``tests/_dcn_scenarios.py``: translation ECC + mean, homography ECC +
the distributed sigma-clip (its moments all-reduced across the
processes), and the keypoint path with frame 2 dropped.  The workers
import torch and the port only (``tests/_torch_dcn.py``), never JAX.

Each result is held against the port's one-process mesh of 4 shards
(``ok`` equal, frame 2 and only it dropped on the keypoint path, the
image within 1e-5; one burst draws the same RANSAC hypotheses whatever
the process layout), and against the JAX package:

- the two ECC scenarios against the JAX package's one-process mesh
  (``tests/_dcn_scenarios.run_step`` on 4 virtual devices, the reference
  of ``tests/test_distributed.py``): ``ok`` equal; translation at that
  file's bar (:126-147), atol 1e-4.  Its sigma-clip bar is one
  implementation against itself; across the two packages the solved
  homographies differ by float32 ulps (held below: within 1e-3, equal
  iteration counts), and on this burst's uncorrelated noise a 1/32-px
  bin that flips moves a pixel by up to ~0.06 and can flip a kappa
  decision at kappa 1.5 over 8 samples (up to ~0.7 at a pixel), so the
  image is held at ``(diff <= 1e-4).mean() > 0.95`` with no max;
- the keypoint scenario against the JAX package's dense path with the
  step's matching parameters (ratio 0.9, keep 0.8, seed 1): the JAX
  mesh's ORB program compiles for minutes on the CPU
  (``tests/test_distributed.py:827-829``), and the two packages' RANSAC
  draws differ, so at ``tests/test_mesh_public_api.py``'s keypoint bars:
  equal drops, max < 0.06, mean < 5e-3.

Skips only when gloo cannot start on this host, as
``tests/test_distributed.py:93-103`` does; a worker that fails otherwise
fails the test.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import libstacker_tpu as J  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _dcn_scenarios as sc  # noqa: E402
import _torch_dcn as tdcn  # noqa: E402

from libstacker_tpu_torch.parallel import make_mesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent(
    """
    import os, sys
    port, pid, outdir, scenario = (
        sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    )
    sys.path.insert(0, os.getcwd())
    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist

    from libstacker_tpu_torch.parallel import mesh as pmesh
    import _dcn_scenarios as sc
    import _torch_dcn as tdcn

    pmesh.init_distributed(f"127.0.0.1:{port}", num_processes=2,
                           process_id=pid, backend="gloo")
    frames_all, base = sc.make_burst(scenario)
    n = frames_all.shape[0]
    local = frames_all[pid * n // 2 : (pid + 1) * n // 2]
    mesh = pmesh.make_global_mesh(data=4, devices=["cpu"] * 2)
    assert mesh.shape == {"data": 4, "spatial": 1}, mesh
    frames = pmesh.shard_frames_global(local, mesh)
    stacked, ok = tdcn.run_step(scenario, frames, base, mesh)
    assert "jax" not in sys.modules and "libstacker_tpu" not in sys.modules
    np.save(os.path.join(outdir, f"stacked{pid}.npy"), stacked)
    np.save(os.path.join(outdir, f"ok{pid}.npy"), ok)
    dist.destroy_process_group()
    """
)


def _run_two_process(tmp_path, scenario: str):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(port), str(pid),
             str(tmp_path), scenario],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError("distributed workers timed out after 120 s")
    if any(p.returncode != 0 for p in procs):
        msg = "\n".join(o[-2000:] for o in outs)
        if ("Gloo" in msg or "gloo" in msg) and (
                "not available" in msg or "unsupported" in msg.lower()):
            pytest.skip(f"gloo cannot start on this host: {msg[-300:]}")
        raise AssertionError(f"distributed workers failed:\n{msg}")
    got = [(np.load(tmp_path / f"stacked{p}.npy"),
            np.load(tmp_path / f"ok{p}.npy")) for p in (0, 1)]
    # every process holds the reduced image and the gathered flags
    np.testing.assert_array_equal(got[0][0], got[1][0])
    np.testing.assert_array_equal(got[0][1], got[1][1])
    return got[0]


def _jax_reference(scenario, frames, base):
    """-> (image, ok) of the JAX package: its one-process mesh for the ECC
    scenarios, its dense path (mean image) for the keypoint one."""
    if scenario == "keypoint_drop":
        params = J.KeyPointMatchParameters(match_ratio=0.9,
                                           match_keep_ratio=0.8)
        _, img, st = J.keypoint_match_arrays(frames, params, seed=1,
                                             return_stats=True)
        ok = np.concatenate([[True], np.asarray(st.match_counts) >= 5])
        return np.asarray(img), ok
    import jax
    import jax.numpy as jnp
    from libstacker_tpu.parallel import mesh as jmesh

    mesh = jmesh.make_mesh(jax.devices()[:4], data=4, spatial=1)
    return sc.run_step(scenario, jmesh.shard_frames(jnp.asarray(frames),
                                                    mesh), base, mesh)


def _solves_agree(frames, base):
    """The homography scenario's solve: the port's warps within 1e-3 of
    the JAX package's, the same iteration counts."""
    import jax
    import jax.numpy as jnp
    from libstacker_tpu.ops import color as jcolor
    from libstacker_tpu.parallel import mesh as jmesh

    from libstacker_tpu_torch.ops import color
    from libstacker_tpu_torch.params import MotionType
    from libstacker_tpu_torch.parallel import mesh as pmesh

    jm = jmesh.make_mesh(jax.devices()[:4], data=4, spatial=1)
    jw, _, jit, _ = jmesh._ecc_solve_sharded(
        jmesh.shard_frames(jnp.asarray(frames), jm),
        jcolor.rgb_to_gray_u8(jnp.asarray(base)).astype(jnp.float32), jm,
        J.MotionType.Homography, 3, 1e-3, 5, True, None, 0, None)
    pm = make_mesh(["cpu"] * 4)
    grey = color.rgb_to_gray_u8(torch.from_numpy(base)).to(torch.float32)
    pw, _, pit, _ = pmesh._ecc_solve_gathered(
        pmesh.shard_frames(frames, pm), grey, pm,
        motion_type=MotionType.Homography, num_iters=3, eps=1e-3,
        gauss_filt_size=5, phase_init=True, phase_init_rotation=False,
        scale_hw=None, coarse_levels=0, input_mask=None, mode=None)
    np.testing.assert_allclose(pw, jw, atol=1e-3)
    np.testing.assert_array_equal(pit, jit)


@pytest.mark.parametrize(
    "scenario", ["translation", "homography_sigma", "keypoint_drop"])
def test_two_process_gloo_parity(tmp_path, scenario):
    stacked, ok = _run_two_process(tmp_path, scenario)
    frames_all, base = sc.make_burst(scenario)
    # the workers run one thread each; the CPU plain versions' sums (and
    # so this burst's degenerate keypoint fit) follow the thread count
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want, ok_want = tdcn.run_step(scenario, frames_all, base,
                                      make_mesh(["cpu"] * 4))
    finally:
        torch.set_num_threads(threads)
    n = frames_all.shape[0]
    assert ok.shape == (n,)
    np.testing.assert_array_equal(ok, ok_want)
    if scenario == "keypoint_drop":
        assert not ok[2] and ok[[0, 1, 3]].all()
    else:
        assert ok.all()
    np.testing.assert_allclose(stacked, want, atol=1e-5)

    jwant, jok = _jax_reference(scenario, frames_all, base)
    np.testing.assert_array_equal(ok, jok)
    diff = np.abs((stacked / ok.sum() if scenario == "keypoint_drop"
                   else stacked) - jwant)
    if scenario == "homography_sigma":
        assert (diff <= 1e-4).mean() > 0.95, (diff <= 1e-4).mean()
        _solves_agree(frames_all, base)
    elif scenario == "keypoint_drop":
        assert diff.max() < 0.06 and diff.mean() < 5e-3, diff.max()
    else:
        np.testing.assert_allclose(stacked, jwant, atol=1e-4)
