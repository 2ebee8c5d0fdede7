"""The port's spatial axis across processes: gloo worker processes of
one CPU shard each build ``make_global_mesh(data, spatial=2)``, so each
mesh row spans two processes, and run ``warp_rows_sharded``,
``sharpness_teng_spatial`` and ``ecc_stack_step_spatial`` on the same
small inputs (``tests/_torch_dcn.run_spatial``; the workers import torch
and the port only).  Two layouts: 2 processes (data 1 x spatial 2) and
4 (data 2 x spatial 2).

Every rank returns the same results, bitwise equal to the port's
one-process mesh of the same layout (``make_mesh(["cpu"] * k, data=,
spatial=2)`` at the workers' one thread; a band column of at most two
members adds as the one-process pairwise tree does), ``ok`` equal.  They
meet the JAX package's same functions on the same layout at
``tests/test_torch_parallel.py``'s bars: the Tenengrad at rel 1e-5, the
warp at ``(diff > 1e-4).mean() < 1e-3`` (max < 3.0), the ECC step solved
at 48x72 at the interior max 1e-5 (``ok`` equal).  The ECC step is also
solved at 41x61, where a band's INTER_AREA rows read a row of the next
band (sent by point-to-point); there it is held to the port's dense
scaled path at that file's bars (interior max 1e-5, everywhere 1e-6): at
that grid the two packages' dense paths already differ by ~4e-4 at a
pixel (the same small grid, one lane's solve stopping elsewhere), which
no mesh changes.  ``ecc_stack_step`` on the same mesh (each rank of a
row steps its row's frames, the sums reduce over its band column) is
held bitwise to the one-process mesh too.  The layout errors need no
spawn.
"""

import os
import socket
import subprocess
import sys
import textwrap

import cv2
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as PS  # noqa: E402

from libstacker_tpu.params import MotionType as JMotion  # noqa: E402
from libstacker_tpu.parallel import mesh as jmesh  # noqa: E402

import libstacker_tpu_torch as P  # noqa: E402
from libstacker_tpu_torch.ops import resize  # noqa: E402
from libstacker_tpu_torch.parallel import mesh as pmesh  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_dcn as tdcn  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 96

_WORKER = textwrap.dedent(
    """
    import os, sys
    port, pid, world, data, outdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
        sys.argv[5])
    sys.path.insert(0, os.getcwd())
    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist

    from libstacker_tpu_torch.parallel import mesh as pmesh
    import _torch_dcn as tdcn

    pmesh.init_distributed(f"127.0.0.1:{port}", num_processes=world,
                           process_id=pid, backend="gloo")
    mesh = pmesh.make_global_mesh(data=data, spatial=2)
    assert mesh.shape == {"data": data, "spatial": 2}, mesh
    assert mesh.spans and mesh.s0 == pid % 2 and mesh.data0 == pid // 2
    inputs = dict(np.load(os.path.join(outdir, "inputs.npz")))
    got = tdcn.run_spatial(inputs, mesh)
    assert "jax" not in sys.modules and "libstacker_tpu" not in sys.modules
    np.savez(os.path.join(outdir, f"got{pid}.npz"), **got)
    dist.destroy_process_group()
    """
)


@pytest.fixture(scope="module")
def inputs():
    """A smooth RGB frame and a map that moves rows across the band
    edge; 8 greys; a 1+8 frame burst of known shifts (as
    ``tests/test_torch_parallel.py``'s scaled burst) solved at 48x72 and
    at 41x61, where band 0's INTER_AREA rows read one row of band 1 and
    the bands own 21 and 20 of the small grid's rows."""
    rng = np.random.default_rng(11)
    img = cv2.GaussianBlur(
        (rng.random((H, W)) * 255).astype(np.float32), (0, 0), 2.0)
    frame = np.stack([img, img * 0.5, 255.0 - img], -1)
    rot = cv2.getRotationMatrix2D((W / 2.0, H / 2.0), 1.0, 1.002)
    rot[0, 2] += 1.5
    rot[1, 2] -= 3.0
    m3 = np.vstack([rot, [0, 0, 1]]).astype(np.float32)
    greys = np.stack([cv2.GaussianBlur(
        (rng.random((H, W)) * 255).astype(np.float32), (0, 0), s)
        for s in np.linspace(0.8, 3.0, 8)])
    base = cv2.GaussianBlur(
        (rng.random((H * 2, W * 2)) * 255).astype(np.uint8), (0, 0), 1.2)
    burst = []
    for i in range(9):
        dx, dy = (0.0, 0.0) if i == 0 else rng.uniform(-2, 2, 2)
        mm = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
        cur = cv2.warpAffine(
            base, mm, (W * 2, H * 2),
            flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        )[H // 2 : H // 2 + H, W // 2 : W // 2 + W]
        burst.append(np.stack([cur] * 3, -1))
    return dict(frame=frame, m3=m3, greys=greys, burst=np.stack(burst),
                scale_hw=np.array(resize.scale_image_size(H, W, 48.0)),
                scale_hw_cut=np.array(resize.scale_image_size(H, W, 41.0)))


def _spawn(tmp_path, inputs, world: int, data: int) -> list:
    np.savez(tmp_path / "inputs.npz", **inputs)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(port), str(pid), str(world),
             str(data), str(tmp_path)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        for pid in range(world)
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
        raise AssertionError("spatial workers timed out after 120 s")
    if any(p.returncode != 0 for p in procs):
        msg = "\n".join(o[-2000:] for o in outs)
        if ("Gloo" in msg or "gloo" in msg) and (
                "not available" in msg or "unsupported" in msg.lower()):
            pytest.skip(f"gloo cannot start on this host: {msg[-300:]}")
        raise AssertionError(f"spatial workers failed:\n{msg}")
    return [dict(np.load(tmp_path / f"got{p}.npz")) for p in range(world)]


def _jax_results(inputs, data: int) -> dict:
    """The JAX package's three functions on a mesh of the same layout."""
    jm = jmesh.make_mesh(jax.devices()[: data * 2], data=data, spatial=2)

    def put(x, spec):
        return jax.device_put(jnp.asarray(x), NamedSharding(jm, spec))

    burst = inputs["burst"]
    with jm:
        warped = jmesh.warp_rows_sharded(
            put(inputs["frame"], PS("spatial")), jnp.asarray(inputs["m3"]),
            jm, halo=tdcn.SPATIAL_WARP_HALO)
        teng = jmesh.sharpness_teng_spatial(
            put(inputs["greys"], PS("data", "spatial")), jm)
        total, ok = jmesh.ecc_stack_step_spatial(
            put(burst[1:], PS("data", "spatial")),
            put(burst[0], PS("spatial")), jm,
            tuple(int(v) for v in inputs["scale_hw"]),
            motion_type=JMotion.Translation, num_iters=50, eps=1e-5,
            halo=tdcn.SPATIAL_ECC_HALO)
    return dict(warp=np.asarray(warped), teng=np.asarray(teng),
                ecc=np.asarray(total), ok=np.asarray(ok))


@pytest.mark.parametrize("data", [1, 2])
def test_spanning_rows_equal_one_process(tmp_path, inputs, data):
    world = data * 2
    got = _spawn(tmp_path, inputs, world, data)
    for other in got[1:]:
        for k in got[0]:
            np.testing.assert_array_equal(other[k], got[0][k])
    got = got[0]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = tdcn.run_spatial(
            inputs, pmesh.make_mesh(["cpu"] * world, data=data, spatial=2))
    finally:
        torch.set_num_threads(threads)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["ok"].shape == (8,) and got["ok"].all() and got["ok_cut"].all()
    assert got["ok_step"].all()

    jw = _jax_results(inputs, data)
    d = np.abs(got["warp"] - jw["warp"])
    assert (d > 1e-4).mean() < 1e-3 and d.max() < 3.0, d.max()
    np.testing.assert_allclose(got["teng"], jw["teng"], rtol=1e-5)
    np.testing.assert_array_equal(got["ok"], jw["ok"])
    mg = 4
    n = 1 + got["ok"].sum()
    de = np.abs(got["ecc"] - jw["ecc"])[mg:-mg, mg:-mg] / n
    assert de.max() < 1e-5, de.max()
    params = P.EccMatchParameters(P.MotionType.Translation, max_count=50,
                                  epsilon=1e-5, gauss_filt_size=5)
    dense = P.ecc_match_arrays(inputs["burst"], params,
                               scale_down_width=41.0, device="cpu")
    cut = got["ecc_cut"] / (1 + got["ok_cut"].sum())
    assert np.abs(cut - dense)[mg:-mg, mg:-mg].max() < 1e-5
    np.testing.assert_allclose(cut, dense, atol=1e-6)


def test_spanning_layout():
    """Where each process's part of the mesh sits (no process group:
    the layout follows from the rank, the world and ``spatial``)."""
    one = np.empty((1, 1), dtype=object)
    one[0, 0] = torch.device("cpu")
    where = [(m.shape, m.data0, m.s0, m.row_ranks, m.col_ranks, m.spans)
             for m in (pmesh.Mesh(one, rank=r, world=4, spatial=2)
                       for r in range(4))]
    assert where == [
        ({"data": 2, "spatial": 2}, 0, 0, (0, 1), (0, 2), True),
        ({"data": 2, "spatial": 2}, 0, 1, (0, 1), (1, 3), True),
        ({"data": 2, "spatial": 2}, 1, 0, (2, 3), (0, 2), True),
        ({"data": 2, "spatial": 2}, 1, 1, (2, 3), (1, 3), True)]
    two = np.empty((1, 2), dtype=object)
    two[0, :] = [torch.device("cpu")] * 2
    m = pmesh.Mesh(two, rank=3, world=4, spatial=4)
    assert (m.shape, m.data0, m.s0, m.row_ranks, m.col_ranks) == (
        {"data": 2, "spatial": 4}, 1, 2, (2, 3), (1, 3))
    # whole rows in a process: the layout before rows could span
    rows = pmesh.Mesh(np.array([[torch.device("cpu")] * 2] * 3, object),
                      rank=1, world=2)
    assert (rows.shape, rows.data0, rows.s0, rows.row_ranks, rows.col_ranks,
            rows.spans) == ({"data": 6, "spatial": 2}, 3, 0, (1,), (0, 1),
                            False)


def test_layout_errors(tmp_path):
    """A local device count that neither divides nor is divided by
    ``spatial`` raises with both numbers, as do processes that cannot
    fill whole rows and a ``data`` that does not fit (a one-process
    gloo group: no spawn)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'st'}",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match=r"spatial\(2\) and this "
                           r"process's 3 devices"):
            pmesh.make_global_mesh(spatial=2, devices=["cpu"] * 3)
        with pytest.raises(ValueError, match=r"spatial\(3\) and this "
                           r"process's 2 devices"):
            pmesh.make_global_mesh(spatial=3, devices=["cpu"] * 2)
        with pytest.raises(ValueError, match="spans 2 processes of 2 "
                           "devices; 1 processes"):
            pmesh.make_global_mesh(spatial=4, devices=["cpu"] * 2)
        with pytest.raises(ValueError, match=r"data\(3\) \* spatial\(2\)"):
            pmesh.make_global_mesh(data=3, spatial=2, devices=["cpu"] * 4)
        m = pmesh.make_global_mesh(spatial=2, devices=["cpu"] * 4)
        assert m.shape == {"data": 2, "spatial": 2} and not m.spans
    finally:
        dist.destroy_process_group()
