"""Which card a kernel launches on, and which cards a process's mesh
takes, checked on the CPU.

- ``utils/cuda_build.launch`` makes the tensors' card the current device
  around the C call and passes that card's current stream last (the
  kernels launch with ``<<<...>>>`` on the current device, so a shard on
  another card would hand them an invalid stream handle); every kernel
  wrapper launches through it.
- ``make_global_mesh``'s card under NCCL (``LOCAL_RANK``, else the
  current device) and its refusal of a card in two ranks' meshes.
- RANSAC's generators and the stream chunks on a one-shard data axis.
- A global mesh that outlives its process group holds no reference to
  it.
- The launch counters: 8 threads x 10 000 faked launches of one wrapper
  (``launch`` then ``count``, as ``fast_cuda.fast_scores`` does) add up
  exactly under ``cuda_build.count``'s lock, and every counter that
  ``chip_smoke.py`` reads exists and resets to 0.
"""

import contextlib
import pathlib
import re
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import libstacker_tpu_torch as P  # noqa: E402
from libstacker_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from libstacker_tpu_torch.utils import cuda_build  # noqa: E402


@pytest.fixture
def fake_cuda(monkeypatch):
    """``torch.cuda.device`` / ``current_stream`` that track a current
    device (``cuda:0`` to begin with) without a card."""
    state = {"current": "cuda:0", "streams": []}

    @contextlib.contextmanager
    def device(dev):
        prev, state["current"] = state["current"], str(dev)
        try:
            yield
        finally:
            state["current"] = prev

    def current_stream(dev):
        state["streams"].append((str(dev), state["current"]))
        return types.SimpleNamespace(cuda_stream=77)

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    return state


def _lib(state, calls, err=0):
    def kernel(*args):
        calls.append((args, state["current"]))
        return err

    def error_string(code):
        return b"invalid resource handle"

    return types.SimpleNamespace(kernel=kernel, error_string=error_string)


@pytest.mark.parametrize("index", [0, 1, 3])
def test_launch_makes_the_tensors_card_current(fake_cuda, index):
    calls = []
    dev = torch.device("cuda", index)
    cuda_build.launch(_lib(fake_cuda, calls), "kernel", dev, 5, 6)
    assert calls == [((5, 6, 77), f"cuda:{index}")]
    assert fake_cuda["streams"] == [(f"cuda:{index}", f"cuda:{index}")]
    assert fake_cuda["current"] == "cuda:0"  # restored after the call


def test_launch_raises_on_the_error_code(fake_cuda):
    calls = []
    with pytest.raises(RuntimeError, match="kernel: CUDA error 400"):
        cuda_build.launch(_lib(fake_cuda, calls, err=400), "kernel",
                          torch.device("cuda", 1))
    assert fake_cuda["current"] == "cuda:0"


def test_every_kernel_wrapper_launches_through_launch():
    """Only ``cuda_build.launch`` reads a stream handle for a kernel
    (``utils/device.py`` reads streams for its copies, not launches),
    and each wrapper module calls it."""
    pkg = pathlib.Path(P.__file__).parent
    readers = sorted(str(f.relative_to(pkg)) for f in pkg.rglob("*.py")
                     if "current_stream(" in f.read_text())
    assert readers == ["utils/cuda_build.py", "utils/device.py"]
    wrappers = sorted((pkg / "ops").glob("*_cuda.py"))
    assert len(wrappers) == 9
    for f in wrappers:
        src = f.read_text()
        assert "cuda_build.launch(" in src and "cuda_build.check(" not in src


@pytest.mark.parametrize("local_rank, want", [("2", 2), ("7", 1), (None, 1)])
def test_rank_card_follows_local_rank(monkeypatch, local_rank, want):
    """``LOCAL_RANK``'s card where it is visible, else the current
    device (here 1 of 4)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    assert pmesh._rank_card() == torch.device("cuda", want)


@pytest.mark.parametrize("cards, clash", [
    ([["a"], ["b"]], None),
    ([["a", "b"], ["c", "d"]], None),
    ([["a", "a"], []], None),  # one process may shard one card
    ([["a"], ["a"]], "ranks 0 and 1"),
    ([["a", "b"], ["c"], ["b"]], "ranks 0 and 2"),
])
def test_a_card_belongs_to_one_rank(cards, clash):
    if clash is None:
        pmesh._check_cards(cards)
    else:
        with pytest.raises(ValueError, match=clash):
            pmesh._check_cards(cards)


def _seeded(key):
    gen = torch.Generator()
    state = np.random.SeedSequence(key)
    gen.manual_seed(int(state.generate_state(1, np.uint64)[0]
                        >> np.uint64(1)))
    return torch.rand(8, generator=gen)


def test_one_shard_generators_leave_the_shard_out():
    """A data axis of one shard seeds a stream chunk from (seed, chunk),
    as the one-device stream always did; several shards add the global
    shard index."""
    draw = [torch.rand(8, generator=pmesh._shard_generator(*a, "cpu",
                                                            chunk=c))
            for a, c in (((3, None), 5), ((3, 0), 5), ((3, 1), 5))]
    assert torch.equal(draw[0], _seeded([3, 5]))
    assert torch.equal(draw[1], _seeded([3, 5, 0]))
    assert not torch.equal(draw[1], draw[2])


@pytest.mark.parametrize("shards, n, want", [(1, 5, 5), (4, 5, 8),
                                             (4, 8, 8), (3, 1, 3)])
def test_stream_chunks_pad_to_the_data_axis(shards, n, want):
    up = pmesh.ShardUploader(pmesh.make_mesh(["cpu"] * shards))
    frames = np.arange(n * 2 * 2 * 3, dtype=np.uint8).reshape(n, 2, 2, 3)
    got = up.padded(frames)
    assert got.shape[0] == want
    np.testing.assert_array_equal(got[:n], frames)
    assert (got[n:] == frames[-1]).all()
    sf = up.ready(up.put(got))
    assert [s.shape[0] for s in sf.shards] == [want // shards] * shards


def test_global_mesh_does_not_hold_a_destroyed_group(tmp_path):
    """A one-process gloo group: the global mesh reads the default group
    at each use (holding it would keep its threads alive past
    ``destroy_process_group()``, and their teardown at the interpreter's
    exit aborts), and refuses to run once the group is gone."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'st'}",
                            rank=0, world_size=1)
    try:
        mesh = pmesh.make_global_mesh(devices=["cpu"] * 2)
        assert mesh.shape == {"data": 2, "spatial": 1} and mesh.distributed
        assert mesh.group is dist.group.WORLD
        frames = np.arange(96, dtype=np.float32).reshape(2, 4, 4, 3)
        sf = pmesh.shard_frames_global(frames, mesh)
        total = pmesh._psum([s.sum(0) for s in sf.shards], mesh)
        np.testing.assert_array_equal(total.numpy(), frames.sum(0))
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="destroyed"):
        pmesh._psum([s.sum(0) for s in sf.shards], mesh)


def _smoke_counters() -> dict:
    """``chip_smoke.py``'s ``counters()`` map, read from its source (the
    script needs a card to import its phases' modules)."""
    src = (pathlib.Path(P.__file__).parents[1] / "chip_smoke.py").read_text()
    body = src[src.index("def counters():"):src.index("def reset_counts(")]
    return {name: (module, attr) for name, module, attr in
            re.findall(r'"(\w+)": \((\w+), "(\w+)"\)', body)}


def test_launch_counters_count_every_threaded_launch(fake_cuda):
    """C4: the mesh's host threads launch at once; a bare ``+=`` on a
    module global can lose an increment, ``cuda_build.count`` cannot."""
    from libstacker_tpu_torch.ops import fast_cuda

    calls = []
    lib = _lib(fake_cuda, calls)
    start = fast_cuda.launch_count
    go = threading.Barrier(8)

    def shard(index):
        go.wait()
        for _ in range(10_000):
            cuda_build.launch(lib, "kernel", torch.device("cuda", index))
            cuda_build.count(vars(fast_cuda), "launch_count")

    threads = [threading.Thread(target=shard, args=(k % 4,))
               for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 80_000
    assert fast_cuda.launch_count - start == 80_000
    fast_cuda.launch_count = start


def test_smoke_counters_exist_and_reset():
    import importlib

    pairs = _smoke_counters()
    assert len(pairs) == 21
    for name, (module, attr) in pairs.items():
        mod = importlib.import_module(f"libstacker_tpu_torch.ops.{module}")
        before = getattr(mod, attr)
        assert isinstance(before, int), name
        setattr(mod, attr, 0)
        cuda_build.count(vars(mod), attr)
        assert getattr(mod, attr) == 1, name
        setattr(mod, attr, before)
