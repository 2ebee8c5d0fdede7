"""Device-mesh scale-out for burst stacking.

Counterpart of ``libstacker_tpu/parallel/mesh.py`` (``make_mesh`` :43,
``shard_frames`` :60, ``init_distributed`` :74, ``make_global_mesh`` :92,
``shard_frames_global`` :101, ``ecc_stack_step`` :111,
``keypoint_stack_step`` :896, ``keypoint_solve_step`` :1091,
``ecc_stack_step_spatial`` :1379, ``warp_rows_sharded`` :1595,
``sharpness_teng_spatial`` :1684), built from PyTorch's own parts:

- **the mesh**: a :class:`Mesh` names this process's devices as a
  ``[data_local, spatial_local]`` array of the global ``[data, spatial]``
  mesh; several processes join one ``torch.distributed`` group and lay
  their devices out rank-major, as the JAX package reshapes
  ``jax.devices()``.  A process holds whole mesh rows, or, where its
  devices are fewer than ``spatial``, a run of bands of one row that
  spans ``spatial / spatial_local`` ranks (``make_global_mesh``; one
  process group per mesh row and per band column).  A device may appear
  more than once (``make_mesh(["cpu"] * 4)`` is four shards on the CPU,
  ``make_mesh(["cuda:0"] * 4)`` four shards of one card); it adds no
  behaviour the JAX package lacks, whose tests run on 8 virtual CPU
  devices.
- **the shards**: :func:`shard_frames` gives data shard ``i`` the frames
  ``[i*n_loc, (i+1)*n_loc)`` on its own device (a :class:`ShardedFrames`).
  One host thread per distinct device runs that device's shards (solve,
  stack) under ``torch.cuda.device(dev)``, in shard order.  The kernels
  launch on the CUDA runtime's current device, and every wrapper makes
  its tensors' card current for the launch (``utils/cuda_build.launch``),
  so no kernel runs with another card current, from a shard's thread or
  from the entry point's own (frame 0's grey and ORB).  Collectives and
  point-to-point transfers are issued from the calling thread only, in
  one order on every rank.
- **the psum**: the partials of one process add as a pairwise tree in
  shard order on ``devices[0, 0]``, then ``dist.all_reduce(SUM)`` over
  the band column's group of a global mesh.  That equals the
  one-process mesh's tree bitwise while the group has at most two
  members (one process of four shards and two processes of two add in
  the same order; a larger group adds in the backend's order).  ``ok``,
  ``rho`` and ``iters`` are gathered in lane order (``dist.all_gather``).
  A CUDA mesh uses NCCL, a CPU mesh gloo; under gloo a card's tensors
  travel as CPU copies, so two processes may share a card.
- **the spatial axis**: row bands of one data shard live on the devices
  of its mesh row; halos are rows copied from the neighbouring band's
  device, or, where the neighbour is in another rank of the row, sent by
  point-to-point (``dist.batch_isend_irecv``, up then down); zero (or,
  for the Sobel, reflect-101) at the global top and bottom.  A band
  warps with the global inverse map and its integer row origins
  (``csrc/warp.cu``), where the JAX package shifts the map in float32
  (``shift_src @ minv @ shift_out``, ``mesh.py:1656-1665``), which moves
  1/32-px bins at large row offsets; a band equals the rows of the whole
  frame's warp bitwise.  Where a row spans processes the Tenengrad's
  per-band sums are gathered over the row group and added in band order
  (bitwise the one-process sum in any layout), the ECC step's small grid
  is gathered over the row group and solved by every rank of the row,
  and every function returns the whole row on ``devices[0, 0]`` of every
  rank.

Every shard runs the dense path's stages, the same functions of
``ops/``: the burst grey (``color.burst_grey_f32`` / ``burst_grey_u8``),
the align stage (``ecc.align_lanes``: the phase start and the batched ECC
solver, B1, its masked and Gram-less forms, B7 for ``mode="ic"``;
``ransac.match_and_estimate`` after ORB's B8 / B3h / B3d on the keypoint
path), the warp rescale (``warp.rescale_maps``), the mean stack
(``warp_batch.warp_sum_lanes``: B2, or B5's accumulate form for the
index-mapping borders), and the sweeps of the re-warping stackers
(``stack.moments_sweep`` with B4, ``stack.deposit_sum`` with B6's
deposit form; a shard cannot normalise before the reduction, so
``sr_cuda.normalise`` runs once on the reduced sums).  B5's planar form
warps the row bands.  This module imports nothing from ``models/``.

Not ported, because it exists for the TPU: the slab programs and the
watchdog bound, the k-escalation ladder and its XLA rescue (each lane of
the port's solver stops on its own, so a shard runs the dense solver on
its lanes), ``jit(shard_map)`` caching, and the residual-band gates.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import constants
from ..ops import color, ecc as ecc_ops, filters, orb, ransac, resize, warp
from ..ops import stack as stack_ops
from ..ops.sr_cuda import normalise
from ..ops.warp_batch import warp_sum_lanes
from ..ops.warp_cuda import warp_bilinear, warp_frames
from ..params import MotionType
from ..utils import io
from ..utils.device import ChunkUploader, resolve_device


class Mesh:
    """A ``('data', 'spatial')`` mesh; ``devices`` is this process's part.

    The global device list is rank-major (each process's devices are
    contiguous) and reshaped to ``[data, spatial]``, as the JAX package
    lays out ``jax.devices()``.  ``devices`` is this process's
    ``[data_local, spatial_local]`` object array of ``torch.device``:
    whole mesh rows from row ``data0`` (``spatial_local == spatial``), or
    where a mesh row spans ``spatial / spatial_local`` processes, the
    bands ``s0 ...`` of row ``data0``.  ``shape`` is the global ``{"data",
    "spatial"}``; ``rank`` / ``world`` this process's place in the
    ``torch.distributed`` group of a ``distributed`` mesh; ``row_ranks``
    the ranks of its mesh row, ``col_ranks`` the ranks that hold its
    bands in every row (the ``'data'`` axis of its bands)."""

    axis_names = ("data", "spatial")

    def __init__(self, devices: np.ndarray, rank: int = 0, world: int = 1,
                 distributed: bool = False, spatial: Optional[int] = None,
                 groups: Optional[dict] = None):
        self.devices = devices
        self.rank = int(rank)
        self.world = int(world)
        self.distributed = bool(distributed)
        nsp = devices.shape[1] if spatial is None else int(spatial)
        span = nsp // devices.shape[1]  # processes a mesh row spans
        row = self.rank // span
        self.shape = {"data": devices.shape[0] * self.world // span,
                      "spatial": nsp}
        self.data0 = row * devices.shape[0]
        self.s0 = (self.rank % span) * devices.shape[1]
        self.row_ranks = tuple(range(row * span, (row + 1) * span))
        self.col_ranks = tuple(range(self.rank % span, self.world, span))
        # weak references: a mesh must not keep a group alive past
        # destroy_process_group() (see group)
        self._groups = {k: weakref.ref(g) for k, g in (groups or {}).items()}

    @property
    def group(self):
        """The default group, looked up at each use: a mesh that outlives
        ``destroy_process_group()`` must not hold the group, whose gloo
        threads would then be torn down at the interpreter's exit (an
        abort, "terminate called without an active exception")."""
        return self._group(tuple(range(self.world)))

    @property
    def row_group(self):
        """The group of this process's mesh row (the ``'spatial'`` sums
        and the halo exchanges); None where the row is in one process."""
        return self._group(self.row_ranks)

    @property
    def data_group(self):
        """The group that holds this process's bands in every mesh row
        (the ``'data'`` sums and gathers); None in one process."""
        return self._group(self.col_ranks)

    def _group(self, ranks: tuple):
        if not self.distributed:
            return None
        if not dist.is_initialized():
            raise RuntimeError(
                "the process group of this global mesh was destroyed")
        if len(ranks) == self.world:
            return dist.group.WORLD
        if len(ranks) == 1:
            return None
        group = self._groups[ranks]()
        if group is None:
            raise RuntimeError(
                "the process group of this global mesh was destroyed")
        return group

    @property
    def data_local(self) -> int:
        return self.devices.shape[0]

    @property
    def spatial_local(self) -> int:
        return self.devices.shape[1]

    @property
    def spans(self) -> bool:
        """Whether a mesh row spans processes."""
        return self.spatial_local < self.shape["spatial"]

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, devices={self.devices.tolist()}, "
                f"rank={self.rank}, world={self.world}, data0={self.data0}, "
                f"s0={self.s0})")


def _device(d) -> torch.device:
    """A device of a mesh: resolved (no CPU fallback), with its index."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _visible_cuda() -> List[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(devices: Optional[Sequence] = None, data: Optional[int] = None,
              spatial: int = 1) -> Mesh:
    """Build a ``('data', 'spatial')`` mesh over ``devices`` (default:
    every visible CUDA device; without a card that raises, it never
    becomes a CPU mesh).  A device may be named more than once:
    ``make_mesh(["cpu"] * 4, data=4)`` runs four shards on the CPU,
    ``make_mesh(["cuda:0"] * 4)`` four shards of one card."""
    if devices is None:
        devices = _visible_cuda()
        if not devices:
            raise RuntimeError(
                "make_mesh() needs a CUDA device (torch.cuda.is_available() "
                "is False); pass devices=['cpu'] * k for a CPU mesh")
    devs = [_device(d) for d in devices]
    n = len(devs)
    if data is None:
        data = n // spatial
    if data * spatial != n:
        raise ValueError(f"data({data}) * spatial({spatial}) != devices({n})")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(data, spatial))


# --- multi-process scale-out ----------------------------------------------


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join a multi-process run: ``dist.init_process_group`` over
    ``tcp://coordinator_address`` ("host:port") with world size
    ``num_processes`` and rank ``process_id``.  With no arguments it
    reads ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``
    from the environment.  ``backend`` defaults to NCCL when a card is
    visible, else gloo."""
    if backend is None:
        backend = "nccl" if _visible_cuda() else "gloo"
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
        return
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))


def _rank_card() -> torch.device:
    """This process's card in a multi-process run: the one ``LOCAL_RANK``
    names (as ``torchrun`` sets it) where that card is visible, else the
    current device."""
    local = os.environ.get("LOCAL_RANK")
    if local is not None and 0 <= int(local) < torch.cuda.device_count():
        return torch.device("cuda", int(local))
    return torch.device("cuda", torch.cuda.current_device())


def _card_id(dev: torch.device) -> str:
    """A name of a card that two processes on one host agree on (its
    UUID where PyTorch reports one)."""
    uuid = getattr(torch.cuda.get_device_properties(dev), "uuid", None)
    return str(uuid) if uuid is not None else \
        f"{socket.gethostname()}/cuda:{dev.index}"


def _check_cards(cards_by_rank: Sequence[Sequence[str]]) -> None:
    """Raise if a card is in the mesh of more than one rank (NCCL runs
    one rank on a card; the ranks would also shard onto each other's
    lanes' devices)."""
    owner: dict = {}
    for rank, cards in enumerate(cards_by_rank):
        for card in set(cards):
            if card in owner:
                raise ValueError(
                    f"card {card} is in the meshes of ranks {owner[card]} "
                    f"and {rank}: give each process its own cards "
                    "(devices=, or LOCAL_RANK / torch.cuda.set_device)")
            owner[card] = rank


def _span(local: int, spatial: int, world: int) -> int:
    """The processes a mesh row spans: 1 where ``spatial`` divides the
    ``local`` devices of a process (it holds whole rows), ``spatial /
    local`` where ``local`` divides ``spatial`` (it holds a run of one
    row's bands); any other layout raises."""
    if spatial < 1 or (local % spatial and spatial % local):
        raise ValueError(
            f"spatial({spatial}) and this process's {local} devices: one "
            "must divide the other (a process holds whole mesh rows, or a "
            "run of bands of one row)")
    span = max(1, spatial // local)
    if world % span:
        raise ValueError(
            f"a mesh row of spatial({spatial}) spans {span} processes of "
            f"{local} devices; {world} processes do not fill whole rows")
    return span


def make_global_mesh(data: Optional[int] = None, spatial: int = 1,
                     devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over every process of the default group (after
    :func:`init_distributed`), laid out as the JAX package lays out
    ``jax.devices()``: the processes' ``devices`` in rank order, reshaped
    to ``[data, spatial]`` (``data`` defaults to all devices / spatial).
    By default a process's devices are one card under NCCL, the one
    ``LOCAL_RANK`` names (else the current device), and one CPU shard
    under gloo; several are passed as ``devices``, as many in every
    process.  Where ``spatial`` exceeds them, a mesh row spans
    ``spatial / len(devices)`` consecutive ranks and every rank calls
    ``dist.new_group`` for each row's ranks, then each band column's, in
    that order.  Under NCCL a card in the meshes of two processes raises
    (the processes exchange their cards' UUIDs); under gloo, whose
    collectives run on the host, two processes may share a card."""
    world, rank = dist.get_world_size(), dist.get_rank()
    backend = dist.get_backend()
    if devices is None:
        devices = ([_rank_card()] if backend == "nccl"
                   else [torch.device("cpu")])
    devs = [_device(d) for d in devices]
    cards = [d for d in devs if d.type == "cuda"]
    everyone: list = [None] * world
    with _on(cards[0] if cards else devs[0]):
        dist.all_gather_object(everyone, (len(devs),
                                          [_card_id(d) for d in cards]))
    counts = sorted({n for n, _ in everyone})
    if len(counts) > 1:
        raise ValueError(f"the processes hold {counts} devices: every "
                         "process must pass as many")
    span = _span(len(devs), spatial, world)
    ndata = len(devs) * world // spatial
    if data is not None and data != ndata:
        raise ValueError(
            f"data({data}) * spatial({spatial}) != {len(devs)} devices * "
            f"{world} processes")
    if backend == "nccl":
        _check_cards([ids for _, ids in everyone])
    groups = {}
    if span > 1:
        rows = [tuple(range(r * span, (r + 1) * span))
                for r in range(world // span)]
        cols = [tuple(range(p, world, span)) for p in range(span)]
        for ranks in rows + cols:  # every rank, in this order
            if 1 < len(ranks) < world:
                group = dist.new_group(list(ranks))
                if rank in ranks:  # a non-member gets a sentinel
                    groups[ranks] = group
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    local = arr.reshape(-1, min(spatial, len(devs)))
    return Mesh(local, rank=rank, world=world, distributed=True,
                spatial=spatial, groups=groups)


# --- sharded bursts --------------------------------------------------------


@dataclasses.dataclass
class ShardedFrames:
    """This process's part of a burst sharded over ``'data'``:
    ``shards[i]`` holds global lanes ``offset + i*n_loc ...`` on
    ``mesh.devices[i, 0]``; ``n_global`` lanes in all."""

    shards: List[torch.Tensor]
    offset: int
    n_global: int

    @property
    def n_loc(self) -> int:
        return self.shards[0].shape[0]

    @property
    def shape(self):
        return (self.n_global,) + tuple(self.shards[0].shape[1:])

    @property
    def dtype(self):
        return self.shards[0].dtype


def _to(x, dev: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(dev).contiguous()


def _place(local, mesh: Mesh, offset: int, n_global: int) -> ShardedFrames:
    n_loc = local.shape[0] // mesh.data_local
    shards = [_to(local[i * n_loc : (i + 1) * n_loc], mesh.devices[i, 0])
              for i in range(mesh.data_local)]
    return ShardedFrames(shards, offset, n_global)


def shard_frames(frames, mesh: Mesh) -> ShardedFrames:
    """Place a ``[N,...]`` burst (numpy or tensor) with the frame axis
    sharded over ``'data'``: data shard ``i`` gets frames ``[i*n_loc,
    (i+1)*n_loc)`` on ``mesh.devices[i, 0]``.  With several processes
    each keeps its own rows of the full burst it was given (the ranks of
    one mesh row the same ones)."""
    if isinstance(frames, ShardedFrames):
        return frames
    n = frames.shape[0]
    lo, per = _data_rows(n, mesh)
    return _place(frames[lo : lo + per], mesh, lo, n)


def _data_rows(n: int, mesh: Mesh) -> tuple:
    """``(first, count)`` of this process's frames of a global ``[N]``
    burst sharded over ``'data'``."""
    ndata = mesh.shape["data"]
    if n % ndata != 0:
        raise ValueError(f"N={n} must divide the data axis ({ndata})")
    n_loc = n // ndata
    return mesh.data0 * n_loc, mesh.data_local * n_loc


def shard_frames_global(frames_local, mesh: Mesh) -> ShardedFrames:
    """Assemble the global burst from each process's own frames (every
    process passes the ``n_local`` frames of its data shards, the ranks
    of one mesh row the same ones; ``N = n_local * data / data_local``):
    this process's lanes start at ``data0 * n_local / data_local``."""
    n_local = frames_local.shape[0]
    if n_local % mesh.data_local != 0:
        raise ValueError(
            f"n_local={n_local} must divide this process's "
            f"{mesh.data_local} data shards")
    n_loc = n_local // mesh.data_local
    return _place(frames_local, mesh, mesh.data0 * n_loc,
                  n_loc * mesh.shape["data"])


# --- running shards and reducing them ---------------------------------------


def _on(dev: torch.device):
    """The context that makes ``dev`` current for its kernels."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _run(devs: Sequence[torch.device], fn) -> list:
    """``[fn(k) for k in range(len(devs))]``, each call under
    ``torch.cuda.device(devs[k])``: one host thread per distinct device,
    which runs its calls in order (one device runs on this thread)."""
    groups: dict = {}
    for k, d in enumerate(devs):
        groups.setdefault(str(d), []).append(k)
    out = [None] * len(devs)

    def work(ks):
        for k in ks:
            with _on(devs[k]):
                out[k] = fn(k)

    if len(groups) == 1:
        work(list(range(len(devs))))
        return out
    with ThreadPoolExecutor(len(groups)) as pool:
        for fut in [pool.submit(work, ks) for ks in groups.values()]:
            fut.result()
    return out


def _map_shards(mesh: Mesh, fn) -> list:
    """``fn(i, dev)`` for every local data shard ``i`` (see :func:`_run`)."""
    devs = [mesh.devices[i, 0] for i in range(mesh.data_local)]
    return _run(devs, lambda i: fn(i, devs[i]))


def _tree_sum(parts, dev: torch.device) -> torch.Tensor:
    """Pairwise sum of ``parts`` in order, on ``dev``."""
    xs = [p.to(dev) for p in parts]
    while len(xs) > 1:
        xs = [xs[k] + xs[k + 1] if k + 1 < len(xs) else xs[k]
              for k in range(0, len(xs), 2)]
    return xs[0]


def _comm_device(mesh: Mesh, group) -> torch.device:
    """Where a collective's tensors live: the card under NCCL, the host
    under gloo (which then moves CPU copies, as two processes may share a
    card there)."""
    return (mesh.devices[0, 0] if dist.get_backend(group) == "nccl"
            else torch.device("cpu"))


def _psum(parts, mesh: Mesh) -> torch.Tensor:
    """The sum over ``'data'`` of one partial per local shard -> a tensor
    on ``devices[0, 0]``, equal on every process of its band column."""
    dev0 = mesh.devices[0, 0]
    group = mesh.data_group
    with _on(dev0):
        total = _tree_sum(parts, dev0).contiguous()
        if group is not None:
            comm = _comm_device(mesh, group)
            x = total.to(comm)
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
            total = x.to(dev0)
    return total


def _psum_each(parts, mesh: Mesh) -> tuple:
    """:func:`_psum` of each member of per-shard tuples."""
    return tuple(_psum([p[k] for p in parts], mesh)
                 for k in range(len(parts[0])))


def _gather(parts, mesh: Mesh) -> np.ndarray:
    """Per-shard ``[n_loc, ...]`` -> the global ``[N, ...]`` numpy array
    in lane order (``dist.all_gather`` over the band column)."""
    local = torch.cat([p.detach().cpu() for p in parts])
    group = mesh.data_group
    if group is None:
        return local.numpy()
    dtype = local.dtype
    x = local.to(torch.uint8) if dtype == torch.bool else local
    comm = _comm_device(mesh, group)
    with _on(comm):
        x = x.to(comm).contiguous()
        bufs = [torch.empty_like(x) for _ in mesh.col_ranks]
        dist.all_gather(bufs, x, group=group)
        out = torch.cat(bufs).cpu()
    return (out.to(torch.bool) if dtype == torch.bool else out).numpy()


def _lanes(x, sf: ShardedFrames, i: int, dev) -> Optional[torch.Tensor]:
    """Shard ``i``'s rows of a global ``[N]`` lane array, on ``dev``."""
    if x is None:
        return None
    lo = sf.offset + i * sf.n_loc
    return _to(np.asarray(x)[lo : lo + sf.n_loc], dev)


def _sigma_stack(sf: ShardedFrames, minvs, okss, mesh: Mesh,
                 perspective: bool, kappa: float, iters: int):
    """Distributed kappa-sigma clip: each shard's moments
    (``stack.moments_sweep``, B4) reduced over ``'data'``, the clip
    iteration of ``stack.clip_stack`` on the reduced sums -> (image,
    clipped sample fraction)."""

    def sweep(mu=None, tol=None):
        def one(i, dev):
            return stack_ops.moments_sweep(
                sf.shards[i], minvs[i], okss[i],
                None if mu is None else mu.to(dev),
                None if tol is None else tol.to(dev), perspective)

        return _psum_each(_map_shards(mesh, one), mesh)

    return stack_ops.clip_stack(sweep, kappa, iters)


def _sr_stack(sf: ShardedFrames, minvs, okss, mesh: Mesh, factor: int,
              perspective: bool) -> torch.Tensor:
    """Distributed super-resolution: each shard's deposit
    (``stack.deposit_sum``, B6's deposit form), ``acc_v`` / ``acc_w``
    reduced over ``'data'``, then ``sr_cuda.normalise`` once."""
    return normalise(_psum_each(_map_shards(
        mesh, lambda i, dev: stack_ops.deposit_sum(
            sf.shards[i], minvs[i], okss[i], factor,
            perspective=perspective)), mesh))


def _stack_lanes(sf: ShardedFrames, mesh: Mesh, maps, oks, identity, *,
                 perspective, stacking, sigma_kappa, sigma_iters,
                 output_scale, scale_hw=None, **border) -> tuple:
    """Each shard's solved lanes (``maps`` forward, ``oks``) stacked and
    reduced over ``'data'`` -> ``(oks, total, clip_frac)``.  ``identity``
    lanes are stacked with the exact identity and kept whatever their
    solve gave; maps solved on the ``scale_hw`` grid are rescaled.  The
    mean is ``warp_sum_lanes`` (``border`` its border keywords);
    sigma-clip and super-resolution give the FINAL image."""
    if identity is not None:
        ident = [_lanes(np.asarray(identity, bool), sf, i, ok.device)
                 for i, ok in enumerate(oks)]
        oks = [ok | d for ok, d in zip(oks, ident)]
        maps = [torch.where(d[:, None, None], torch.eye(
            3, dtype=m.dtype, device=m.device)[: m.shape[1]], m)
            for m, d in zip(maps, ident)]
    if not (output_scale > 1 or stacking == "sigma_clip"):
        total = _psum(_map_shards(mesh, lambda i, dev: warp_sum_lanes(
            sf.shards[i], maps[i], oks[i], perspective=perspective,
            scale_hw=scale_hw, **border)), mesh)
        return oks, total, None
    if scale_hw is not None:
        maps = [warp.rescale_maps(m, scale_hw, sf.shape[1:3]) for m in maps]
    minvs = [stack_ops.sweep_lanes(m, ok, ok.device, frame0=False)[0]
             for m, ok in zip(maps, oks)]
    if output_scale > 1:
        return oks, _sr_stack(sf, minvs, oks, mesh, int(output_scale),
                              perspective), None
    return (oks,) + _sigma_stack(sf, minvs, oks, mesh, perspective,
                                 float(sigma_kappa), int(sigma_iters))


# --- ECC ------------------------------------------------------------------


def _check_stacking(stacking: str, output_scale: int) -> None:
    if stacking not in ("mean", "sigma_clip"):
        raise ValueError(
            f"stacking must be 'mean' or 'sigma_clip', got {stacking!r}")
    if output_scale > 1 and stacking != "mean":
        raise ValueError("output_scale > 1 cannot be combined with sigma_clip")


def ecc_stack_step(
    frames_u8,
    reference_grey,
    mesh: Mesh,
    motion_type: MotionType = MotionType.Homography,
    num_iters: int = 50,
    eps: float = 1e-4,
    gauss_filt_size: int = 5,
    phase_init: bool = True,
    stacking: str = "mean",
    sigma_kappa: float = 2.5,
    sigma_iters: int = 1,
    scale_hw=None,
    coarse_levels: int = 0,
    input_mask=None,
    lane_valid=None,
    return_extras: bool = False,
    output_scale: int = 1,
    mode: Optional[str] = None,
    phase_init_rotation: bool = False,
):
    """One sharded align+stack step.

    ``frames_u8``: ``[N,H,W,3]`` uint8 / uint16 (numpy, a tensor, or the
    :class:`ShardedFrames` of :func:`shard_frames` /
    :func:`shard_frames_global`), N divisible by the ``'data'`` axis;
    every lane is solved against ``reference_grey`` ([H,W] float32, the
    grey of the reference frame; at the solve grid ``scale_hw`` when
    given).  Each shard runs the dense path's solver on its lanes
    (``ops/ecc.find_transform_ecc_batched``: octaves with
    ``coarse_levels``, ``input_mask`` at the solve grid, which turns the
    phase start off, ``mode``), then stacks them: the warp-and-sum of
    the kept lanes (B2) reduced over ``'data'`` (divide by ``ok.sum()``
    for the mean); with ``stacking="sigma_clip"`` the FINAL kappa-sigma
    image; with ``output_scale > 1`` the FINAL ``[f*H, f*W, 3]``
    super-resolution image.  ``lane_valid`` ([N] bool) marks pad lanes,
    excluded and reported ``ok=False``.

    Returns ``(total, ok [N] numpy)`` (``total`` on ``devices[0, 0]``),
    plus ``(rho [N], iters [N])`` with ``return_extras``.
    ``phase_init_rotation`` (not in the JAX package's step) asks the
    phase start for rotation and scale too, as the dense path does."""
    total, ok, rho, iters, _ = _ecc_step(
        frames_u8, reference_grey, mesh, scale_hw=scale_hw,
        stacking=stacking, sigma_kappa=sigma_kappa, sigma_iters=sigma_iters,
        lane_valid=lane_valid, output_scale=output_scale,
        motion_type=motion_type, num_iters=int(num_iters), eps=float(eps),
        gauss_filt_size=int(gauss_filt_size), phase_init=bool(phase_init),
        phase_init_rotation=bool(phase_init_rotation),
        coarse_levels=int(coarse_levels), input_mask=input_mask, mode=mode)
    return (total, ok, rho, iters) if return_extras else (total, ok)


def _ecc_solve(sf: ShardedFrames, reference_grey, mesh: Mesh, *, scale_hw,
               input_mask, **solve) -> list:
    """Each shard's ``EccResult`` (warps at the solve grid): the grey of
    its frames, then the align stage (``ops/ecc.align_lanes``; ``solve``
    its keywords)."""
    ref = torch.as_tensor(reference_grey).to(torch.float32)
    if input_mask is not None:
        input_mask = torch.as_tensor(input_mask)

    def one(i, dev):
        grey = color.burst_grey_f32(sf.shards[i], scale_hw)
        return ecc_ops.align_lanes(
            grey, ref.to(dev),
            input_mask=None if input_mask is None else input_mask.to(dev),
            **solve)

    return _map_shards(mesh, one)


def _typed_grid(scale_hw, reference_grey):
    """``scale_hw`` as ints (None stays None), checked against the
    reference grey, which must be at the solve grid."""
    if scale_hw is None:
        return None
    scale_hw = (int(scale_hw[0]), int(scale_hw[1]))
    if reference_grey is not None and tuple(reference_grey.shape) != scale_hw:
        raise ValueError(
            f"reference_grey must be at the solve grid {scale_hw}, "
            f"got {tuple(reference_grey.shape)}")
    return scale_hw


def _ecc_step(frames_u8, reference_grey, mesh, *, scale_hw,
              stacking="mean", sigma_kappa=2.5, sigma_iters=1,
              lane_valid=None, output_scale=1, identity=None, **solve):
    """:func:`ecc_stack_step` -> ``(total, ok, rho, iters, clip_frac)``
    (keywords only, ``solve`` those of ``ops/ecc.align_lanes``: the entry
    points and streams call it with their parameters' bundle).
    ``identity`` ([N] bool) marks lanes stacked with the exact identity
    and kept whatever their solve gave (the entry points' frame 0 in the
    sigma-clip stack)."""
    _check_stacking(stacking, output_scale)
    sf = shard_frames(frames_u8, mesh)
    scale_hw = _typed_grid(scale_hw, reference_grey)
    results = _ecc_solve(sf, reference_grey, mesh, scale_hw=scale_hw,
                         **solve)
    oks = [r.ok if lane_valid is None else
           r.ok & _lanes(np.asarray(lane_valid, bool), sf, i, r.ok.device)
           for i, r in enumerate(results)]
    oks, total, clip_frac = _stack_lanes(
        sf, mesh, [r.warp_matrix for r in results], oks, identity,
        perspective=solve["motion_type"] == MotionType.Homography,
        stacking=stacking, sigma_kappa=sigma_kappa, sigma_iters=sigma_iters,
        output_scale=output_scale, scale_hw=scale_hw)
    ok = _gather(oks, mesh)
    rho = _gather([r.rho for r in results], mesh)
    iters = _gather([r.num_iters for r in results], mesh)
    return total, ok, rho, iters, clip_frac


# --- keypoint -------------------------------------------------------------


def _shard_generator(seed: int, shard: Optional[int], device,
                     chunk: Optional[int] = None) -> torch.Generator:
    """RANSAC's generator for global data shard ``shard`` (of stream
    chunk ``chunk``): seeded from ``(seed[, chunk][, shard])`` through
    ``np.random.SeedSequence``, so one burst draws the same hypotheses
    whatever the process layout of its ``'data'`` axis.  ``shard`` is
    None on a data axis of one shard, whose stream chunks then draw what
    the one-device stream always drew (``(seed, chunk)``)."""
    key = [int(seed) % 2 ** 64] + ([] if chunk is None else [int(chunk)])
    state = np.random.SeedSequence(key + ([] if shard is None
                                          else [int(shard)]))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return gen


def _ref_features(ref_feats) -> orb.OrbFeatures:
    """Frame 0's features with a leading axis of 1 (the JAX package's
    step takes them without it)."""
    feats = orb.OrbFeatures(*ref_feats)
    if feats.descriptors.ndim == 2:
        feats = orb.OrbFeatures(*(t[None] for t in feats))
    return feats


def _kp_solve(sf: ShardedFrames, ref_feats, mesh: Mesh, *, seed, scale_hw,
              det_mask, lane_valid, chunk=None, **match) -> list:
    """Each shard's ``(hs [n,3,3] full-res, failed lanes the identity;
    oks; match counts; inlier counts)``: ORB (B8, B3h, B3d) on its
    frames, then the align stage (``ops/ransac.match_and_estimate``;
    ``match`` its keywords) against frame 0's features, RANSAC from its
    own generator."""
    ref = _ref_features(ref_feats)
    h, w = sf.shape[1], sf.shape[2]
    scale_hw = _typed_grid(scale_hw, None)
    dmask = None if det_mask is None else torch.as_tensor(det_mask)
    shard0 = sf.offset // sf.n_loc
    several = mesh.shape["data"] > 1

    def one(i, dev):
        grey = color.burst_grey_u8(sf.shards[i], scale_hw)
        feats = orb.orb_detect_and_compute(
            grey, mask=None if dmask is None else dmask.to(dev))
        both = orb.OrbFeatures(*(torch.cat([a.to(dev), b])
                                 for a, b in zip(ref, feats)))
        hs, oks, mc, ic = ransac.match_and_estimate(
            both, _shard_generator(seed, shard0 + i if several else None,
                                   dev, chunk), **match)
        if lane_valid is not None:
            oks = oks & _lanes(np.asarray(lane_valid, bool), sf, i, dev)
        if scale_hw is not None:
            hs = warp.rescale_maps(hs, scale_hw, (h, w))
        eye = torch.eye(3, dtype=hs.dtype, device=dev)
        return torch.where(oks[:, None, None], hs, eye), oks, mc, ic

    return _map_shards(mesh, one)


def _kp_check(stacking, border_mode, output_scale) -> str:
    _check_stacking(stacking, 1)
    border = warp._resolve_border(border_mode)
    if stacking == "sigma_clip" and border not in ("constant", "transparent"):
        raise ValueError(
            "stacking='sigma_clip' requires BORDER_CONSTANT or "
            f"BORDER_TRANSPARENT, got border mode {border!r}")
    if output_scale > 1 and (
            stacking != "mean" or border not in ("constant", "transparent")):
        raise ValueError(
            "output_scale > 1 requires stacking='mean' and "
            "BORDER_CONSTANT/TRANSPARENT")
    return border


def keypoint_stack_step(
    frames_u8,
    ref_feats,
    mesh: Mesh,
    method: int = 8,
    ransac_reproj_threshold: float = 5.0,
    match_ratio: float = 0.9,
    match_keep_ratio: float = 0.8,
    max_iters: int = 2000,
    confidence: float = 0.995,
    seed: int = 0,
    stacking: str = "mean",
    sigma_kappa: float = 2.5,
    sigma_iters: int = 1,
    scale_hw=None,
    det_mask=None,
    border_mode: int = 0,
    border_value=(0.0, 0.0, 0.0, 0.0),
    lane_valid=None,
    return_extras: bool = False,
    output_scale: int = 1,
):
    """One sharded ORB/RANSAC align+stack step, the keypoint counterpart
    of :func:`ecc_stack_step`.

    ``frames_u8``: ``[N,H,W,3]`` (as :func:`ecc_stack_step` takes it);
    ``ref_feats``: frame 0's ``ops.orb.OrbFeatures`` (with or without the
    leading axis), detected on the ``scale_hw`` grid when given and with
    ``det_mask``.  Each shard detects, matches every lane against them
    and runs RANSAC from a generator seeded by ``(seed, global shard
    index)``; dropped lanes add nothing.  The mean path's sum (B2 for
    BORDER_CONSTANT / TRANSPARENT, B5's accumulate form for the
    index-mapping modes) is reduced over ``'data'``: divide by
    ``ok.sum()``.  ``stacking="sigma_clip"`` and ``output_scale > 1``
    return the FINAL image, as in :func:`ecc_stack_step`.

    Returns ``(total, ok [N])``, plus ``(match_counts [N],
    inlier_counts [N])`` with ``return_extras``."""
    total, ok, mc, ic, _ = _kp_step(
        frames_u8, ref_feats, mesh, seed=int(seed), scale_hw=scale_hw,
        det_mask=det_mask, stacking=stacking, sigma_kappa=sigma_kappa,
        sigma_iters=sigma_iters, border_mode=border_mode,
        border_value=border_value, lane_valid=lane_valid,
        output_scale=output_scale, **_typed_match(
            method, ransac_reproj_threshold, match_ratio, match_keep_ratio,
            max_iters, confidence))
    return (total, ok, mc, ic) if return_extras else (total, ok)


def _typed_match(method, ransac_reproj_threshold, match_ratio,
                 match_keep_ratio, max_iters, confidence) -> dict:
    """The public steps' keywords of ``ops/ransac.match_and_estimate``,
    typed."""
    return dict(
        method=int(method), ransac_reproj_threshold=float(
            ransac_reproj_threshold), match_ratio=float(match_ratio),
        match_keep_ratio=float(match_keep_ratio), max_iters=int(max_iters),
        confidence=float(confidence))


def _kp_step(frames_u8, ref_feats, mesh, *, seed, scale_hw, det_mask,
             stacking="mean", sigma_kappa=2.5, sigma_iters=1, border_mode=0,
             border_value=(0.0, 0.0, 0.0, 0.0), lane_valid=None,
             output_scale=1, identity=None, chunk=None, **match):
    """:func:`keypoint_stack_step` -> ``(total, ok, mc, ic, clip_frac)``
    (keywords only, ``match`` those of ``ops/ransac.match_and_estimate``:
    the entry points and streams call it with their parameters' bundle);
    ``identity`` as in :func:`_ecc_step`, ``chunk`` the stream chunk the
    generators are seeded with."""
    _kp_check(stacking, border_mode, output_scale)
    sf = shard_frames(frames_u8, mesh)
    solved = _kp_solve(sf, ref_feats, mesh, seed=seed, scale_hw=scale_hw,
                       det_mask=det_mask, lane_valid=lane_valid, chunk=chunk,
                       **match)
    okss, total, clip_frac = _stack_lanes(
        sf, mesh, [s[0] for s in solved], [s[1] for s in solved], identity,
        perspective=True, stacking=stacking, sigma_kappa=sigma_kappa,
        sigma_iters=sigma_iters, output_scale=output_scale,
        border_value=list(tuple(border_value)[:3]), border_mode=border_mode)
    ok = _gather(okss, mesh)
    mc = _gather([s[2] for s in solved], mesh)
    ic = _gather([s[3] for s in solved], mesh)
    return total, ok, mc, ic, clip_frac


def keypoint_solve_step(
    frames_u8,
    ref_feats,
    mesh: Mesh,
    method: int = 8,
    ransac_reproj_threshold: float = 5.0,
    match_ratio: float = 0.9,
    match_keep_ratio: float = 0.8,
    max_iters: int = 2000,
    confidence: float = 0.995,
    seed: int = 0,
    scale_hw=None,
    det_mask=None,
    lane_valid=None,
    chunk: Optional[int] = None,
):
    """The sharded keypoint solve alone (the streams' sigma-clip sweeps
    warp the burst later) -> ``(hs [N,3,3] full-res, ok [N],
    match_counts [N], inlier_counts [N])`` as numpy.  ``chunk`` (not in
    the JAX package's step) seeds the generators as a stream chunk."""
    sf = shard_frames(frames_u8, mesh)
    solved = _kp_solve(sf, ref_feats, mesh, seed=int(seed),
                       scale_hw=scale_hw, det_mask=det_mask,
                       lane_valid=lane_valid, chunk=chunk, **_typed_match(
                           method, ransac_reproj_threshold, match_ratio,
                           match_keep_ratio, max_iters, confidence))
    return tuple(_gather([s[k] for s in solved], mesh) for k in range(4))


def _ecc_solve_gathered(sf: ShardedFrames, reference_grey, mesh: Mesh, *,
                        full_hw=None, **solve):
    """The sharded ECC solve alone (keywords of :func:`_ecc_solve`) ->
    ``(warps [N,r,3], rho [N], iters [N], ok [N])`` as numpy (the ECC
    stream's sigma-clip align pass).  The warps are at the solve grid,
    or rescaled on each shard's device to ``full_hw`` when given."""
    res = _ecc_solve(sf, reference_grey, mesh, **solve)
    warps = [r.warp_matrix for r in res]
    if full_hw is not None and solve["scale_hw"] is not None:
        warps = [warp.rescale_maps(w, solve["scale_hw"], full_hw)
                 for w in warps]
    return (_gather(warps, mesh),) + tuple(
        _gather([getattr(r, k) for r in res], mesh)
        for k in ("rho", "num_iters", "ok"))


def stream_moments(sf: ShardedFrames, minv, oks, mesh: Mesh, mu=None,
                   tol=None, perspective: bool = True) -> tuple:
    """One chunk of a stream's sigma-clip sweep over the mesh: ``sf``
    the chunk (:meth:`ShardUploader.padded`), ``minv`` / ``oks``
    its lane rows of ``stack.sweep_lanes`` (pad lanes ``oks=False``);
    each shard's moments (B4) reduced over ``'data'`` -> (S0, S1, S2),
    or the clipped (C0, C1, C2) with ``mu`` / ``tol``."""

    def one(i, dev):
        lo = sf.offset + i * sf.n_loc
        sl = slice(lo, lo + sf.n_loc)
        return stack_ops.moments_chunk(
            sf.shards[i], minv[sl].to(dev), oks[sl].to(dev),
            None if mu is None else mu.to(dev),
            None if tol is None else tol.to(dev), perspective)

    return _psum_each(_map_shards(mesh, one), mesh)


class ShardUploader:
    """The streams' copies over a mesh: each shard's rows of a decoded
    chunk go to its own device through its own
    ``utils.device.ChunkUploader`` (pinned memory and a side stream on
    CUDA)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.ups = [ChunkUploader(mesh.devices[i, 0])
                    for i in range(mesh.data_local)]

    def put(self, frames):
        """Start the copies of ``frames`` ([chunk_size,H,W,3] numpy, the
        whole chunk, as every process decodes it) -> a handle for
        :meth:`ready`."""
        n = frames.shape[0]
        lo, per = _data_rows(n, self.mesh)
        n_loc = per // self.mesh.data_local
        handles = []
        for i, up in enumerate(self.ups):
            part = np.ascontiguousarray(
                frames[lo + i * n_loc : lo + (i + 1) * n_loc])
            with _on(up.device):
                handles.append(up.put(part))
        return handles, lo, n

    def ready(self, handle) -> ShardedFrames:
        """The chunk of a :meth:`put`, safe to use on the current
        streams."""
        handles, lo, n = handle
        return ShardedFrames([up.ready(h) for up, h in zip(self.ups, handles)],
                             lo, n)

    def padded(self, frames, fill=None):
        """``frames`` padded at the tail to a multiple of the ``'data'``
        axis (``fill``, by default the last frame; nothing to pad on a
        data axis of one shard)."""
        ndata = self.mesh.shape["data"]
        return io.pad_chunk(frames, -(-frames.shape[0] // ndata) * ndata,
                            fill)

    def staged(self, chunks, fill=None):
        """Yield ``(ShardedFrames, n_real, is_last)`` for numpy
        ``chunks``, each :meth:`padded`, the next chunk's copies started
        before the current one is yielded."""
        it = iter(chunks)

        def put_next():
            frames = next(it, None)
            if frames is None:
                return None
            return self.put(self.padded(frames, fill)), frames.shape[0]

        cur = put_next()
        while cur is not None:
            sf, n_real = self.ready(cur[0]), cur[1]
            cur = put_next()
            yield sf, n_real, cur is None


# --- the spatial axis -------------------------------------------------------


def _check_rows(h: int, nsp: int, halo: int) -> int:
    if h % nsp != 0:
        raise ValueError(f"H={h} must divide the spatial axis ({nsp})")
    h_loc = h // nsp
    if halo > h_loc:
        raise ValueError(f"halo {halo} exceeds shard height {h_loc}")
    return h_loc


def _row_p2p(mesh: Mesh, up=None, down=None, above=None,
             below=None) -> tuple:
    """Point-to-point along this process's mesh row: send ``up`` to the
    rank holding the band above its first band and ``down`` to the rank
    holding the band below its last; receive tensors shaped and typed
    like ``above`` (from the rank above) and ``below`` (from the rank
    below).  Every rank posts up, then down, in one
    ``dist.batch_isend_irecv``; a direction without a neighbour, or with
    None, posts nothing.  Under gloo the rows travel as CPU copies, under
    NCCL on the card.  -> ``(from above, from below)`` on
    ``devices[0, 0]``, None where nothing was received."""
    group = mesh.row_group
    ranks, pos = mesh.row_ranks, mesh.row_ranks.index(mesh.rank)
    peers = (ranks[pos - 1] if pos > 0 else None,
             ranks[pos + 1] if pos + 1 < len(ranks) else None)
    comm = _comm_device(mesh, group)
    ops, got = [], [None, None]
    with _on(comm):
        for k, (send, like) in enumerate(((up, above), (down, below))):
            if peers[k] is None:
                continue
            if send is not None:
                ops.append(dist.P2POp(dist.isend, send.to(comm).contiguous(),
                                      peers[k], group))
            if like is not None:
                got[k] = torch.empty(like.shape, dtype=like.dtype,
                                     device=comm)
                ops.append(dist.P2POp(dist.irecv, got[k], peers[k], group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    dev0 = mesh.devices[0, 0]
    return tuple(None if g is None else g.to(dev0) for g in got)


def _row_cat(parts, mesh: Mesh, dim: int = 0, sizes=None,
             dev=None) -> torch.Tensor:
    """This process's bands' ``parts`` of one mesh row, concatenated along
    ``dim`` on ``dev`` (default ``devices[0, 0]``); where the row spans
    processes, the whole row's in band order (``dist.all_gather`` over the
    row group).  ``sizes``: each rank's length along ``dim`` where they
    differ (the parts are padded to the longest for the gather)."""
    dev0 = mesh.devices[0, 0] if dev is None else dev
    local = torch.cat([p.to(dev0) for p in parts], dim=dim)
    if not mesh.spans:
        return local
    group = mesh.row_group
    sizes = sizes or [local.shape[dim]] * len(mesh.row_ranks)
    comm = _comm_device(mesh, group)
    with _on(comm):
        x = local.to(comm)
        if x.shape[dim] < max(sizes):
            pad = list(x.shape)
            pad[dim] = max(sizes) - x.shape[dim]
            x = torch.cat([x, x.new_zeros(pad)], dim=dim)
        bufs = [torch.empty_like(x) for _ in sizes]
        dist.all_gather(bufs, x.contiguous(), group=group)
        out = torch.cat([b.narrow(dim, 0, n) for b, n in zip(bufs, sizes)],
                        dim=dim)
    return out.to(dev0)


def _halo_ext(bands, halo: int, axis: int, edge=None, mesh=None) -> list:
    """Each band with ``halo`` rows of its neighbours' on both sides
    (copied to its device); at the global top and bottom the rows are
    zero, or ``edge(band, top)`` when given.  ``bands`` are this
    process's bands of one mesh row; where the row spans processes
    (``mesh``), the rows above the first band and below the last come
    from the neighbouring ranks (:func:`_row_p2p`)."""

    def first(b):
        return b.narrow(axis, 0, halo)

    def last(b):
        return b.narrow(axis, b.shape[axis] - halo, halo)

    above = below = None
    if mesh is not None and mesh.spans:
        above, below = _row_p2p(mesh, up=first(bands[0]),
                                down=last(bands[-1]), above=last(bands[-1]),
                                below=first(bands[0]))
    nsp = len(bands)
    out = []
    for j, b in enumerate(bands):
        if j > 0:
            top = last(bands[j - 1]).to(b.device)
        elif above is not None:
            top = above.to(b.device)
        else:
            top = (torch.zeros_like(first(b)) if edge is None
                   else edge(b, True))
        if j < nsp - 1:
            bot = first(bands[j + 1]).to(b.device)
        elif below is not None:
            bot = below.to(b.device)
        else:
            bot = (torch.zeros_like(first(b)) if edge is None
                   else edge(b, False))
        out.append(torch.cat([top, b, bot], dim=axis))
    return out


def warp_rows_sharded(frame, m3, mesh: Mesh, halo: int = 64,
                      perspective: bool = True) -> torch.Tensor:
    """Warp one large ``[H,W]`` or ``[H,W,C]`` float32 frame with its rows
    split over ``'spatial'``: band ``j`` (rows ``j*H/S ...`` on
    ``mesh.devices[0, j]``) takes ``halo`` rows from each neighbour and
    resamples its own rows from the extended strip (B5's planar form,
    BORDER_CONSTANT 0).  ``m3`` is the forward map ([3,3] or [2,3]).
    B5 takes the band's row origins as integers (``csrc/warp.cu``), so
    each band equals the rows of the whole frame's warp bitwise.  Where
    a mesh row spans processes, each process warps its own bands of the
    full ``frame`` it was given, and every mesh row warps the frame.

    Correct while every output pixel's source row lies within ``halo``
    rows of its own; taps beyond read zero, as off-frame pixels do.
    ``perspective`` is kept for the JAX package's signature, which also
    warps with the full perspective map.  Returns the frame on
    ``devices[0, 0]``."""
    h, w = frame.shape[0], frame.shape[1]
    h_loc = _check_rows(h, mesh.shape["spatial"], halo)
    devs = [mesh.devices[0, j] for j in range(mesh.spatial_local)]
    m = torch.as_tensor(np.asarray(m3, np.float32)).to(devs[0])
    if m.shape == (2, 3):
        m = warp.affine_to_3x3(m)
    # inverted where the frame is (CPU and CUDA inverses differ in ulps)
    minv = warp.invert_3x3(m)
    rows = [(mesh.s0 + j) * h_loc for j in range(len(devs))]
    bands = [_to(frame[r : r + h_loc], d) for r, d in zip(rows, devs)]
    exts = _halo_ext(bands, halo, 0, mesh=mesh)

    def one(j):
        ext = exts[j].to(torch.float32)
        planes = ext[None] if ext.ndim == 2 else ext.permute(2, 0, 1)
        planes = planes.contiguous()
        mj = minv.to(devs[j]).expand(planes.shape[0], 3, 3).contiguous()
        out = warp_bilinear(planes, mj, border_value=0.0, out_hw=(h_loc, w),
                            rows=(rows[j], rows[j] - halo))
        return out[0] if ext.ndim == 2 else out.permute(1, 2, 0)

    return _row_cat(_run(devs, one), mesh)


def sharpness_teng_spatial(frames, mesh: Mesh, k_size: int = 3):
    """Tenengrad sharpness with frames on ``'data'`` and rows on
    ``'spatial'``: each band takes ``(k_size-1)/2`` rows of its
    neighbours (reflect-101 of its own rows at the global top and
    bottom), so the Sobel window is the dense one at every row; the
    bands' per-frame sums add in band order (gathered over the row group
    where a row spans processes).  ``frames``: ``[N,H,W]`` float32.
    Returns ``[N]`` numpy scores."""
    frames = frames if isinstance(frames, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(frames))
    n, h, w = frames.shape
    r = len(filters.deriv_kernel(1, k_size)) // 2
    nsp, nloc_sp = mesh.shape["spatial"], mesh.spatial_local
    h_loc = _check_rows(h, nsp, r)
    lo, per = _data_rows(n, mesh)
    n_loc = per // mesh.data_local

    def edge(b, top):
        rows = b[:, 1 : r + 1] if top else b[:, -r - 1 : -1]
        return rows.flip(1)

    cells = [(i, j) for i in range(mesh.data_local) for j in range(nloc_sp)]
    devs = [mesh.devices[i, j] for i, j in cells]
    bands = {}
    for (i, j), dev in zip(cells, devs):
        f0, r0 = lo + i * n_loc, (mesh.s0 + j) * h_loc
        bands[i, j] = _to(frames[f0 : f0 + n_loc, r0 : r0 + h_loc],
                          dev).to(torch.float32)
    exts = {}
    for i in range(mesh.data_local):
        row = _halo_ext([bands[i, j] for j in range(nloc_sp)], r, 1, edge,
                        mesh)
        for j in range(nloc_sp):
            exts[i, j] = row[j]

    def one(k):
        x = exts[cells[k]]
        gx = filters.sobel(x, 1, 0, ksize=k_size)[:, r:-r]
        gy = filters.sobel(x, 0, 1, ksize=k_size)[:, r:-r]
        return torch.sum(gx * gx + gy * gy, dim=(1, 2))

    sums = _run(devs, one)
    per_shard = []
    for i in range(mesh.data_local):
        band_sums = _row_cat([sums[i * nloc_sp + j][None]
                              for j in range(nloc_sp)], mesh,
                             dev=mesh.devices[i, 0])
        per_shard.append(sum(band_sums[j] for j in range(nsp)))
    return _gather(per_shard, mesh) / np.float32(h * w)


def _vertical_disp_ok(minv: torch.Tensor, h: int, w: int,
                      halo: int) -> torch.Tensor:
    """Per lane: every output pixel's source row stays within ``halo -
    2`` rows of its own (sampled on a 5x5 grid plus an 8-row margin,
    ``mesh.py:1479-1496``)."""
    dev = minv.device
    ys = torch.linspace(0.0, h - 1.0, 5, device=dev)
    xs = torch.linspace(0.0, w - 1.0, 5, device=dev)
    py = ys.repeat_interleave(5)[None, :]
    px = xs.repeat(5)[None, :]
    den = (minv[:, 2, 0, None] * px + minv[:, 2, 1, None] * py
           + minv[:, 2, 2, None])
    inv = torch.where(den != 0.0, 1.0 / den, torch.zeros_like(den))
    sy = (minv[:, 1, 0, None] * px + minv[:, 1, 1, None] * py
          + minv[:, 1, 2, None]) * inv
    dy = torch.amax(torch.abs(sy - py), dim=1)
    return dy + 8.0 <= halo - 2.0


def ecc_stack_step_spatial(
    frames_u8,
    ref_u8,
    mesh: Mesh,
    scale_hw,
    motion_type: MotionType = MotionType.Homography,
    num_iters: int = 50,
    eps: float = 1e-4,
    gauss_filt_size: int = 5,
    halo: int = 64,
    phase_init: bool = True,
):
    """Align and stack frames whose rows stay split over ``'spatial'``
    for the whole step; no device holds a whole frame.

    ``frames_u8``: ``[N,H,W,3]`` uint8 / uint16 (frames 1..; N divisible
    by ``'data'``, H by ``'spatial'``), ``ref_u8``: ``[H,W,3]`` (frame 0).
    Per band on ``mesh.devices[i, j]``: the grey; the INTER_AREA shrink to
    ``scale_hw``, each band computing the output rows whose first source
    row is its own (with the few rows they read of the next band) by the
    whole image's taps and sums, gathered on the data shard's first
    device for the column pass and the u8 rounding, so the small grid is
    the dense path's bitwise (the JAX package adds the bands' partial row
    sums, ``mesh.py:1460-1478``); the ECC solve once per data shard on
    the small grid (B1); the warps scaled up and lanes
    whose vertical motion leaves the halo dropped; the band's warp and
    sum of the kept frames from its extended strip (B5's accumulate form
    on float32 bands); the sums reduced over ``'data'``; frame 0 added.
    Where a mesh row spans processes, each process takes its own bands
    of the full inputs it was given; the next band's rows come from the
    rank below by point-to-point, the small grid's rows are gathered
    over the row group and every rank of the row solves it (the same
    solve on the same inputs), each band's sum reduces over its column
    group, and the bands are gathered over the row group.

    Returns ``(stacked_sum [H,W,3] on devices[0, 0], ok [N] numpy)``:
    divide by ``1 + ok.sum()`` for the mean."""
    nsp, nloc_sp, s0 = mesh.shape["spatial"], mesh.spatial_local, mesh.s0
    n, h, w = frames_u8.shape[0], frames_u8.shape[1], frames_u8.shape[2]
    hs, ws = int(scale_hw[0]), int(scale_hw[1])
    h_loc = _check_rows(h, nsp, halo)
    lo, per = _data_rows(n, mesh)
    n_loc = per // mesh.data_local
    cells = [(i, j) for i in range(mesh.data_local) for j in range(nloc_sp)]
    devs = [mesh.devices[i, j] for i, j in cells]

    def rows_of(x, j):
        r0 = (s0 + j) * h_loc
        return x[..., r0 : r0 + h_loc, :, :]

    cur = {c: _to(rows_of(frames_u8[lo + c[0] * n_loc : lo + (c[0] + 1)
                                    * n_loc], c[1]), d)
           for c, d in zip(cells, devs)}
    ref = {c: _to(rows_of(ref_u8, c[1]), d) for c, d in zip(cells, devs)}

    # grey per band; the INTER_AREA row pass of the output rows whose
    # first source row is the band's, from the band's rows and the next
    # band's first need[g] (the whole image's taps and sums: resize_rows)
    first_tap = np.argmax(resize._area_weights(h, hs) != 0, axis=1)
    owned = np.searchsorted(first_tap, np.arange(nsp + 1) * h_loc)
    need = [0] * nsp
    for g in range(nsp):
        if owned[g] < owned[g + 1]:
            need[g] = resize.row_span(h, hs, int(owned[g]),
                                      int(owned[g + 1]))[1] - (g + 1) * h_loc
        if need[g] > 0 and (g + 1 == nsp or need[g] > h_loc):
            raise ValueError(
                f"INTER_AREA rows of band {g} reach {need[g]} rows past it")
    greys = {c: color.rgb_to_gray_u8(torch.cat([ref[c][None], cur[c]]))
             for c in cells}
    below = None  # the next rank's first rows, for this process's last band
    if mesh.spans:
        g = s0 + nloc_sp - 1
        below = _row_p2p(
            mesh, up=(greys[0, 0][:, : need[s0 - 1]]
                      if s0 > 0 and need[s0 - 1] > 0 else None),
            below=(greys[0, nloc_sp - 1][:, : need[g]]
                   if g + 1 < nsp and need[g] > 0 else None))[1]

    def mix(k):
        i, j = cells[k]
        g = s0 + j
        a0, a1 = int(owned[g]), int(owned[g + 1])
        if a0 == a1:
            return None
        strip = greys[i, j]
        if need[g] > 0:
            more = (greys[i, j + 1][:, : need[g]] if j + 1 < nloc_sp
                    else below)
            strip = torch.cat([strip, more.to(devs[k])], dim=1)
        return resize.resize_rows(strip, h, hs, a0, a1, g * h_loc)

    parts = _run(devs, mix)
    # each rank's rows of the small grid (a rank may own none)
    sizes = [int(owned[min(b + nloc_sp, nsp)] - owned[b])
             for b in range(0, nsp, nloc_sp)]
    small_rows = []
    for i in range(mesh.data_local):
        dev = mesh.devices[i, 0]
        mine = [p for p in parts[i * nloc_sp : (i + 1) * nloc_sp]
                if p is not None]
        small_rows.append(_row_cat(mine or [torch.zeros(
            (n_loc + 1, 0, w), dtype=torch.float32, device=dev)], mesh,
            dim=1, sizes=sizes, dev=dev))

    def solve(i, dev):
        rows = small_rows[i].to(dev)
        small = resize._resize_axis(rows, -1, ws, constants.INTER_AREA)
        small = torch.clamp(torch.floor(small + 0.5), 0.0, 255.0)
        small_ref, small_cur = small[0], small[1:]
        res = ecc_ops.align_lanes(
            small_cur, small_ref, motion_type=motion_type,
            num_iters=num_iters, eps=eps, gauss_filt_size=gauss_filt_size,
            phase_init=phase_init, phase_init_rotation=False,
            coarse_levels=0, input_mask=None, mode=None)
        warps = warp.rescale_maps(res.warp_matrix, (hs, ws), (h, w))
        m3 = warps if warps.shape[1] == 3 else warp.affine_to_3x3(warps)
        eye = torch.eye(3, dtype=torch.float32, device=dev)
        ok = res.ok
        minv = warp.invert_3x3(torch.where(ok[:, None, None], m3, eye))
        # a warp whose vertical motion leaves the halo would sample zeros
        # from the strip's edge: drop it instead
        ok = ok & _vertical_disp_ok(minv, h, w, halo)
        return torch.where(ok[:, None, None], minv, eye), ok

    solved = _map_shards(mesh, solve)
    oks = [s[1] for s in solved]
    exts = {}
    for i in range(mesh.data_local):
        f32 = [color.to_unit_f32(cur[i, j]) for j in range(nloc_sp)]
        row = _halo_ext(f32, halo, 1, mesh=mesh)
        for j in range(nloc_sp):
            exts[i, j] = row[j]

    def band_sum(k):
        # B5's accumulate form writes the strip's own grid (global rows
        # from row0 - halo): its row halo + y is the band's row y
        i, j = cells[k]
        top = (s0 + j) * h_loc - halo
        out = warp_frames(exts[i, j].contiguous(), solved[i][0].to(devs[k]),
                          valid=oks[i].to(devs[k]), rows=(top, top))
        return out[halo : halo + h_loc]

    sums = _run(devs, band_sum)
    bands = []
    for j in range(nloc_sp):
        total = _psum([sums[i * nloc_sp + j]
                       for i in range(mesh.data_local)], mesh)
        bands.append(total + color.to_unit_f32(ref[0, j]).to(total.device))
    return _row_cat(bands, mesh), _gather(oks, mesh)
