"""Device-mesh scale-out (counterpart of ``libstacker_tpu/parallel``):
frame shards over a ``'data'`` axis with their sums reduced across
devices and processes, row bands over a ``'spatial'`` axis with halo
exchange, and the multi-process helpers.  The public pipelines reach
this layer through their ``mesh=`` argument; the functions here are the
building blocks for custom orchestration."""

from .mesh import (
    ecc_stack_step,
    ecc_stack_step_spatial,
    init_distributed,
    keypoint_solve_step,
    keypoint_stack_step,
    make_global_mesh,
    make_mesh,
    shard_frames,
    shard_frames_global,
    sharpness_teng_spatial,
    warp_rows_sharded,
)

__all__ = [
    "ecc_stack_step",
    "ecc_stack_step_spatial",
    "init_distributed",
    "keypoint_solve_step",
    "keypoint_stack_step",
    "make_global_mesh",
    "make_mesh",
    "shard_frames",
    "shard_frames_global",
    "sharpness_teng_spatial",
    "warp_rows_sharded",
]
