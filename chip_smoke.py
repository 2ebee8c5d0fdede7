#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):

1. device: card name and power limit (``nvidia-smi``), torch / CUDA
   versions, and the ``nvcc`` build of the nine kernel sources of
   ``csrc/`` (one ``nvcc`` per source, all started together);
2. kernel B1 (``ecc_moments.cu``) against its plain PyTorch version at
   the main path's full-resolution shape (99 homography lanes of
   2160x3840, one of them inactive) plus one affine lane;
3. kernel B2 (``warp_accum.cu``) against its plain version, bitwise, at
   the main path's shape (99 u8 frames of 2160x3840, one dropped), its
   u8-source result against its f32-source result (bitwise), and 4
   frames rotated by 30 degrees (bitwise), with the instructions a
   pixel-frame of its frame loop by class (``utils/sass.py``, from
   ``cuobjdump -sass``);
4. the ECC slice on CUDA against the port's own CPU path on a small
   burst (``ok`` flags, warps, stacked interior);
5. the full-size slice: a 100x2160x3840 burst through ``ecc_match_arrays``
   with the headline parameters, once cold and once warm, with the
   kernels' launch counters of the warm run;
6. kernel B8 (``fast.cu``) against its plain version, bitwise, on the
   grey of 20 textured 2160x3840 frames (t=20, b=31) and on their
   1800x3200 pyramid level;
7. kernel B3 (``orb_extract.cu``) against its plain version, bitwise, at
   the level-0 shape of the keypoint path (20 frames, K=218, radius 21,
   some centres at the clamp edges), and kernels B3h and B3d
   (``orb_describe.cu``: Harris at the K=218 candidates, some invalid,
   and the level's selection of Q=109 in one launch; angle and rBRIEF at
   Q=109 keypoints) against theirs, bitwise, on the same level, and B3h
   at nfeatures=5000's level 0 (K=2172, Q=1086), with the detector's
   per-level tail timed each way: B3's patches and the eager chain on
   them (the patch route), and B3h, B3d, with registers, spills, shared
   memory, bound share and B3d's instructions a thread
   (``utils/sass.py``);
8. the keypoint slice on CUDA against the port's own CPU path on a
   4x540x960 burst (``ok`` flags, corners mapped by H, stacked
   interior);
9. the full keypoint slice: 20x2160x3840 through ``keypoint_match_arrays``
   with the default parameters, at full resolution and with
   ``scale_down_width=800``, each cold and warm, with the kernels'
   launch counters of the warm runs, the homographies against the
   burst's true warps (image corners within the RANSAC threshold on the
   detection grid) and the stack against the ground-truth-warp stack;
10. kernel B4 (``warp_accum.cu``, moments form) against its plain version
    at the main path's shape (99 u8 frames of 2160x3840, one dropped): a
    moments pass, then a clip pass fed with that pass's mean and
    kappa-sigma tolerance; S0, S1 and S2 of both passes bitwise, with the
    instruction classes of both passes' frame loops;
11. kernel B5 (``warp.cu``) against its plain version, bitwise, on the 60
    planes of phase 9's 20 RGB 4K frames in each of the six border modes,
    once with slots sharing sources (``src_index``) and once on an output
    grid other than the source's, and as the row warp calls it (a border
    by value, no ``src_index``; on the whole frame and on the strips of
    phase 26's bands of ``rows_frame`` and of the first and last bands
    of the 60 planes, the first strip from 64 rows above the frame);
    its planar form timed in BORDER_CONSTANT, REPLICATE and WRAP, with its
    registers, share of the bound and instructions an output value on a
    slot with its own map and on one reusing the previous slot's, and a
    device copy of the same bytes; then B5's frames and accumulate forms on
    frames 1-19 of that burst as u8, as u16 and as their f32 widening
    (one frame dropped) in the six modes, and the frames form on 1- and
    4-channel copies of 4 of them in each type, bitwise, with the
    keypoint stack's BORDER_REPLICATE sum timed both ways: the float32
    widening, planes, planar B5 and ``torch.sum`` (the route before the
    accumulate form), and the accumulate form; then the accumulate form
    and the frames form timed in each mode, with registers, spills, shared memory, bound share and
    instructions a pixel-frame, and the frames form two columns short
    (W % 4 != 0, its scalar stores) in turns with the full width;
12. kernel B9 (``warp.cu``) against its plain version, bitwise, on 16 lanes
    of 3 shared 4K planes (also by ``torch.profiler``);
13. B1's masked (4-plane) form against its plain version on 99 homography
    lanes of 2160x3840 with a quarter of the mask zero;
14. ECC sigma-clip at full width: phase 5's burst with a bright 3-px
    streak drawn into frames 7, 41 and 83, stacked by the mean and by
    kappa-sigma (kappa 2.5, one clip pass), held against phase 5's clean
    stack on and away from the streaks;
15. ECC with a mask at full width (zero on the top-left sixteenth, as
    ``bench.py:640-642`` sets it);
16. the keypoint path at full width with ``stacking="sigma_clip"`` and
    with ``BORDER_REPLICATE``, and with a detection mask on the
    ``scale_down_width=800`` grid;
17. kernel B7 (``ecc_ic_moments.cu``) against its plain version on 99
    homography lanes of 2160x3840 (one inactive), with and without the
    Gram, plus one affine lane; and B1 without the Gram (the lazy
    solver's sweep) at the same shape;
18. kernel B6 (``sr_deposit.cu``) in both forms against their plain
    versions on frames 0-7 of phase 5's burst (near-identity
    homographies, one lane dropped) at factors 2 and 3, sigma 0.3 and 0.1
    (the hole-fallback form): the deposit (``sr_deposit``) and the image
    (``sr_image``); then at x2 and both sigmas the image form timed
    against the deposit followed by the PyTorch normalisation, both
    also by ``torch.profiler``;
19. ECC super-resolution at full width: the first 8 frames of phase 5's
    burst, headline parameters, ``output_scale=2`` -> 4320x7680, held
    against the mean stack of the same frames (2x2 box mean), through one
    launch of B6's image form and none of its deposit form;
20. keypoint super-resolution at full width: phase 9's burst with
    ``output_scale=2``, held against phase 9's mean stack, through B6 as
    phase 19;
21. the opt-in ECC solvers at full width: phase 5's burst with
    ``solver="lazy"``, ``solver="ic"`` and ``phase_init_rotation=True``,
    at the headline bars and against phase 5's forward stack, with the
    lanes the forward rescue re-solved;
22. the file entry points: 8 frames of 1080x1920 written as 16-bit PNGs
    by ``save_image(..., bit_depth=16)``, as 48-bit TIFFs (uncompressed
    and Deflate with predictor 2, in turns, by ``write_tiff16``) and as
    8-bit PNGs, decoded by ``load_frames`` with and without
    ``preserve_depth`` (bitwise: the written array at full depth; at 8
    bits a PNG's high byte and a TIFF's ``(v + 128) // 257``, libtiff's
    rounding, on either native loader), and ``ecc_match(files)`` (also with
    ``preserve_depth=True`` on 8-bit PNGs, 16-bit PNGs and 48-bit TIFFs)
    and ``keypoint_match(files)`` bitwise against their ``_arrays`` forms
    on the written arrays; it prints which native image library decodes
    (``native/stacker_io.cpp`` where libjpeg, libpng and libtiff are
    there, else the port's zlib reader ``csrc/image_io.cpp``) and fails,
    with both compilers' reasons, where neither builds;
23. sharpness at full width: the one-pass kernel (``csrc/sharpness.cu``,
    ``ops/sharpness_cuda.sharpness_sums``) on the grey of phase 5's burst
    (100x2160x3840 u8) and on its first 32 frames (the rank cell's
    burst), ms by CUDA events beside its bound
    (``stackbench/roofline/sharpness.py``) and the plain version's
    time on the card, device ms by ``torch.profiler``, launches a
    ``sharpness_all`` (2), peak memory, two runs bitwise equal, and its
    sums and metrics against the port's CPU path on the first 4 frames
    (equal: u8 at ksize 3 sums exactly; the same TENG ranking);
24. the streams at full width: 24 frames of 2160x3840 (``make_burst``, a
    streak in frame 8) and phase 9's 20 textured frames written as PNGs
    under ``build/``, through ``ecc_match_stream`` (headline parameters,
    ``chunk_size=8``; mean and sigma-clip) and ``keypoint_match_stream``,
    each held against the whole-burst file entry point on the same files
    (ECC mean: interior max < 0.02; sigma-clip: within 1e-4 on > 0.999
    of values, max < 0.05; keypoint: interior p99 < 0.02, max < 0.2),
    with each stream's wall, the decode seconds on the host thread, the
    whole-burst wall, and the share of the host-to-device copies (from
    pinned memory) that ran under kernels by ``torch.profiler``; then an
    ECC stream killed after two chunks and resumed from its checkpoint,
    bitwise equal to the uninterrupted run; before the streams, the
    seconds per 4K PNG of one chunk decoded through the native library's
    pool and through PIL's thread pool, in turns (native, PIL, PIL,
    native), and of two files on one thread each, the two decodes
    bitwise equal;
25. the example workflow in process (``stack_burst.main``) on 6 textured
    frames of 2160x3840 with frame 3 blurred, headline ECC flags: the
    blurred frame ranked worst and dropped, keypoint dropping none, the
    four PNGs written; then the same frames as 48-bit PNGs (the 8-bit
    frames in the high byte, seeded noise in the low) with
    ``--preserve-depth --out-depth 16``: the same checks, four 16-bit
    PNGs, each within 0.02 of the 8-bit run's image in the interior;
26. ``mesh=`` at full width on shards of the one card
    (``parallel/mesh.py``), each case against the port's dense path at
    the JAX package's mesh bars: phase 5's burst over 3 shards (2 pad
    lanes; kept set equal, max abs 2e-4, and whether the sharded warps
    are the dense ones bitwise), ``mesh="auto"`` (one device), the
    streaked burst's sigma-clip over 4 shards (within 2e-4 on > 0.99 of
    values, max < 0.05), SR x2 of its first 8 frames over 4 (mean < 2e-4,
    0.999 quantile < 5e-3; B6's deposit form, never its image form), a
    one-process NCCL group (``init_distributed`` at world size 1,
    ``make_global_mesh``, ``shard_frames_global``, ``ecc_stack_step`` on 8
    frames, equal to the one-process mesh), phase 9's keypoint burst over
    4 (equal drops, mean < 5e-3, max < 0.06), the ECC mean stream over 4
    on phase 24's PNGs (phase 24's bar), and 4 row bands of the card:
    ``warp_rows_sharded`` on one 2160x3840x3 float32 frame (planar B5,
    bitwise the dense warp: each band's sources hold every tap it reads),
    ``sharpness_teng_spatial`` on 100 greys (data 2 x spatial 2, rel
    1e-5) and ``ecc_stack_step_spatial`` on 16 frames solved at 540x960
    (B5's accumulate form; interior max 1e-5 against the dense scaled
    path, p99 0.005 against the known shifts);
27. a mesh row across processes: two worker processes of this script
    (``--dcn-worker``), each with ``devices=["cuda:0"]`` under gloo, build
    ``make_global_mesh(data=1, spatial=2)`` (halo rows by point-to-point,
    the bands gathered over the row group) and run
    ``warp_rows_sharded`` on phase 26's 2160x3840x3 frame,
    ``sharpness_teng_spatial`` on the grey of the first 8 frames of phase
    5's burst and ``ecc_stack_step_spatial`` on those frames solved at
    540x960 (halo 64); each rank's results bitwise equal to the
    one-process ``make_mesh([card] * 2, data=1, spatial=2)`` run here,
    whose row warp is bitwise the dense warp,
    with each rank's launches of B1, B5 and B5a; a worker that fails or
    passes 180 s fails the phase;
28. the ECC solve's Gaussian pre-filter (``ecc_blur.cu``, run after
    phase 5 on its burst's grey): at ksize 5 on 99 and on 31 lanes of
    2160x3840, bitwise against its plain version (``filters.gaussian_blur``,
    the eager chain it replaced), timed against it, against its bound
    (read once, written once) and against a library yardstick (reflect
    pad and two separable ``F.conv2d`` with TF32 off, which the port
    never calls), with registers, spills and shared memory; then the
    99-lane 4K solve at the headline parameters and at the upstream's
    (5000 / 1e-5, no octave), two pre-filter launches a solved level,
    bitwise in warps, rho, ok and iterations against the same solve with
    the plain pre-filter;
29. RANSAC's refit kernels (``ransac_refit.cu``) on the refit inputs
    that phase 9's burst gives ``_match_and_estimate`` at full
    resolution (19 frames of 500 slots): the DLT and the polish against
    their plain versions run on the CPU in float64 (1e-3 px at a 4K
    frame's corners) and in float32 (0.01 px), the same bits on a second
    launch, and each kernel timed against its plain version on the card
    (the eager chain it replaced) and against its bound, with registers,
    spills and shared memory.

Phases 5, 9, 14-16, 19-22 and 24-27 drive the entry points with every
launch counter set to 0 just before the run and read just after it, and
fail if a kernel of that path was not launched; the keypoint phases also
fail if B3 (``orb_extract``) ran, and BORDER_REPLICATE if the planar B5
did.  Phases 23-27 print their own seconds.

Each kernel record carries its time (CUDA events around a batch of
calls; for B3, B3h and B3d, whose kernels are shorter than their
wrappers' host time, the device time ``torch.profiler`` reads), its
plain version's time, the bound of the same work at the card's published rates (bytes
over 3.35 TB/s, operations over 67 T/s, the larger of the two) and the
time of one PyTorch call computing the same function where one exists.
Phases 2, 3, 6, 7, 10, 11, 13 and 17 also print the registers and
spills that ptxas gave each instance of B1, B2, B8, B3 / B3h / B3d, B4,
B5 and B7, the kernel's share of its bound; phases 12 and 18 print B9's
and B6's too, phase 28 the pre-filter's, phase 29 the refit's.  Phase 3
also holds B2 and B4 (both passes) bitwise to their plain versions on 99
u8 frames of 4000x6000 with affine maps, and times them.
The last two lines are the kernel record and the device record (JSON).
The script needs CUDA and the repository beside it; without either it
exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
KERNELS = ("ecc_moments", "warp_accum", "fast", "orb_extract", "warp",
           "ecc_ic_moments", "sr_deposit", "orb_describe", "ecc_blur",
           "ransac_refit", "sharpness")
# pixels a thread of warp_accum.cu's B2 and B4 and of warp.cu's planar
# B5, accumulate and frames forms (a SASS loop iteration; B5f's whole
# body)
B2_PIXELS, B4_PIXELS, B5_PIXELS, B5A_PIXELS, B5F_PIXELS = 4, 2, 4, 2, 4
# mangled-name pieces of the instances whose registers are printed
B1_INSTANCE = "moments_kernelILi8ELb1ELb0E"  # P=8, Gram, 3 planes
B1M_INSTANCE = "moments_kernelILi8ELb1ELb1E"  # P=8, Gram, masked
B1_LITE_INSTANCE = "moments_kernelILi8ELb0ELb0E"  # P=8, no Gram
B7_INSTANCE = "ic_moments_kernelILi8ELb0E"  # P=8, no Gram
B7_GRAM_INSTANCE = "ic_moments_kernelILi8ELb1E"
B8_INSTANCE = "fast_kernelIhE"  # u8 source
B2_INSTANCE = "warp_accum_kernelIhLb1EE"  # u8 source, homography
B4_INSTANCE = "warp_moments_kernelIhLb1ELb1EE"  # u8, homography, clip pass
B4M_INSTANCE = "warp_moments_kernelIhLb1ELb0EE"  # u8, homography, moments
B2_AFFINE_INSTANCE = "warp_accum_kernelIhLb0EE"  # u8 source, affine
# planar B5 in its timed modes (homography)
B5_INSTANCES = {"constant": "11warp_kernelILi0ELb1EE",
                "replicate": "11warp_kernelILi1ELb1EE",
                "wrap": "11warp_kernelILi3ELb1EE"}
# the frames and accumulate forms for u8 RGB frames in border mode {}
# (homography)
B5F_INSTANCE = "frames_kernelILi{}EhLb1ELi3EE"
B5A_INSTANCE = "accum_kernelILi{}EhLb1ELi3EE"


B3_INSTANCE = "extract_kernelIhE"
B3H_INSTANCE = "select_kernelILb0E"  # the words in shared memory
B3D_INSTANCE = "describe_kernel"
B9_INSTANCE = "warp3_kernel"
# u8, 32-bit offsets, homography, no fallback: deposit and image forms
B6_INSTANCE = "sr_kernelIhiLb1ELb0ELb0E"
B6I_INSTANCE = "sr_kernelIhiLb1ELb0ELb1E"
BLUR_INSTANCE = "blur_kernelILi2E"  # the pre-filter at ksize 5
SHARP_INSTANCE = "sharpness_kernelIhLi3EE"  # u8 grey, TENG at ksize 3

# headline configuration (bench.py:181-290): 100 frames of 4K
FULL_N, FULL_H, FULL_W = 100, 2160, 3840
# phase 3's affine frames: 24 MP, wider than 2^12 px
WIDE_H, WIDE_W = 4000, 6000
SLICE_N, SLICE_H, SLICE_W = 8, 1080, 1920
# keypoint bench configuration (bench.py:499-560,
# benchmarks/bench_keypoint.py:19-45): 20 textured frames of 4K
KP_N = 20
KP_SLICE_N, KP_SLICE_H, KP_SLICE_W = 4, 540, 960
KP_K, KP_RADIUS, KP_T, KP_B = 218, 21, 20, 31  # level 0: 2 x quota 109
KP_Q = KP_K // 2
# the kernels see frames 1..N-1 of the burst on the main path
KERNEL_LANES = FULL_N - 1
KERNEL_FRAMES = FULL_N - 1

# bars (bench.py:166-167, tests/test_ecc_pallas.py:176-178,
# tests/test_pipeline_ecc.py:73-74)
MOMENT_REL_BAR = 1e-4
WARP_ATOL = 0.03
STACK_MAX_BAR = 0.02
RHO_BAR = 0.99
FRAME0_MEAN_BAR = 0.01
# tests/test_pipeline_keypoint.py:76: p99 of |stack - truth stack| at
# full resolution.  That file's scaled bar (0.08, :92) is for a 1.6x
# reduction of 240x320; the 2.7x reduction of 4K misaligns more, in the
# JAX package as in the port (PERF.md), so phase 9 holds the scaled run
# to its corner bar and prints its p99
KP_P99_BAR = 0.04
CORNER_BAR = 0.5
# phase 29, px at a 4K frame's corners (tests/test_torch_ransac_refit.py):
# the float64 kernels against their plain versions in float64, and in
# float32, the path's own arithmetic before the kernels
REFIT_BAR64, REFIT_BAR32 = 1e-3, 0.01

# published H100 SXM rates (NVIDIA H100 datasheet): HBM bytes/s and
# float32 operations/s outside the tensor cores (also used for B8's
# integer min/max, which issue at no higher rate)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# operations per pixel-lane of B1 (homography, with the Hessian) and per
# pixel-frame of B2, counted off csrc/ecc_moments.cu and
# csrc/warp_accum.cu: coordinates ~15, 1/32 quantisation ~12, bilinear
# taps ~10 a plane; B1 adds the Jacobian ~16 and 6 + 3P + P(P+1)/2 = 66
# multiply-add pairs; B2 adds the 3 widened channels' sums
B1_OPS = 15 + 12 + 3 * 10 + 4 + 16 + 2 * 66
B2_OPS = 15 + 12 + 8 + 3 * 10 + 3 * 4 + 3 * 2
# B8 per pixel: 16 differences, the 4-point compass test, the NMS max
# of 8 and its compare; per candidate passing the compass test: the two
# arc trees (16 + 16 + 32 mins and 15 maxes each) and 16 negations
B8_OPS_PIXEL = 16 + 8 + 9
B8_OPS_CANDIDATE = 2 * (16 + 16 + 32 + 15) + 16
# B4 per pixel-frame, counted off csrc/warp_accum.cu: coordinates,
# quantisation and the coverage test for every frame; for the covered
# frames B2's taps and channels plus the three moment sums and, in the
# clip pass, the per-channel clip test
B4_OPS_ANY = 15 + 12 + 6
B4_OPS_COVERED = 8 + 3 * 10 + 3 * 4 + 3 * 5
B4_OPS_CLIP = 3 * 4
# B5 per output value and B9 per output pixel-lane (csrc/warp.cu):
# coordinates, quantisation, the border test or index map, the lerp
B5_OPS = 15 + 12 + 8 + 10
B9_OPS = 15 + 12 + 8 + 3 * 10
# B5's frames / accumulate forms per pixel-frame: the coordinates,
# quantisation and tap map once, then per channel four widened taps and
# the lerp (plus, accumulating, the weight and the sum)
B5F_OPS_PIXEL = 15 + 12 + 8
B5F_OPS_CHANNEL = 4 + 10
B5A_OPS_CHANNEL = B5F_OPS_CHANNEL + 2
# B3h per candidate (csrc/orb_describe.cu): 49 block positions of 6
# differences, two Sobel sums of 3 and three multiply-adds; the response
# and its sort word; per compare-exchange of the selection's bitonic
# sort (b3h_ops) a 64-bit compare and two selects.  B3d per keypoint:
# the IC moments (2 multiply-adds a circle pixel), the 7-tap blur of
# 37x43 then 37x37 values, the angle, and per descriptor bit two
# steered taps and a compare
B3H_OPS = 49 * (6 + 6 + 6) + 8 + 4
B3H_OPS_COMPARE = 4
B3D_OPS_CIRCLE_PIXEL = 4
B3D_OPS_BLUR = (37 * 43 + 37 * 37) * 13
B3D_OPS_BIT = 2 * (4 + 2 + 2 + 2) + 1
# B1 without the Gram: 6 + 3P = 30 sums for a homography.  B7 per
# pixel-lane (csrc/ecc_ic_moments.cu): coordinates, quantisation, the
# taps of one plane, the template's two differences, the Jacobian, and
# B1's sums (with or without the Gram)
B1_LITE_OPS = 15 + 12 + 3 * 10 + 4 + 16 + 2 * 30
B7_OPS = 15 + 12 + 10 + 4 + 16 + 2 * 66
B7_LITE_OPS = 15 + 12 + 10 + 4 + 16 + 2 * 30
# B6 per fine pixel-frame (csrc/sr_deposit.cu): the coordinate, its
# guarded reciprocal, rounding, the distance and the inside test; per
# deposited sample the exp, its divide, 3 widened channels and 4 sums;
# the image form's finalise per fine pixel: the max and 3 divides
B6_OPS_ANY = 28
B6_OPS_DEPOSIT = 12
B6_OPS_FINALISE = 4
SR_FRAMES = 8
# ECC / keypoint super-resolution bar (tests/test_stack.py:434-436): the
# 2x2 box mean of the SR image against the mean stack, interior mean abs
SR_BOX_BAR = 0.02
# the opt-in solvers against phase 5's forward stack, interior p99
# (tests/test_pipeline_ecc.py:110-111, :140-141)
SOLVER_P99_BAR = 0.02

# sigma-clip phase (tests/test_stack.py:127-136): the streak's error
# under kappa-sigma against the mean stack's, and away from the streak
SIGMA_STREAK_RATIO = 0.25
SIGMA_FAR_BAR = 0.01
STREAK_FRAMES = (7, 41, 83)


def b3h_ops(n: int, k: int) -> float:
    """B3h's operations on ``n`` frames of ``k`` candidates: the
    responses, and the compare-exchanges of a bitonic sort over the next
    power of two, ``n2 / 2 * s (s + 1) / 2`` for ``n2 = 2^s``."""
    s = max(k - 1, 0).bit_length()
    compares = (1 << s) // 2 * s * (s + 1) // 2
    return float(n) * (k * B3H_OPS + compares * B3H_OPS_COMPARE)


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the least time at the published rates."""
    t_b, t_o = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def log(line: str) -> None:
    print(line, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up
    (CUDA events around the batch)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def smoothed_image(rng, h, w, sigma=2.0):
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(rng.random((h, w)).astype(np.float32) * 255.0, sigma)


def near_identity_homographies(rng, b, h, w):
    """``b`` inverse maps: rotations up to 0.6 deg about the centre,
    shifts up to 6 px, a small perspective term."""
    mats = []
    for _ in range(b):
        ang = np.radians(rng.uniform(-0.6, 0.6))
        c, s = np.cos(ang), np.sin(ang)
        cx, cy = w / 2.0, h / 2.0
        dx, dy = rng.uniform(-6.0, 6.0, 2)
        m = np.array([
            [c, -s, cx - c * cx + s * cy + dx],
            [s, c, cy - s * cx - c * cy + dy],
            [rng.uniform(-2e-6, 2e-6), rng.uniform(-2e-6, 2e-6), 1.0],
        ])
        mats.append(m)
    return np.stack(mats).astype(np.float32)


def group_rel(got, want, p, with_hessian=True):
    """Max over lanes of the norm-relative error of each moment group
    (the 6 statistics one by one, then S(j*i), S(j*m), S(j*m*t), H)."""
    bounds = [(k, k + 1) for k in range(6)]
    bounds += [(6, 6 + p), (6 + p, 6 + 2 * p), (6 + 2 * p, 6 + 3 * p)]
    if with_hessian:
        bounds.append((6 + 3 * p, got.shape[1]))
    worst = 0.0
    for lo, hi in bounds:
        err = np.abs(got[:, lo:hi] - want[:, lo:hi]).max(axis=1)
        scale = np.abs(want[:, lo:hi]).max(axis=1) + 1e-6
        worst = max(worst, float((err / scale).max()))
    return worst


def counters():
    """Each kernel's launch counter: name -> (module, attribute)."""
    from libstacker_tpu_torch.ops import (
        ecc_cuda, fast_cuda, orb_cuda, ransac_cuda, sharpness_cuda, sr_cuda,
        warp_accum_cuda, warp_cuda,
    )

    return {
        "ecc_moments": (ecc_cuda, "launch_count"),
        "ecc_moments_lite": (ecc_cuda, "lite_launch_count"),
        "ecc_moments_masked": (ecc_cuda, "masked_launch_count"),
        "ecc_ic_moments": (ecc_cuda, "ic_launch_count"),
        "ecc_blur": (ecc_cuda, "blur_launch_count"),
        "sr_deposit": (sr_cuda, "launch_count"),
        "sr_image": (sr_cuda, "image_launch_count"),
        "warp_accum": (warp_accum_cuda, "launch_count"),
        "warp_moments": (warp_accum_cuda, "moments_launch_count"),
        "fast": (fast_cuda, "launch_count"),
        "orb_extract": (orb_cuda, "launch_count"),
        "orb_harris": (orb_cuda, "harris_launch_count"),
        "orb_describe": (orb_cuda, "describe_launch_count"),
        "warp": (warp_cuda, "launch_count"),
        "warp_frames": (warp_cuda, "frames_launch_count"),
        "warp_frames_accum": (warp_cuda, "accum_launch_count"),
        "warp3": (warp_cuda, "warp3_launch_count"),
        "ransac_dlt": (ransac_cuda, "dlt_launch_count"),
        "ransac_refine": (ransac_cuda, "refine_launch_count"),
        "sharpness": (sharpness_cuda, "launch_count"),
    }


def reset_counts() -> None:
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in counters().items()}


def drive(fn):
    """Run an entry point cold, then warm with every launch counter set
    to 0 just before and read just after -> (result, cold_s, warm_s,
    launches)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    return result, cold_s, warm_s, read_counts()


def missing(launches: dict, names) -> list:
    """The kernels of a path that its run did not launch."""
    return [k for k in names if launches[k] == 0]


# every keypoint path detects through B8, B3h and B3d, never B3
KP_DETECT = ("fast", "orb_harris", "orb_describe")
# and refits its RANSAC inliers through the DLT and polish kernels
KP_REFIT = ("ransac_dlt", "ransac_refine")


def stray(launches: dict, names=("orb_extract",)) -> list:
    """The kernels a path must no longer launch that its run launched."""
    return [k for k in names if launches[k] != 0]


def device_profile(fn, piece: str = "", reps: int = 10):
    """``(operations, device ms, ms of the kernels named with piece)``
    per ``fn()`` call, from ``torch.profiler`` over ``reps`` calls: the
    device's own time, which a CUDA-event loop around a kernel shorter
    than its wrapper's host time cannot see.  The trace opens with one
    call that is not counted (the tracer may lose its first operation)
    and counts the device operations that start inside a host range
    around the ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):  # a trace that came back empty is taken again
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
            with torch.profiler.record_function("device_profile"):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        start = min(ev.time_range.start for ev in prof.events()
                    if ev.name == "device_profile")
        evs = [ev for ev in prof.events()
               if ev.device_type == cuda and ev.name != "device_profile"
               and ev.time_range.start >= start]
        named = sum(ev.time_range.elapsed_us() for ev in evs
                    if piece and piece in ev.name)
        if evs and (named or not piece):
            break
    else:
        ms = time_ms(fn, reps)
        log(f"    torch.profiler did not record {piece or 'the operations'} "
            f"three times; CUDA events instead: {ms:.4f} ms a call")
        return None, ms, ms
    total = sum(ev.time_range.elapsed_us() for ev in evs)
    return round(len(evs) / reps), total / reps / 1e3, named / reps / 1e3


def resources(name: str, piece: str) -> dict:
    """ptxas's registers and spills of the kernel of build ``name`` whose
    mangled name contains ``piece`` ({} if the report is missing)."""
    from libstacker_tpu_torch.utils import cuda_build

    found = cuda_build.kernel_resources(name)
    return next((v for k, v in found.items() if piece in k), {})


def sass_line(label: str, name: str, piece: str, pixels: int = 1,
              homography: bool = True, whole: bool = False,
              longest: bool = True):
    """Print the instructions a pixel-frame by class of the frame loop of
    the kernel of build ``name`` whose mangled name contains ``piece``
    (``utils/sass.py``; ``pixels`` a loop iteration, ``homography`` False
    for the path with no MUFU, ``whole`` for a path through a kernel's
    whole body: the longest, or with ``longest`` False the main one);
    return them (None where cuobjdump is missing)."""
    from libstacker_tpu_torch.utils import cuda_build, sass

    lib = cuda_build.library_path(name)
    try:
        found = sass.kernel_loop(lib, piece, pixels, homography, whole,
                                 longest)
    except (RuntimeError, subprocess.CalledProcessError) as e:
        log(f"    {label} SASS: not read ({e})")
        return None
    log(f"    {label} SASS: {sass.fmt(found)}")
    if not found:
        return None
    return dict(per_pixel_frame=found["per_pixel"],
                total=found["per_pixel_total"], pixels_a_thread=pixels,
                mufu=found["mufu"])


def fmt_resources(r: dict) -> str:
    if not r:
        return "no ptxas report"
    return (f"{r['registers']} registers, {r.get('smem', 0)} B shared, "
            f"spill stores/loads {r.get('spill_stores', 0)}/"
            f"{r.get('spill_loads', 0)} B")


def paired_ms(fn, other, reps: int, timer=None):
    """(ms, other_ms): ``fn`` and ``other`` timed in turns (fn, other,
    other, fn), each the mean of its two; ``timer(fn, reps)`` times one
    (CUDA events by default)."""
    timer = timer or time_ms
    a, b = timer(fn, reps), timer(other, reps)
    c, d = timer(other, reps), timer(fn, reps)
    return (a + d) / 2.0, (b + c) / 2.0


def design_report(label: str, name: str, piece: str, ms: float,
                  bound_ms: float) -> dict:
    """Print one line on an instance's registers, spills, shared memory
    and bound share; return them for the kernel record."""
    res = resources(name, piece)
    line = (f"    {label}: {fmt_resources(res)}; {ms:.4f} ms, "
            f"{bound_ms / ms:.3f} of its bound")
    rec = dict(registers=res.get("registers"), smem_bytes=res.get("smem"),
               spill_bytes=res.get("spill_stores", 0) + res.get("spill_loads", 0)
               if res else None)
    log(line)
    return rec


def profile_line(label: str, fn, piece: str) -> dict:
    """Print ``fn``'s device operations, device ms and the ms of the
    kernels named with ``piece`` per call (``torch.profiler``); return
    them for the kernel record."""
    ops, dev_ms, named_ms = device_profile(fn, piece)
    log(f"    {label}: {ops} device operations, {dev_ms:.4f} ms of device "
        f"time a call, {named_ms:.4f} ms in {piece}")
    return dict(device_ops=ops, device_ms=dev_ms, kernel_device_ms=named_ms)


def phase_device():
    from libstacker_tpu_torch.utils import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.perf_counter()
    cuda_build.build(*KERNELS)
    for name in KERNELS:
        cuda_build.load(name)
    build_s = time.perf_counter() - t0
    regs = []
    for name in KERNELS:
        for line in cuda_build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                regs.append(f"{name}: {line.strip()}")
    log(f"[1 device] {torch.cuda.get_device_name(0)} | torch "
        f"{torch.__version__} CUDA {torch.version.cuda} | kernels built "
        f"in {build_s:.2f} s (sm_90a, nvcc)")
    for line in regs:
        log(f"    ptxas {line}")
    return smi


def phase_b1(dev):
    from libstacker_tpu_torch.ops import ecc as ecc_ops, ecc_cuda
    from libstacker_tpu_torch.params import MotionType

    rng = np.random.default_rng(7)
    h, w, b = FULL_H, FULL_W, KERNEL_LANES
    img = torch.from_numpy(smoothed_image(rng, h, w)).to(dev)
    image_f, gx, gy = ecc_ops._input_fields(img, 5)
    srcs = torch.stack([image_f, gx, gy]).contiguous()
    tmpl = torch.from_numpy(smoothed_image(rng, h, w)).to(dev)
    tmpl = tmpl[None].repeat(b, 1, 1).contiguous()
    m3 = torch.from_numpy(near_identity_homographies(rng, b, h, w)).to(dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    active[b // 2] = False  # an inactive lane must give a zero row
    aff = m3[:1].clone()
    aff[:, 2] = torch.tensor([0.0, 0.0, 1.0], device=dev)

    tex = ecc_cuda.pack_texels(srcs)  # as the solver packs each level
    worst_rel = stats_rel = max_abs = 0.0
    for motion, mats, act in (
        (MotionType.Homography, m3, active),
        (MotionType.Affine, aff, None),
    ):
        kw = dict(quant_affine=motion != MotionType.Homography, active=act)
        got = ecc_cuda.ecc_iteration_moments(srcs, tmpl[: len(mats)], mats,
                                             motion, texels=tex, **kw)
        want = ecc_cuda.ecc_iteration_moments_reference(
            srcs, tmpl[: len(mats)], mats, motion, **kw)
        torch.cuda.synchronize()
        g = got.double().cpu().numpy()
        wnt = want.double().cpu().numpy()
        if act is not None and np.any(g[~act.cpu().numpy()] != 0.0):
            fail("B1: an inactive lane returned non-zero moments")
        p = motion.num_params
        stats_rel = max(stats_rel, float(
            (np.abs(g[:, :6] - wnt[:, :6]) / (np.abs(wnt[:, :6]) + 1e-6)).max()
        ))
        worst_rel = max(worst_rel, group_rel(g, wnt, p))
        max_abs = max(max_abs, float(np.abs(g - wnt).max()))
    hom = MotionType.Homography
    ms = time_ms(lambda: ecc_cuda.ecc_iteration_moments(srcs, tmpl, m3, hom,
                                                        texels=tex), 20)
    # the same sweep with 10 of the lanes active: what the blocks of the
    # 89 inactive lanes cost
    act10 = torch.zeros(b, dtype=torch.bool, device=dev)
    act10[:10] = True
    ms10 = time_ms(lambda: ecc_cuda.ecc_iteration_moments(
        srcs, tmpl, m3, hom, active=act10, texels=tex), 20)
    plain_ms = time_ms(lambda: ecc_cuda.ecc_iteration_moments_reference(
        srcs, tmpl, m3, hom), 2)
    torch.cuda.synchronize()
    bound_ms, bound_by = bound(4.0 * h * w * (3 + b) + 4.0 * b * 66,
                               float(b) * h * w * B1_OPS)
    ok = stats_rel < MOMENT_REL_BAR and worst_rel < MOMENT_REL_BAR
    log(f"[2 B1 ecc_moments] {b} homography lanes + 1 affine lane at "
        f"{h}x{w}: stats rel {stats_rel:.3e}, group-norm rel "
        f"{worst_rel:.3e} (bar {MOMENT_REL_BAR:g}), max abs {max_abs:.3e}; "
        f"kernel {ms:.3f} ms vs plain {plain_ms:.3f} ms for {b} lanes "
        f"({ms10:.3f} ms with 10 lanes active, {10 / b * ms:.3f} pro rata), "
        f"bound {bound_ms:.3f} ms ({bound_by}) "
        f"-> {'OK' if ok else 'MISMATCH'}")
    if not ok:
        fail("B1 disagrees with its plain version")
    rec = design_report("B1 P=8 with the Gram", "ecc_moments", B1_INSTANCE,
                        ms, bound_ms)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                ms_10_lanes_active=ms10, **rec)


def rotation_maps(b, h, w, deg):
    """``b`` inverse maps rotating by +-``deg`` about the centre."""
    mats = []
    for i in range(b):
        a = np.radians(deg if i % 2 else -deg)
        c, s = np.cos(a), np.sin(a)
        cx, cy = w / 2.0, h / 2.0
        mats.append([[c, -s, cx - c * cx + s * cy],
                     [s, c, cy - s * cx - c * cy], [0.0, 0.0, 1.0]])
    return np.asarray(mats, np.float32)


def phase_b2(dev):
    from libstacker_tpu_torch.ops import color, warp, warp_accum_cuda
    from libstacker_tpu_torch.utils.synth import make_burst

    n = KERNEL_FRAMES
    frames, truth = make_burst(n, FULL_H, FULL_W, seed=3, device=dev)
    minv = warp.invert_3x3(torch.from_numpy(truth).float().to(dev))
    minv = minv.contiguous()
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[n // 2] = False
    got = warp_accum_cuda.warp_accum_rgb(frames, minv, valid)
    want = warp_accum_cuda.warp_accum_rgb_reference(frames, minv, valid)
    got_f32 = warp_accum_cuda.warp_accum_rgb(
        color.to_unit_f32(frames), minv, valid)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    u8_f32 = float((got - got_f32).abs().max())
    del got_f32
    # 4 frames rotated by 30 degrees: taps far from the output pixel
    rot = torch.from_numpy(rotation_maps(4, FULL_H, FULL_W, 30.0)).to(dev)
    rvalid = torch.ones(4, dtype=torch.bool, device=dev)
    rot_got = warp_accum_cuda.warp_accum_rgb(frames[:4], rot, rvalid)
    rot_want = warp_accum_cuda.warp_accum_rgb_reference(frames[:4], rot,
                                                        rvalid)
    torch.cuda.synchronize()
    rot_abs = float((rot_got - rot_want).abs().max())
    del rot_got, rot_want
    ms = time_ms(lambda: warp_accum_cuda.warp_accum_rgb(frames, minv, valid),
                 20)
    plain_ms = time_ms(
        lambda: warp_accum_cuda.warp_accum_rgb_reference(frames, minv, valid), 2)
    hw = FULL_H * FULL_W
    bound_ms, bound_by = bound((n - 1) * hw * 3.0 + hw * 3 * 4.0 + n * 40.0,
                               float(n - 1) * hw * B2_OPS)
    ok = max_abs == 0.0 and u8_f32 == 0.0 and rot_abs == 0.0
    log(f"[3 B2 warp_accum] {n} u8 frames of {FULL_H}x{FULL_W} (one "
        f"dropped): max abs {max_abs:.3e} (bar 0), u8 vs f32 source "
        f"{u8_f32:.1e} (bar 0), 4 frames rotated 30 degrees max abs "
        f"{rot_abs:.1e} (bar 0); kernel {ms:.3f} ms vs plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}) "
        f"-> {'OK' if ok else 'MISMATCH'}")
    if not ok:
        fail("B2 disagrees with its plain version")
    rec = design_report("B2 u8", "warp_accum", B2_INSTANCE, ms, bound_ms)
    rec["sass"] = sass_line("B2 u8", "warp_accum", B2_INSTANCE,
                            pixels=B2_PIXELS)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None, **rec)


def phase_wide_affine(dev):
    """B2 and B4 (moments and clip pass) on 99 u8 frames of WIDE_HxWIDE_W
    with affine maps (the ECC path's Translation / Euclidean / Affine
    motion, quant_affine=True): bitwise against their plain versions, and
    timed; returns the record phase 3 carries."""
    from libstacker_tpu_torch.ops import stack, warp_accum_cuda

    n, h, w = KERNEL_FRAMES, WIDE_H, WIDE_W
    gen = torch.Generator(device=dev).manual_seed(13)
    frames = torch.randint(0, 256, (n, h, w, 3), generator=gen, device=dev,
                           dtype=torch.uint8)
    rng = np.random.default_rng(13)
    mats = []
    for _ in range(n):  # burst-like: +-0.6 degrees, +-6 px
        a = np.radians(rng.uniform(-0.6, 0.6))
        dx, dy = rng.uniform(-6.0, 6.0, 2)
        c, s = np.cos(a), np.sin(a)
        cx, cy = w / 2.0, h / 2.0
        mats.append([[c, -s, cx - c * cx + s * cy + dx],
                     [s, c, cy - s * cx - c * cy + dy], [0.0, 0.0, 1.0]])
    minv = torch.from_numpy(np.asarray(mats, np.float32)).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[n // 2] = False

    def b2():
        return warp_accum_cuda.warp_accum_rgb(frames, minv, valid,
                                              quant_affine=True)

    def moments():
        return warp_accum_cuda.warp_moments_rgb(frames, minv, valid,
                                                quant_affine=True)

    mom = moments()
    denom = torch.clamp(mom[0], min=1.0)
    mu = mom[1] / denom
    var = torch.clamp(mom[2] / denom - mu * mu, min=0.0)
    tol = (2.5 * torch.sqrt(var) + stack._CLIP_TOL).contiguous()
    mu = mu.contiguous()

    def clip():
        return warp_accum_cuda.warp_moments_rgb(frames, minv, valid, mu, tol,
                                                quant_affine=True)

    got = (b2(),) + mom + clip()
    want = ((warp_accum_cuda.warp_accum_rgb_reference(
        frames, minv, valid, quant_affine=True),)
        + warp_accum_cuda.warp_moments_rgb_reference(
            frames, minv, valid, quant_affine=True)
        + warp_accum_cuda.warp_moments_rgb_reference(
            frames, minv, valid, mu, tol, quant_affine=True))
    torch.cuda.synchronize()
    bitwise = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    max_abs = max(float((a - b).abs().max()) for a, b in zip(got, want))
    hw = h * w
    covered = float(want[1][..., 0].sum())
    clip_bound, _, moments_bound = b4_bounds(n, hw, covered)
    b2_bound, _ = bound((n - 1) * hw * 3.0 + hw * 3 * 4.0 + n * 40.0,
                        float(n - 1) * hw * B2_OPS)
    rec = {}
    line = (f"[3 B2/B4 affine] {n} u8 frames of {h}x{w}, affine maps (one "
            f"dropped): B2, B4 moments and clip pass bitwise {bitwise} (max "
            f"abs {max_abs:.1e}, bar 0)")
    for key, fn, reps, bnd in (("b2", b2, 10, b2_bound),
                               ("moments", moments, 5, moments_bound),
                               ("clip", clip, 5, clip_bound)):
        ms = time_ms(fn, reps)
        rec[key] = dict(ms=ms, bound_ms=bnd)
        line += f"; {key} {ms:.3f} ms, {bnd / ms:.3f} of its bound"
    log(line + f" -> {'OK' if bitwise else 'MISMATCH'}")
    if not bitwise:
        fail("B2 / B4 disagree with their plain versions on the affine frames")
    rec["sass"] = sass_line("B2 u8 affine", "warp_accum", B2_AFFINE_INSTANCE,
                            pixels=B2_PIXELS)
    return rec


def headline_params():
    from libstacker_tpu_torch import EccMatchParameters, MotionType

    return EccMatchParameters(
        motion_type=MotionType.Homography, max_count=50, epsilon=1e-4,
        gauss_filt_size=5, coarse_levels=1,
    )


def phase_slice_parity(dev):
    """The slice's stages on CUDA and on the CPU from one u8 burst."""
    from libstacker_tpu_torch.ops import ecc as ecc_ops, phasecorr
    from libstacker_tpu_torch.ops import color, warp_batch
    from libstacker_tpu_torch.utils.synth import make_burst

    params = headline_params()
    frames, _ = make_burst(SLICE_N, SLICE_H, SLICE_W, seed=5, device=dev)
    frames_np = frames.cpu().numpy()

    def run(device):
        f = torch.from_numpy(frames_np).to(device)
        grey = color.burst_grey_u8(f).to(torch.float32)
        init = phasecorr.phase_init_warps(grey[1:], grey[0],
                                          params.motion_type)
        res = ecc_ops.find_transform_ecc_batched(
            grey[1:], grey[0], params.motion_type, 50, 1e-4, 5,
            coarse_levels=1, warp_init=init,
        )
        stack = warp_batch.warp_sum_burst(
            f, res.warp_matrix, res.ok, perspective=True) / SLICE_N
        return (res.warp_matrix.cpu().numpy(), res.ok.cpu().numpy(),
                stack.cpu().numpy())

    t0 = time.perf_counter()
    w_cpu, ok_cpu, out_cpu = run("cpu")
    cpu_s = time.perf_counter() - t0
    w_gpu, ok_gpu, out_gpu = run(dev)
    torch.cuda.synchronize()
    warp_diff = float(np.abs(w_gpu - w_cpu).max())
    c = 16
    stack_diff = float(np.abs(out_gpu[c:-c, c:-c] - out_cpu[c:-c, c:-c]).max())
    ok = (np.array_equal(ok_cpu, ok_gpu) and warp_diff < WARP_ATOL
          and stack_diff < STACK_MAX_BAR)
    log(f"[4 slice parity] {SLICE_N}x{SLICE_H}x{SLICE_W}, CUDA vs the "
        f"port's CPU path ({cpu_s:.1f} s on the CPU): ok flags equal "
        f"{np.array_equal(ok_cpu, ok_gpu)}, warp max diff {warp_diff:.2e} "
        f"(bar {WARP_ATOL}), stack interior max diff {stack_diff:.2e} "
        f"(bar {STACK_MAX_BAR}) -> {'OK' if ok else 'MISMATCH'}")
    if not ok:
        fail("the CUDA slice disagrees with the CPU slice")


def phase_full(dev):
    from libstacker_tpu_torch import ecc_match_arrays
    from libstacker_tpu_torch.utils.synth import make_burst

    params = headline_params()
    frames, truth = make_burst(FULL_N, FULL_H, FULL_W, seed=0, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ecc_match_arrays(frames, params, device_output=True)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, stats = ecc_match_arrays(frames, params, return_stats=True,
                                  device_output=True)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = read_counts()

    iters = np.asarray(stats.ecc_iterations)
    rho = np.asarray(stats.ecc_rho)
    c = 64
    ref0 = frames[0].float() / 255.0
    f0_diff = float((out[c:-c, c:-c] - ref0[c:-c, c:-c]).abs().mean())
    finite = bool(torch.isfinite(out).all())
    splits = ", ".join(f"{k} {v:.1f}" for k, v in stats.phase_ms.items())
    ok = (stats.frames_kept == FULL_N and float(rho.mean()) >= RHO_BAR
          and f0_diff < FRAME0_MEAN_BAR and finite
          and tuple(out.shape) == (FULL_H, FULL_W, 3)
          and launches["ecc_blur"] == 2 * 2  # 2 levels: templates, input
          and not missing(launches, ("ecc_moments", "warp_accum")))
    log(f"[5 full slice] {FULL_N}x{FULL_H}x{FULL_W} u8, homography, "
        f"coarse_levels=1: cold {cold_s:.3f} s, warm {warm_s:.3f} s = "
        f"{FULL_N / warm_s:.2f} frames/s | stages ms: {splits} | iters "
        f"(full-res) mean {iters.mean():.2f} max {iters.max()} | mean rho "
        f"{rho.mean():.5f} | kept {stats.frames_kept}/{FULL_N} | stack vs "
        f"frame 0 mean abs {f0_diff:.2e} | launches {launches} -> "
        f"{'OK' if ok else 'FAILED'}")
    if not ok:
        fail("the full-size slice missed a bar")
    return launches, frames, truth, out


def phase_blur(dev, frames):
    """Phase 28: the ECC solve's Gaussian pre-filter at ksize 5 on 99
    and 31 lanes of phase 5's 4K grey, then the 99-lane solve through it
    against the same solve with the plain pre-filter."""
    import torch.nn.functional as F

    from libstacker_tpu_torch.ops import color
    from libstacker_tpu_torch.ops import ecc as ecc_ops, ecc_cuda, filters
    from libstacker_tpu_torch.params import MotionType

    grey = color.burst_grey_u8(frames).to(torch.float32)
    ksize, r = 5, 2
    taps = torch.tensor(filters.gaussian_kernel(ksize), dtype=torch.float32,
                        device=dev)

    def library(x):
        p = F.pad(x[:, None], (r, r, r, r), mode="reflect")
        return F.conv2d(F.conv2d(p, taps.view(1, 1, 1, -1)),
                        taps.view(1, 1, -1, 1))[:, 0]

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    recs = {}
    try:
        for lanes in (KERNEL_LANES, 31):
            x = grey[1:1 + lanes].contiguous()
            got = ecc_cuda.gaussian_prefilter(x, ksize)
            want = filters.gaussian_blur(x, ksize)
            eq = bool(torch.equal(got.view(torch.int32),
                                  want.view(torch.int32)))
            lib_err = float((library(x) - want).abs().max())
            del got, want
            torch.cuda.empty_cache()
            ms = time_ms(lambda: ecc_cuda.gaussian_prefilter(x, ksize), 20)
            plain_ms = time_ms(lambda: filters.gaussian_blur(x, ksize), 3)
            lib_ms = time_ms(lambda: library(x), 5)
            # read once, written once; 4r+2 multiplies and 4r adds a pixel
            b_ms, b_by = bound(x.numel() * 8.0, x.numel() * (8.0 * r + 2))
            log(f"[28 ECC pre-filter] {lanes}x{FULL_H}x{FULL_W} f32, "
                f"ksize {ksize}: bitwise equal to the plain version {eq}; "
                f"kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                f"{b_ms / ms:.3f} of it); plain chain {plain_ms:.4f} ms; "
                f"library (reflect pad + 2 F.conv2d, TF32 off) "
                f"{lib_ms:.4f} ms, max abs {lib_err:.3e} off the plain "
                f"version")
            if not eq:
                fail("the pre-filter kernel disagrees with its plain version")
            recs[lanes] = dict(
                bitwise_equal=eq, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, library_max_abs_err=lib_err,
                bound_ms=b_ms, bound_by=b_by,
                **design_report(f"pre-filter {lanes} lanes", "ecc_blur",
                                BLUR_INSTANCE, ms, b_ms))
            del x
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32

    # the 99-lane solve through the kernel, then with the plain
    # pre-filter in its place
    templates, image = grey[1:], grey[0]
    solves = {}
    for label, kw in (("headline", dict(num_iters=50, eps=1e-4,
                                        coarse_levels=1)),
                      ("upstream", dict(num_iters=5000, eps=1e-5,
                                        coarse_levels=0))):
        def solve():
            return ecc_ops.find_transform_ecc_batched(
                templates, image, MotionType.Homography, gauss_filt_size=5,
                **kw)

        reset_counts()
        got = solve()
        torch.cuda.synchronize()
        launches = read_counts()["ecc_blur"]
        kernel = ecc_cuda.gaussian_prefilter
        ecc_cuda.gaussian_prefilter = lambda x, k: filters.gaussian_blur(x, k)
        try:
            want = solve()
        finally:
            ecc_cuda.gaussian_prefilter = kernel
        same = all(bool(torch.equal(getattr(got, f), getattr(want, f)))
                   for f in ("warp_matrix", "rho", "ok", "num_iters"))
        ok = same and launches == 2 * (1 + kw["coarse_levels"])
        log(f"    {label} solve ({kw}): {launches} pre-filter launches, "
            f"iterations mean {got.num_iters.float().mean():.2f}; warps, "
            f"rho, ok and iterations bitwise those of the plain "
            f"pre-filter's solve {same} -> {'OK' if ok else 'FAILED'}")
        if not ok:
            fail(f"the {label} solve through the pre-filter kernel differs")
        solves[label] = dict(bitwise_equal=same, launches=launches)
    del grey, templates, image
    torch.cuda.empty_cache()
    rec = recs[KERNEL_LANES]
    rec["lanes_31"] = recs[31]
    rec["solves_bitwise"] = solves
    return rec


def textured_grey(dev):
    """The keypoint bench's burst (``utils/synth.make_textured_burst``)
    and its uint8 grey, as the keypoint path computes it."""
    from libstacker_tpu_torch.ops import color
    from libstacker_tpu_torch.utils.synth import make_textured_burst

    frames, truth = make_textured_burst(KP_N, FULL_H, FULL_W, seed=0,
                                        device=dev)
    return frames, truth, color.burst_grey_u8(frames)


def phase_b8(dev, grey):
    from libstacker_tpu_torch import constants
    from libstacker_tpu_torch.ops import fast_cuda, resize

    level1 = resize.resize(grey, (1800, 3200), constants.INTER_LINEAR)
    equal, kept = True, []
    for img in (grey, level1):
        got = fast_cuda.fast_scores(img, KP_T, KP_B)
        want = fast_cuda.fast_scores_reference(img, KP_T, KP_B)
        torch.cuda.synchronize()
        equal &= bool(torch.equal(got, want))
        kept.append(int((want > 0).sum()))
        del got, want
    ms = time_ms(lambda: fast_cuda.fast_scores(grey, KP_T, KP_B), 10)
    plain_ms = time_ms(
        lambda: fast_cuda.fast_scores_reference(grey, KP_T, KP_B), 2)
    # this run's data: every pixel runs the compass test, the pixels that
    # pass it (inside FAST's 3-px border) also run both arc trees
    n, h, w = grey.shape
    x = grey.to(torch.int16)
    c = x[:, 3:-3, 3:-3]
    comp = [x[:, 3 + dy : h - 3 + dy, 3 + dx : w - 3 + dx] - c
            for dx, dy in ((0, -3), (3, 0), (0, 3), (-3, 0))]
    nb = sum((e > KP_T).to(torch.int8) for e in comp)
    nd = sum((e < -KP_T).to(torch.int8) for e in comp)
    cand = int(((nb >= 2) | (nd >= 2)).sum())
    del x, c, comp, nb, nd
    bound_ms, bound_by = bound(n * h * w * 5.0, n * h * w * B8_OPS_PIXEL
                               + cand * B8_OPS_CANDIDATE)
    log(f"[6 B8 fast] {n} u8 frames of {h}x{w} and their 1800x3200 level "
        f"(t={KP_T}, b={KP_B}): bitwise equal {equal} (kept corners "
        f"{kept[0]} and {kept[1]}); kernel {ms:.3f} ms vs plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; "
        f"{cand / (n * h * w):.3f} of pixels pass the compass test) "
        f"-> {'OK' if equal else 'MISMATCH'}")
    if not equal:
        fail("B8 disagrees with its plain version")
    rec = design_report("B8 u8", "fast", B8_INSTANCE, ms, bound_ms)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
                compass_pass_share=cand / (n * h * w), **rec)


def window_bytes(grey, ys, xs, radius, offset=0, side=None):
    """Distinct level bytes that the clamped windows of ``(ys, xs)`` cover
    (``side`` x ``side`` from ``offset`` inside each ``2 radius + 1``
    window), the bytes a kernel must read at least once."""
    n, h, w = grey.shape
    full = 2 * radius + 1
    side = side or full
    offs = torch.arange(side, device=grey.device) + offset
    y0 = torch.clamp(ys.long() - radius, 0, h - full)
    x0 = torch.clamp(xs.long() - radius, 0, w - full)
    py = (y0[..., None, None] + offs[:, None]).expand(-1, -1, side, side)
    px = (x0[..., None, None] + offs[None, :]).expand(-1, -1, side, side)
    bi = torch.arange(n, device=grey.device)[:, None, None, None]
    touched = torch.zeros_like(grey, dtype=torch.bool)
    touched[bi.expand_as(py), py, px] = True
    return float(touched.sum())


def harris_f32(patch):
    """PR 6's ``fast.harris_from_patches``: the block sums in float32
    (the former route, timed against B3h)."""
    dx = patch[..., :, 2:] - patch[..., :, :-2]
    dy = patch[..., 2:, :] - patch[..., :-2, :]
    ix = 2.0 * dx[..., 1:-1, :] + dx[..., :-2, :] + dx[..., 2:, :]
    iy = 2.0 * dy[..., :, 1:-1] + dy[..., :, :-2] + dy[..., :, 2:]
    a = torch.sum(ix * ix, dim=(-2, -1))
    b = torch.sum(iy * iy, dim=(-2, -1))
    c = torch.sum(ix * iy, dim=(-2, -1))
    scale = 1.0 / (4.0 * 7 * 255.0)
    return (a * b - c * c - 0.04 * (a + b) ** 2) * (scale * scale * scale
                                                    * scale)


def phase_b3(dev, grey):
    from libstacker_tpu_torch.ops import fast, fast_cuda, orb, orb_cuda

    n, h, w = grey.shape
    score5 = fast_cuda.fast_scores(grey, KP_T, KP_B)
    cand = fast.top_k_keypoints(score5 > 0, score5, KP_K)
    ys, xs = cand.ys.contiguous(), cand.xs.contiguous()
    # centres at and beyond every clamp edge
    ys[:, :4] = torch.tensor([0, 5, h - 1, h + 7], dtype=torch.int32)
    xs[:, :4] = torch.tensor([w - 1, 0, 3, -9], dtype=torch.int32)
    got = orb_cuda.extract_patches(grey, ys, xs, KP_RADIUS)
    want = orb_cuda.extract_patches_reference(grey, ys, xs, KP_RADIUS)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    max_abs = float((got - want).abs().max())
    events_ms = time_ms(
        lambda: orb_cuda.extract_patches(grey, ys, xs, KP_RADIUS), 20)
    ms = device_profile(
        lambda: orb_cuda.extract_patches(grey, ys, xs, KP_RADIUS),
        "extract_kernel")[2]
    plain_ms = time_ms(
        lambda: orb_cuda.extract_patches_reference(grey, ys, xs, KP_RADIUS), 20)
    # the library call: one advanced-indexing gather of the same windows
    # (the plain version is that gather plus the index arithmetic and the
    # float32 cast)
    side = 2 * KP_RADIUS + 1
    offs = torch.arange(side, device=dev)
    y0 = torch.clamp(ys.long() - KP_RADIUS, 0, h - side)
    x0 = torch.clamp(xs.long() - KP_RADIUS, 0, w - side)
    py = y0[..., None, None] + offs[:, None]
    px = x0[..., None, None] + offs[None, :]
    bi = torch.arange(n, device=dev)[:, None, None, None]
    library_ms = time_ms(lambda: grey[bi, py, px], 20)
    in_bytes = window_bytes(grey, ys, xs, KP_RADIUS) + ys.numel() * 8.0
    bound_ms, bound_by = bound(in_bytes + got.numel() * 4.0, 0.0)
    del got, want
    log(f"[7 B3 orb_extract] {n} frames of {h}x{w}, K={KP_K}, radius "
        f"{KP_RADIUS} (4 centres at the clamp edges): bitwise equal "
        f"{equal}; kernel {ms:.4f} ms on the device ({events_ms:.4f} ms a "
        f"call, wrapper included) vs plain {plain_ms:.4f} ms, library "
        f"gather {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
        f"-> {'OK' if equal else 'MISMATCH'}")
    if not equal:
        fail("B3 disagrees with its plain version")
    b3 = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
              bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
              ms_source="torch.profiler device time", call_ms=events_ms,
              **design_report("B3 u8", "orb_extract", B3_INSTANCE, ms,
                              bound_ms))

    # B3h at the K candidates (two of them invalid a frame) with the
    # level's selection of Q, B3d at Q keypoints with the same clamp-edge
    # centres
    valid = cand.valid.clone()
    valid[:, 4:6] = False
    kq_ys, kq_xs = ys[:, :KP_Q].contiguous(), xs[:, :KP_Q].contiguous()

    def select():
        return orb_cuda.select_keypoints(grey, ys, xs, valid, KP_Q)

    sg = select()
    sw = orb_cuda.select_keypoints_reference(grey, ys, xs, valid, KP_Q)
    ag, dg = orb_cuda.describe(grey, kq_ys, kq_xs)
    aw, dw = orb_cuda.describe_reference(grey, kq_ys, kq_xs)
    torch.cuda.synchronize()
    eq_h = all(bool(torch.equal(a, b)) for a, b in zip(sg, sw))
    eq_d = bool(torch.equal(ag, aw)) and bool(torch.equal(dg, dw))
    fin = torch.isfinite(sw[0])
    h_err = max(float((sg[0][fin] - sw[0][fin]).abs().max()),
                float((sg[1] - sw[1]).abs().max()),
                float((sg[2] - sw[2]).abs().max()))
    a_err = float((ag - aw).abs().max())
    d_err = float((dg.int() - dw.int()).abs().max())
    del sg, sw, ag, aw, dg, dw
    h_call = time_ms(select, 20)
    h_plain = time_ms(
        lambda: orb_cuda.select_keypoints_reference(grey, ys, xs, valid,
                                                    KP_Q), 5)

    def kernel_ms(piece):
        return lambda fn, reps: device_profile(fn, piece, reps)[2]

    def selection_ms(fn, reps):
        return device_profile(fn, "", reps)[1]

    # B3h, and the device time of the whole selection
    h_ms = kernel_ms("select_kernel")(select, 10)
    sel_ms = selection_ms(select, 10)
    d_call = time_ms(lambda: orb_cuda.describe(grey, kq_ys, kq_xs), 20)
    d_ms = kernel_ms("describe_kernel")(
        lambda: orb_cuda.describe(grey, kq_ys, kq_xs), 10)
    d_plain = time_ms(
        lambda: orb_cuda.describe_reference(grey, kq_ys, kq_xs), 5)
    o = orb_cuda.HARRIS_ORIGIN
    h_bytes = (window_bytes(grey, ys, xs, KP_RADIUS, o, 9)
               + ys.numel() * (4.0 + 4.0 + 1.0) + n * KP_Q * 13.0)
    h_bound, h_by = bound(h_bytes, b3h_ops(n, KP_K))
    circle = sum(2 * u + 1 for u in orb_cuda._ic_umax()) * 2 - (
        2 * orb_cuda._ic_umax()[0] + 1)
    d_ops = (B3D_OPS_CIRCLE_PIXEL * circle + B3D_OPS_BLUR + 100
             + 256 * B3D_OPS_BIT)
    d_bytes = (window_bytes(grey, kq_ys, kq_xs, KP_RADIUS)
               + kq_ys.numel() * (8.0 + 4.0 + 32.0))
    d_bound, d_by = bound(d_bytes, kq_ys.numel() * float(d_ops))

    # the selection at nfeatures=5000's level 0 (K5 candidates, Q5 kept),
    # held bitwise to its plain version, timed as above
    q5 = orb._features_per_level(5000, 8, 1.2)[0]
    k5 = 2 * q5
    c5 = fast.top_k_keypoints(score5 > 0, score5, k5)
    del score5
    ys5, xs5, v5 = (c5.ys.contiguous(), c5.xs.contiguous(),
                    c5.valid.contiguous())
    sel5 = lambda: orb_cuda.select_keypoints(  # noqa: E731
        grey, ys5, xs5, v5, q5)
    eq5 = all(bool(torch.equal(a, b)) for a, b in zip(
        sel5(), orb_cuda.select_keypoints_reference(grey, ys5, xs5, v5, q5)))
    k5_ms = kernel_ms("select_kernel")(sel5, 10)
    sel5_ms = selection_ms(sel5, 10)
    b5_bound = bound(window_bytes(grey, ys5, xs5, KP_RADIUS, o, 9)
                     + ys5.numel() * 9.0 + n * q5 * 13.0, b3h_ops(n, k5))
    del c5, ys5, xs5, v5
    at5000 = dict(k=k5, quota=q5, bitwise_equal=eq5, ms=k5_ms,
                  selection_device_ms=sel5_ms,
                  bound_ms=b5_bound[0], bound_by=b5_bound[1])

    # the detector's per-level tail, each way, on the same candidates:
    # the patch route (B3 patches, then the eager chain), and B3h's
    # selection then B3d
    def former():
        patches = orb_cuda.extract_patches(grey, ys, xs, KP_RADIUS)
        hr = harris_f32(patches[..., o : o + 9, o : o + 9])
        hr = torch.where(valid, hr, torch.full_like(hr, -float("inf")))
        hval, hidx = fast.topk_stable(hr, KP_Q)
        kept = torch.gather(patches, 1, hidx[..., None, None].expand(
            -1, -1, side, side))
        ang = orb_cuda._ic_angles_from_patches(kept, center=KP_RADIUS)
        return hval, ang, orb_cuda._rbrief_from_patches(
            orb_cuda._blur_patches_valid(kept), ang)

    def current():
        hval, kys, kxs, _ = select()
        ang, desc = orb_cuda.describe(grey, kys, kxs)
        return hval, ang, desc

    route_old = time_ms(former, 20)
    route_new = time_ms(current, 20)
    route_old2 = time_ms(former, 20)
    n_old, dev_old, _ = device_profile(former)
    n_new, dev_new, _ = device_profile(current)
    ok = eq_h and eq_d and eq5
    log(f"[7 B3h orb_harris, B3d orb_describe] the same level: B3h's "
        f"selection of Q={KP_Q} at K={KP_K} (2 invalid a frame) bitwise "
        f"equal {eq_h}, at K={k5}, Q={q5} (nfeatures=5000) {eq5}; B3d at "
        f"Q={KP_Q} bitwise equal {eq_d} (max abs: Harris and indices "
        f"{h_err:.3e}, angle {a_err:.3e}, descriptor bytes {d_err:.0f}); "
        f"on the device B3h {h_ms:.4f} ms ({h_call:.4f} a call, the "
        f"selection's device time {sel_ms:.4f}) vs plain {h_plain:.4f}, "
        f"bound {h_bound:.4f} ms ({h_by}); at K={k5} {k5_ms:.4f} ms, "
        f"bound {b5_bound[0]:.4f} ms; B3d {d_ms:.4f} ms ({d_call:.4f} a "
        f"call) vs plain {d_plain:.4f}, bound {d_bound:.4f} ms ({d_by}); "
        f"per-level tail: B3 + eager chain "
        f"{(route_old + route_old2) / 2:.4f} ms a call, {dev_old:.4f} ms of "
        f"device time in {n_old} operations; B3h + B3d {route_new:.4f} ms "
        f"a call, {dev_new:.4f} ms in {n_new} "
        f"-> {'OK' if ok else 'MISMATCH'}")
    if not ok:
        fail("B3h or B3d disagrees with its plain version")
    route = dict(former_route_ms=(route_old + route_old2) / 2,
                 route_ms=route_new, former_route_device_ms=dev_old,
                 route_device_ms=dev_new, former_route_device_ops=n_old,
                 route_device_ops=n_new,
                 ms_source="torch.profiler device time")
    b3h = dict(max_abs_err=h_err, ms=h_ms, plain_ms=h_plain,
               bound_ms=h_bound, bound_by=h_by, library_ms=None,
               call_ms=h_call, selection_device_ms=sel_ms,
               nfeatures_5000=at5000,
               **design_report("B3h", "orb_describe", B3H_INSTANCE, h_ms,
                               h_bound),
               **route)
    b3d = dict(max_abs_err=max(a_err, d_err), ms=d_ms, plain_ms=d_plain,
               bound_ms=d_bound, bound_by=d_by, library_ms=None,
               call_ms=d_call,
               **design_report("B3d", "orb_describe", B3D_INSTANCE, d_ms,
                               d_bound), **route)
    # a thread's longest path with no MUFU (B3d's loops are unrolled: a
    # blurring thread's whole work)
    b3d["sass"] = sass_line("B3d, a thread", "orb_describe", B3D_INSTANCE,
                            homography=False, whole=True)
    return b3, b3h, b3d


def corner_err(a, b, h, w):
    """Max distance between the image corners mapped by ``a`` and ``b``
    ([..., 3, 3])."""
    c = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1.0]])
    pa = c @ np.swapaxes(np.asarray(a, np.float64), -1, -2)
    pb = c @ np.swapaxes(np.asarray(b, np.float64), -1, -2)
    return float(np.abs(pa[..., :2] / pa[..., 2:] - pb[..., :2] / pb[..., 2:]).max())


def phase_kp_parity(dev):
    """The keypoint slice's stages on CUDA and on the CPU from one burst."""
    from libstacker_tpu_torch import KeyPointMatchParameters
    from libstacker_tpu_torch.models import keypoint
    from libstacker_tpu_torch.ops import color, orb, warp_batch
    from libstacker_tpu_torch.utils.synth import make_textured_burst

    p = KeyPointMatchParameters()
    frames, _ = make_textured_burst(KP_SLICE_N, KP_SLICE_H, KP_SLICE_W,
                                    seed=5, device=dev)
    frames_np = frames.cpu().numpy()

    def run(device):
        f = torch.from_numpy(frames_np).to(device)
        feats = orb.orb_detect_and_compute(color.burst_grey_u8(f))
        gen = torch.Generator(device=device).manual_seed(0)
        hs, oks, _, _ = keypoint._match_and_estimate(
            feats, gen, p.method, p.ransac_reproj_threshold,
            p.match_keep_ratio, p.match_ratio, p.max_iters, p.confidence)
        stack = warp_batch.warp_sum_burst(f, hs, oks, border_value=0.0)
        kept = 1 + int(oks.sum())
        return hs.cpu().numpy(), oks.cpu().numpy(), (stack / kept).cpu().numpy()

    t0 = time.perf_counter()
    h_cpu, ok_cpu, out_cpu = run("cpu")
    cpu_s = time.perf_counter() - t0
    h_gpu, ok_gpu, out_gpu = run(dev)
    torch.cuda.synchronize()
    c_err = corner_err(h_gpu, h_cpu, KP_SLICE_H, KP_SLICE_W)
    c = 16
    stack_diff = float(np.abs(out_gpu[c:-c, c:-c] - out_cpu[c:-c, c:-c]).max())
    same_ok = bool(np.array_equal(ok_cpu, ok_gpu)) and bool(ok_cpu.all())
    ok = same_ok and c_err < CORNER_BAR and stack_diff < STACK_MAX_BAR
    log(f"[8 keypoint slice parity] {KP_SLICE_N}x{KP_SLICE_H}x{KP_SLICE_W}, "
        f"CUDA vs the port's CPU path ({cpu_s:.1f} s on the CPU): ok flags "
        f"equal and all kept {same_ok}, corners by H within {c_err:.3e} px "
        f"(bar {CORNER_BAR}), stack interior max diff {stack_diff:.2e} "
        f"(bar {STACK_MAX_BAR}) -> {'OK' if ok else 'MISMATCH'}")
    if not ok:
        fail("the CUDA keypoint slice disagrees with the CPU slice")


def p99(a, b, margin=64):
    d = (a[margin:-margin, margin:-margin] - b[margin:-margin, margin:-margin])
    d = d.abs().flatten()
    return float(torch.kthvalue(d.cpu(), int(0.99 * d.numel())).values)


def kp_homographies(frames, params, scale_hw, mask=None):
    """The full-resolution homographies of one ``keypoint_match_arrays``
    run (seed 0), recomputed through the same stages."""
    from libstacker_tpu_torch.models import _entry, keypoint
    from libstacker_tpu_torch.ops import color, orb, warp

    det_mask = None if mask is None else _entry.grid_mask(
        mask, frames.shape[1:3], scale_hw, frames.device)
    feats = orb.orb_detect_and_compute(color.burst_grey_u8(frames, scale_hw),
                                       mask=det_mask)
    gen = torch.Generator(device=frames.device).manual_seed(0)
    hs, oks, _, _ = keypoint._match_and_estimate(
        feats, gen, params.method, params.ransac_reproj_threshold,
        params.match_keep_ratio, params.match_ratio, params.max_iters,
        params.confidence)
    if scale_hw is not None:
        hs = warp.rescale_maps(hs, scale_hw, frames.shape[1:3])
    return hs[oks].cpu().numpy(), oks.cpu().numpy()


def phase_kp_full(dev, frames, truth):
    from libstacker_tpu_torch import KeyPointMatchParameters, keypoint_match_arrays
    from libstacker_tpu_torch.ops import color, resize
    from libstacker_tpu_torch.ops.warp_batch import warp_accumulate_rgb

    params = KeyPointMatchParameters()
    n = frames.shape[0]
    truth_t = torch.from_numpy(truth).float().to(dev)
    ref = (color.to_unit_f32(frames[0]) + warp_accumulate_rgb(
        frames[1:], truth_t[1:], torch.ones(n - 1, dtype=torch.bool,
                                            device=dev))) / n
    ref0 = color.to_unit_f32(frames[0])
    results = {}
    for label, sdw, bar in (("full", None, KP_P99_BAR),
                            ("scaled-800", 800.0, None)):
        scale_hw = resize.scale_image_size(FULL_H, FULL_W, sdw) if sdw else None
        # a homography is right where the truth's correspondences would be
        # its RANSAC inliers: corners within the reprojection threshold,
        # in pixels of the detection grid
        grid = FULL_W / scale_hw[1] if scale_hw else 1.0
        corner_bar = params.ransac_reproj_threshold * grid
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keypoint_match_arrays(frames, params, scale_down_width=sdw,
                              device_output=True)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dropped, out, stats = keypoint_match_arrays(
            frames, params, scale_down_width=sdw, return_stats=True,
            device_output=True)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        launches = read_counts()
        q = p99(out, ref)
        c = 64
        f0_diff = float((out[c:-c, c:-c] - ref0[c:-c, c:-c]).abs().mean())
        finite = bool(torch.isfinite(out).all())
        hs, oks = kp_homographies(frames, params, scale_hw)
        c_err = corner_err(hs, truth[1:][oks], FULL_H, FULL_W)
        splits = ", ".join(f"{k} {v:.1f}" for k, v in stats.phase_ms.items())
        ok = (dropped == 0 and finite and c_err < corner_bar
              and (bar is None or q < bar)
              and tuple(out.shape) == (FULL_H, FULL_W, 3)
              and not missing(launches,
                              KP_DETECT + KP_REFIT + ("warp_accum",))
              and not stray(launches))
        log(f"[9 keypoint slice {label}] {n}x{FULL_H}x{FULL_W} u8, default "
            f"parameters, detection on {scale_hw or (FULL_H, FULL_W)}: cold "
            f"{cold_s:.3f} s, warm {warm_s:.3f} s = {n / warm_s:.2f} frames/s "
            f"| stages ms: {splits} | kept {stats.frames_kept}/{n} | matches "
            f"min {min(stats.match_counts)} inliers min "
            f"{min(stats.inlier_counts)} | corners by H vs truth within "
            f"{c_err:.3f} px (bar {corner_bar:.2f}) | stack vs truth stack "
            f"p99 {q:.4f} (bar {bar if bar is not None else 'none'}) | stack "
            f"vs frame 0 mean abs {f0_diff:.3e} | launches {launches} -> "
            f"{'OK' if ok else 'FAILED'}")
        if not ok:
            fail(f"the full keypoint slice ({label}) missed a bar")
        results[label] = launches
        if label == "full":
            full_out = out
        del out
    return results, ref, full_out


def refit_inputs(dev, frames):
    """The refit inputs of ``_match_and_estimate`` on ``frames`` at full
    resolution with the default parameters (seed 0): ``(points, (src_n,
    dst_n, weights) of the DLT, (h, src, dst, weights, iters) of the
    polish)``, taken from the calls themselves."""
    from libstacker_tpu_torch import KeyPointMatchParameters
    from libstacker_tpu_torch.models import keypoint
    from libstacker_tpu_torch.ops import color, orb, ransac

    params = KeyPointMatchParameters()
    feats = orb.orb_detect_and_compute(color.burst_grey_u8(frames))
    names = ("_points", "_dlt_least_squares", "_gauss_newton_refine")
    real = {name: getattr(ransac, name) for name in names}
    seen = {}

    def spy(name):
        def call(*args):
            seen[name] = args
            return real[name](*args)
        return call

    for name in names:
        setattr(ransac, name, spy(name))
    try:
        gen = torch.Generator(device=dev).manual_seed(0)
        keypoint._match_and_estimate(
            feats, gen, params.method, params.ransac_reproj_threshold,
            params.match_keep_ratio, params.match_ratio, params.max_iters,
            params.confidence)
    finally:
        for name in names:
            setattr(ransac, name, real[name])
    return (real["_points"](*seen["_points"]), seen["_dlt_least_squares"],
            seen["_gauss_newton_refine"])


def phase_refit(dev, frames):
    """Phase 29: RANSAC's DLT and polish kernels on phase 9's refit
    inputs, against their plain versions on the CPU in float64 and
    float32 and timed against the plain versions on the card."""
    from libstacker_tpu_torch.ops import ransac, ransac_cuda
    from stackbench.roofline import ransac_refit as counts

    p, dlt_args, refine_args = refit_inputs(dev, frames)
    lanes, slots = dlt_args[2].shape
    iters = refine_args[4]
    t_src, t_dst_inv = p.t_src.cpu().double(), p.t_dst_inv.cpu().double()

    def px(h_n):
        """A DLT answer in normalised coordinates, in pixels."""
        return (t_dst_inv @ h_n.cpu().double() @ t_src).numpy()

    def on_cpu(args, dtype):
        return [a.cpu().to(dtype) if torch.is_tensor(a) else a
                for a in args]

    runs = {
        "dlt": (lambda: ransac_cuda.dlt(*dlt_args),
                lambda dt: px(ransac._dlt_plain(*on_cpu(dlt_args, dt))),
                lambda: ransac._dlt_plain(*dlt_args), px,
                counts.DLT_KERNEL,
                counts.dlt_bound_s(lanes + 1, slots) * 1e3),
        "refine": (lambda: ransac_cuda.refine(*refine_args),
                   lambda dt: ransac._refine_plain(
                       *on_cpu(refine_args, dt)).numpy(),
                   lambda: ransac._refine_plain(*refine_args),
                   lambda h: h.cpu().double().numpy(),
                   counts.REFINE_KERNEL,
                   counts.refine_bound_s(lanes + 1, slots, iters) * 1e3),
    }
    recs, bad = {}, []
    for label, (kernel, plain_cpu, plain_card, to_px, piece,
                b_ms) in runs.items():
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        same = bool(torch.equal(got, again))
        got = to_px(got)
        gap64 = corner_err(got, plain_cpu(torch.float64), FULL_H, FULL_W)
        gap32 = corner_err(got, plain_cpu(torch.float32), FULL_H, FULL_W)
        ms = time_ms(kernel, 50)
        plain_ms = time_ms(plain_card, 5)
        _, _, dev_ms = device_profile(kernel, piece)
        ok = same and gap64 < REFIT_BAR64 and gap32 < REFIT_BAR32
        steps = f", {iters} steps" if label == "refine" else ""
        log(f"[29 RANSAC refit {label}] {lanes} frames of {slots} slots "
            f"(phase 9's burst){steps}: corners within {gap64:.2e} px of "
            f"the float64 plain "
            f"version (bar {REFIT_BAR64}) and {gap32:.2e} px of the "
            f"float32 one (bar {REFIT_BAR32}), same bits on a second "
            f"launch {same}; kernel {ms:.4f} ms ({dev_ms:.4f} ms of "
            f"device time in {piece}), bound {b_ms:.6f} ms (operations "
            f"or bytes, {b_ms / dev_ms:.5f} of it); plain version on the "
            f"card {plain_ms:.4f} ms -> {'OK' if ok else 'FAILED'}")
        if not ok:
            bad.append(label)
        recs[label] = dict(
            corner_gap_f64_px=gap64, corner_gap_f32_px=gap32,
            same_bits_twice=same, ms=ms, device_ms=dev_ms,
            plain_ms=plain_ms, bound_ms=b_ms,
            **design_report(f"refit {label}", "ransac_refit", piece, dev_ms,
                            b_ms))
    if bad:
        fail(f"the refit kernel(s) {bad} missed a bar")
    return recs


def rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def b4_bounds(n: int, hw: int, covered: float):
    """(bound_ms, bound_by) of B4's clip pass over ``n`` frames of ``hw``
    pixels, ``covered`` of the pixel-frames covered and valid, and the
    moments pass's bound_ms: coordinates and the coverage test for every
    pixel-frame, the taps and sums for the covered, valid ones; the clip
    pass also reads mu and tol and takes the clip test."""
    frame_bytes = n * hw * 3.0 + 3 * hw * 3 * 4.0 + n * 40.0
    clip_ms, clip_by = bound(
        frame_bytes + 2 * hw * 3 * 4.0,
        n * hw * float(B4_OPS_ANY) + covered * (B4_OPS_COVERED + B4_OPS_CLIP))
    moments_ms, _ = bound(
        frame_bytes, n * hw * float(B4_OPS_ANY) + covered * B4_OPS_COVERED)
    return clip_ms, clip_by, moments_ms


def phase_b4(dev, frames, truth):
    """B4 on frames 1..N-1 of phase 5's burst, as the sigma-clip stack
    sees them."""
    from libstacker_tpu_torch.ops import stack, warp, warp_accum_cuda

    frames = frames[1:]
    n = frames.shape[0]
    minv = warp.invert_3x3(torch.from_numpy(truth[1:]).float().to(dev))
    minv = minv.contiguous()
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[n // 2] = False
    got = warp_accum_cuda.warp_moments_rgb(frames, minv, valid)
    want = warp_accum_cuda.warp_moments_rgb_reference(frames, minv, valid)
    # the clip pass of ops/stack.clip_iterate, fed with the kernel's pass
    denom = torch.clamp(got[0], min=1.0)
    mu = got[1] / denom
    var = torch.clamp(got[2] / denom - mu * mu, min=0.0)
    tol = (2.5 * torch.sqrt(var) + stack._CLIP_TOL).contiguous()
    mu = mu.contiguous()
    got_c = warp_accum_cuda.warp_moments_rgb(frames, minv, valid, mu, tol)
    want_c = warp_accum_cuda.warp_moments_rgb_reference(frames, minv, valid,
                                                        mu, tol)
    torch.cuda.synchronize()
    count_equal = bool(torch.equal(got[0], want[0])
                       and torch.equal(got_c[0], want_c[0]))
    pairs = list(zip(got[1:], want[1:])) + list(zip(got_c[1:], want_c[1:]))
    bitwise = all(bool(torch.equal(a, b)) for a, b in pairs)
    rel = max(rel_err(a, b) for a, b in pairs)
    max_abs = max(float((a - b).abs().max()) for a, b in pairs)
    clipped = float((got[0] - got_c[0]).sum()) / max(float(got[0].sum()), 1.0)
    ms_moments = time_ms(
        lambda: warp_accum_cuda.warp_moments_rgb(frames, minv, valid), 10)
    ms = time_ms(
        lambda: warp_accum_cuda.warp_moments_rgb(frames, minv, valid, mu, tol),
        10)
    plain_ms = time_ms(lambda: warp_accum_cuda.warp_moments_rgb_reference(
        frames, minv, valid, mu, tol), 1)
    hw = FULL_H * FULL_W
    # this run's data: coordinates and the coverage test for every
    # pixel-frame, the taps and sums for the covered, valid ones
    covered = float(want[0][..., 0].sum())
    bound_ms, bound_by, moments_bound_ms = b4_bounds(n, hw, covered)
    ok = count_equal and bitwise
    log(f"[10 B4 warp_moments] {n} u8 frames of {FULL_H}x{FULL_W} (one "
        f"dropped), moments pass then clip pass (kappa 2.5, "
        f"{clipped:.4%} of samples clipped): S0 and C0 bitwise equal "
        f"{count_equal}, S1/S2 bitwise equal {bitwise} (rel {rel:.3e}, max "
        f"abs {max_abs:.3e}); kernel {ms:.3f} ms clip pass, "
        f"{ms_moments:.3f} ms "
        f"moments pass, vs plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
        f"({bound_by}; {covered / (n * hw):.3f} of pixel-frames covered) "
        f"-> {'OK' if ok else 'MISMATCH'}")
    if not ok:
        fail("B4 disagrees with its plain version")
    rec = design_report("B4 u8 clip pass", "warp_accum", B4_INSTANCE, ms,
                        bound_ms)
    design_report("B4 u8 moments pass", "warp_accum", B4M_INSTANCE,
                  ms_moments, moments_bound_ms)
    rec["sass"] = sass_line("B4 u8 clip pass", "warp_accum", B4_INSTANCE,
                            pixels=B4_PIXELS)
    rec["moments_pass_sass"] = sass_line("B4 u8 moments pass", "warp_accum",
                                         B4M_INSTANCE, pixels=B4_PIXELS)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                moments_pass_ms=ms_moments,
                moments_pass_bound_ms=moments_bound_ms,
                library_note="no PyTorch call warps and reduces the "
                             "coverage-masked moments over frames", **rec)


def grid_for(minv, hw, src_hw):
    """``grid_sample``'s normalised grid (align_corners=True) of each
    inverse map: the unquantised source coordinates."""
    from libstacker_tpu_torch.ops import warp

    sh, sw = src_hw
    grid = torch.empty((minv.shape[0], hw[0], hw[1], 2), dtype=torch.float32,
                       device=minv.device)
    for i, m in enumerate(minv):
        sx, sy = warp._dst_coords(m, hw, perspective=True)
        grid[i, ..., 0] = sx * (2.0 / (sw - 1)) - 1.0
        grid[i, ..., 1] = sy * (2.0 / (sh - 1)) - 1.0
    return grid


def row_strip(planes, oy0: int, h_loc: int, halo: int):
    """The strip the row warp warps for the band of ``h_loc`` rows from
    ``oy0`` of ``planes`` [S,H,W]: ``halo`` rows above and below, zero
    off the frame (``parallel/mesh.py`` ``_halo_ext``); with its row
    origins ``(oy0, oy0 - halo)``."""
    s, h, w = planes.shape
    strip = planes.new_zeros((s, h_loc + 2 * halo, w))
    lo, hi = max(oy0 - halo, 0), min(oy0 + h_loc + halo, h)
    strip[:, lo - (oy0 - halo):hi - (oy0 - halo)] = planes[:, lo:hi]
    return strip, (oy0, oy0 - halo)


def phase_b5(dev, frames, truth):
    """B5 on the 60 planes of phase 9's burst, each slot its frame's
    inverse map, as ``warp_frames_batch`` calls it."""
    import torch.nn.functional as F

    from libstacker_tpu_torch.ops import color, warp, warp_cuda

    n, h, w, c = frames.shape
    src = color.to_unit_f32(frames).permute(0, 3, 1, 2)
    src = src.reshape(n * c, h, w).contiguous()
    g = n * c
    minv = warp.invert_3x3(torch.from_numpy(truth).float().to(dev))
    minv = minv.repeat_interleave(c, dim=0).contiguous()
    bv = torch.linspace(0.1, 0.9, g, device=dev)
    modes = ("constant", "transparent", "replicate", "reflect",
             "reflect101", "wrap")
    cases = [(m, src, minv, bv, None, None, (0, 0)) for m in modes]
    # slots sharing sources (each frame's three slots read its first
    # plane), and an output grid other than the source's
    shared = (torch.arange(g, device=dev) // c) * c
    cases += [("replicate", src, minv, bv, shared, None, (0, 0)),
              ("wrap", src, minv, bv, None, (h - 112, w + 128), (0, 0))]
    # the row warp's call (parallel/mesh.py warp_rows_sharded): a border
    # by value, no src_index; on the whole frame, then on its strips of
    # 3 planes of rows_frame's image with its map, and of the 60 planes
    # with their maps (first and last band), the first strip starting
    # MESH_HALO rows above the frame
    row_cases = [("constant", src, minv, 0.0, None, None, (0, 0)),
                 ("constant", src, minv, 0.25, None, None, (0, 0)),
                 ("reflect101", src, minv, 0.25, None, None, (0, 0))]
    rgb, m3 = rows_frame(dev)
    m_rows = warp.invert_3x3(torch.from_numpy(m3).to(dev))
    m_rows = m_rows.expand(3, 3, 3).contiguous()
    h_loc = h // 4
    bands = [(j, rgb.permute(2, 0, 1), m_rows) for j in range(4)]
    for j, planes, maps in bands + [(0, src, minv), (3, src, minv)]:
        strip, rows = row_strip(planes, j * h_loc, h_loc, MESH_HALO)
        row_cases.append(("constant", strip, maps, 0.0, None, (h_loc, w),
                          rows))
    del rgb, bands
    equal = True
    max_abs = 0.0
    row_warp_equal = True
    for k, (mode, s_k, m_k, b_k, sidx, out_hw, rows) in enumerate(
            cases + row_cases):
        got = warp_cuda.warp_bilinear(s_k, m_k, b_k, sidx, out_hw, False,
                                      mode, rows)
        want = warp_cuda.warp_bilinear_reference(s_k, m_k, b_k, sidx, out_hw,
                                                 False, mode, rows)
        torch.cuda.synchronize()
        same = bool(torch.equal(got.view(torch.int32),
                                want.view(torch.int32)))
        equal &= same
        if k >= len(cases):
            row_warp_equal &= same
        max_abs = max(max_abs, float((got - want).abs().max()))
        del got, want
    del cases, row_cases
    log(f"    B5 as the row warp calls it (border 0.0 / 0.25 by value, no "
        f"src_index; strips of {h_loc + 2 * MESH_HALO} rows, rows "
        f"(oy0, oy0 - {MESH_HALO}), bands 0-3 of 3 planes and 0, 3 of "
        f"{g}): bitwise equal {row_warp_equal}")
    hw = h * w
    bound_ms, bound_by = bound(g * hw * 4.0 * 2 + g * 40.0,
                               g * hw * float(B5_OPS))
    # the design in BORDER_CONSTANT (the row warp's), REPLICATE and WRAP,
    # with its registers, share of the bound and instructions an output
    # value
    timed = {}
    for mode in B5_INSTANCES:
        t_new = time_ms(lambda mode=mode: warp_cuda.warp_bilinear(
            src, minv, border_mode=mode), 10)
        rec = dict(ms=t_new, **design_report(
            f"B5 {mode}", "warp", B5_INSTANCES[mode], t_new, bound_ms))
        own = sass_line(f"B5 {mode}, a slot on its own map", "warp",
                        B5_INSTANCES[mode], pixels=B5_PIXELS)
        # the path with no reciprocal: the previous slot's coordinates
        reuse = sass_line(f"B5 {mode}, a slot on the previous slot's map",
                          "warp", B5_INSTANCES[mode], pixels=B5_PIXELS,
                          homography=False)
        rec.update(sass_own_map=own, sass_shared_map=reuse)
        if own and reuse:
            # each frame's c planes: one map computed, c - 1 reused
            rec["instructions_a_value"] = (
                own["total"] + (c - 1) * reuse["total"]) / c
            log(f"    B5 {mode}: {rec['instructions_a_value']:.1f} "
                f"instructions an output value here ({c} planes a map)")
        timed[mode] = rec
    ms = timed["replicate"]["ms"]
    plain_ms = time_ms(lambda: warp_cuda.warp_bilinear_reference(
        src, minv, border_mode="replicate"), 1)
    grid = grid_for(minv, (h, w), (h, w))
    library_ms = time_ms(lambda: F.grid_sample(
        src[:, None], grid, mode="bilinear", padding_mode="border",
        align_corners=True), 10)
    del grid
    # the same bytes moved by a device copy: what the card reaches on
    # B5's traffic with no arithmetic at all
    copy_ms = time_ms(lambda: torch.empty_like(src).copy_(src), 10)
    log(f"[11 B5 warp] {g} planes of {h}x{w} ({n} RGB frames) in each of "
        f"{', '.join(modes)}, plus shared sources and a {h - 112}x{w + 128} "
        f"grid: bitwise equal {equal}; kernel {ms:.3f} ms vs plain "
        f"{plain_ms:.3f} ms (replicate), library grid_sample "
        f"{library_ms:.3f} ms (border padding, grid precomputed, no 1/32 "
        f"quantisation), a copy of the same bytes {copy_ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms ({bound_by}) -> {'OK' if equal else 'MISMATCH'}")
    if not equal:
        fail("B5 disagrees with its plain version")
    b5 = dict(max_abs_err=max_abs, plain_ms=plain_ms,
              bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
              library_note="grid_sample(bilinear, border, align_corners) "
                           "on a precomputed grid; it does not quantise "
                           "to 1/32 px",
              copy_ms=copy_ms, **timed["replicate"], modes=timed)
    del src
    torch.cuda.empty_cache()
    return (b5, *phase_b5_frames(dev, frames, truth, modes))


def phase_b5_frames(dev, frames, truth, modes):
    """B5's frames and accumulate forms on frames 1..N-1 of phase 9's
    burst, as the keypoint stack and ``warp_frames_batch`` call them."""
    import torch.nn.functional as F

    from libstacker_tpu_torch.ops import color, warp, warp_cuda

    fr = frames[1:].contiguous()
    n, h, w, c = fr.shape
    minv = warp.invert_3x3(torch.from_numpy(truth[1:]).float().to(dev))
    minv = minv.contiguous()
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[n // 2] = False
    bv = [0.1, 0.2, 0.3]
    fr16 = (fr.to(torch.int32) * 257).to(torch.uint16)
    fr32 = color.to_unit_f32(fr)
    equal, max_abs = True, 0.0

    def hold(src, mode, v, border):
        nonlocal equal, max_abs
        got = warp_cuda.warp_frames(src, minv[:src.shape[0]], border, mode,
                                    valid=v)
        want = warp_cuda.warp_frames_reference(
            src, minv[:src.shape[0]], border, mode, valid=v)
        torch.cuda.synchronize()
        equal &= bool(torch.equal(got, want))
        max_abs = max(max_abs, float((got - want).abs().max()))

    for src in (fr, fr16, fr32):
        for mode in modes:
            for v in (None, valid):
                hold(src, mode, v, bv)
    del fr16, fr32
    # the frames form on 1 and 4 channels (the runtime-C instance), 4
    # frames of each type
    grey1 = fr[:4, ..., :1].contiguous()
    rgba = torch.cat([fr[:4], fr[:4, ..., :1]], dim=-1).contiguous()
    for src in (grey1, rgba):
        for s_ in (src, (src.to(torch.int32) * 257).to(torch.uint16),
                   color.to_unit_f32(src)):
            for mode in modes:
                hold(s_, mode, None, [0.1, 0.2, 0.3, 0.4][:src.shape[-1]])
    del grey1, rgba
    torch.cuda.empty_cache()

    # the keypoint stack with BORDER_REPLICATE, both ways: PR 6's route
    # (widen the burst, planes, planar B5 per plane, torch.sum) and the
    # accumulate form on the raw burst
    minv_rep = minv.repeat_interleave(c, dim=0).contiguous()
    bvs = torch.tensor(bv, device=dev).repeat(n)
    vf = valid.to(torch.float32)[:, None, None, None]

    def planar():
        src = color.to_unit_f32(fr).permute(0, 3, 1, 2)
        out = warp_cuda.warp_bilinear(
            src.reshape(n * c, h, w).contiguous(), minv_rep, bvs,
            border_mode="replicate")
        return out.reshape(n, c, h, w).permute(0, 2, 3, 1)

    def former_stack():
        return torch.sum(planar() * vf, dim=0)

    def stack():
        return warp_cuda.warp_frames(fr, minv, bv, "replicate", valid=valid)

    def frames_form():
        return warp_cuda.warp_frames(fr, minv, bv, "replicate")

    sum_diff = float((stack() - former_stack()).abs().max())
    f_diff = float((frames_form() - planar()).abs().max())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    a_ms, old_ms = time_ms(stack, 10), time_ms(former_stack, 5)
    old_ms2, a_ms2 = time_ms(former_stack, 5), time_ms(stack, 10)
    a_ms, old_ms = (a_ms + a_ms2) / 2, (old_ms + old_ms2) / 2
    torch.cuda.empty_cache()
    fold_ms = time_ms(planar, 10)
    n_old, dev_old, _ = device_profile(former_stack, reps=3)
    n_new, dev_new, _ = device_profile(stack, reps=3)
    torch.cuda.empty_cache()
    a_plain = time_ms(lambda: warp_cuda.warp_frames_reference(
        fr, minv, bv, "replicate", valid=valid), 1)
    f_plain = time_ms(lambda: warp_cuda.warp_frames_reference(
        fr, minv, bv, "replicate"), 1)
    torch.cuda.empty_cache()
    planes = color.to_unit_f32(fr).permute(0, 3, 1, 2).contiguous()
    grid = grid_for(minv, (h, w), (h, w))
    library_ms = time_ms(lambda: F.grid_sample(
        planes, grid, mode="bilinear", padding_mode="border",
        align_corners=True), 10)
    del planes, grid
    torch.cuda.empty_cache()
    hw = h * w
    kept = int(valid.sum())
    f_bound, f_by = bound(n * hw * c * (1.0 + 4.0) + n * 36.0,
                          n * hw * float(B5F_OPS_PIXEL + c * B5F_OPS_CHANNEL))
    a_bound, a_by = bound(kept * hw * c * 1.0 + hw * c * 4.0 + n * 40.0,
                          kept * hw * float(B5F_OPS_PIXEL
                                            + c * B5A_OPS_CHANNEL))
    # the accumulate form in each mode, with registers, shared memory,
    # share of the bound and instructions a pixel-frame; then the frames
    # form in each mode likewise
    a_modes, f_modes = {}, {}
    for mode in modes:
        code = warp_cuda._MODE_CODE[warp._resolve_border(mode)
                                    .replace("transparent", "constant")]
        run = lambda mode=mode: warp_cuda.warp_frames(  # noqa: E731
            fr, minv, bv, mode, valid=valid)
        ms_mode = time_ms(run, 10)
        piece = B5A_INSTANCE.format(code)
        rec = dict(ms=ms_mode, **design_report(
            f"B5a u8 {mode}", "warp", piece, ms_mode, a_bound))
        rec["sass"] = sass_line(f"B5a u8 {mode}", "warp", piece,
                                pixels=B5A_PIXELS)
        a_modes[mode] = rec
    torch.cuda.empty_cache()
    for mode in modes:
        code = warp_cuda._MODE_CODE[warp._resolve_border(mode)
                                    .replace("transparent", "constant")]
        run = lambda mode=mode: warp_cuda.warp_frames(  # noqa: E731
            fr, minv, bv, mode)
        ms_mode = time_ms(run, 10)
        piece = B5F_INSTANCE.format(code)
        rec = dict(ms=ms_mode, **design_report(
            f"B5f u8 {mode}", "warp", piece, ms_mode, f_bound))
        # a thread's whole body (no frame loop): the fast path
        rec["sass"] = sass_line(f"B5f u8 {mode}", "warp", piece,
                                pixels=B5F_PIXELS, whole=True, longest=False)
        f_modes[mode] = rec
        torch.cuda.empty_cache()
    # the frames form's other store path: rows of W % 4 != 0 leave by
    # coalesced scalar stores, held bitwise and timed (REPLICATE) in turns
    # with the full width's 16-byte stores
    w_odd = w - 2
    fr_odd = fr[:, :, :w_odd].contiguous()
    hold(fr_odd, "replicate", None, bv)
    odd_run = lambda: warp_cuda.warp_frames(  # noqa: E731
        fr_odd, minv, bv, "replicate")
    full_ms, odd_ms = paired_ms(frames_form, odd_run, 10)
    odd_bound, _ = bound(n * h * w_odd * c * (1.0 + 4.0) + n * 36.0,
                         n * h * w_odd * float(B5F_OPS_PIXEL
                                               + c * B5F_OPS_CHANNEL))
    odd_vs_full = (odd_ms / w_odd) / (full_ms / w)
    log(f"    B5f u8 replicate, width {w_odd} (scalar stores): "
        f"{odd_ms:.4f} ms, {odd_bound / odd_ms:.3f} of its bound; width "
        f"{w} (16-byte stores) {full_ms:.4f} ms in turns -> a pixel-frame "
        f"{odd_vs_full:.3f}x")
    f_modes["replicate"]["scalar_stores"] = dict(
        width=w_odd, ms=odd_ms, bound_ms=odd_bound,
        bound_share=odd_bound / odd_ms, full_width_ms=full_ms,
        per_pixel_vs_full=odd_vs_full)
    del fr_odd
    torch.cuda.empty_cache()
    f_ms = f_modes["replicate"]["ms"]
    log(f"[11 B5 warp_frames, warp_frames_accum] frames 1-{n} of the burst "
        f"as u8, u16 and f32, both forms, and 1- and 4-channel copies of 4 "
        f"of them, the frames form ({n} RGB frames of {h}x{w}, frame "
        f"{n // 2} dropped) in each of "
        f"{', '.join(modes)}: bitwise equal {equal}; "
        f"accumulate {a_ms:.3f} ms vs plain {a_plain:.3f} ms, bound "
        f"{a_bound:.3f} ms ({a_by}); PR 6's route (f32 widening, planes, "
        f"planar B5, torch.sum) {old_ms:.3f} ms, {dev_old:.3f} ms of device "
        f"time in {n_old} operations, the accumulate form {dev_new:.3f} "
        f"ms in {n_new}; max abs against it "
        f"{sum_diff:.3e} (float32 summation order); frames form "
        f"{f_ms:.3f} ms (replicate) vs widening + planes + planar B5 "
        f"{fold_ms:.3f} ms "
        f"(max abs {f_diff:.3e}), plain {f_plain:.3f} ms, bound "
        f"{f_bound:.3f} ms ({f_by}); library grid_sample {library_ms:.3f} ms "
        f"(f32 planes, border padding, grid precomputed) "
        f"-> {'OK' if equal and f_diff == 0.0 else 'MISMATCH'}")
    if not equal or f_diff != 0.0:
        fail("B5's frames or accumulate form disagrees with its plain "
             "version")
    note = ("grid_sample(bilinear, border, align_corners) on the f32 planes "
            "and a precomputed grid; no 1/32-px quantisation, no sum")
    b5f = dict(max_abs_err=max_abs, ms=f_ms, plain_ms=f_plain,
               bound_ms=f_bound, bound_by=f_by, library_ms=library_ms,
               library_note=note, former_route_ms=fold_ms,
               **{k: v for k, v in f_modes["replicate"].items() if k != "ms"},
               modes=f_modes)
    b5a = dict(max_abs_err=max_abs, ms=a_ms, plain_ms=a_plain,
               bound_ms=a_bound, bound_by=a_by, library_ms=library_ms,
               library_note=note, former_route_ms=old_ms,
               former_route_device_ops=n_old, route_device_ops=n_new,
               former_route_device_ms=dev_old, route_device_ms=dev_new,
               former_route_max_abs_diff=sum_diff,
               **{k: v for k, v in a_modes["replicate"].items() if k != "ms"},
               modes=a_modes)
    return b5f, b5a


def phase_b9(dev, frames):
    import torch.nn.functional as F

    from libstacker_tpu_torch.ops import color, warp_cuda

    _, h, w, _ = frames.shape
    srcs = color.to_unit_f32(frames[0]).permute(2, 0, 1).contiguous()
    lanes = 16
    rng = np.random.default_rng(12)
    minv = torch.from_numpy(near_identity_homographies(rng, lanes, h, w))
    minv = minv.to(dev)
    got = warp_cuda.warp3_bilinear(srcs, minv)
    want = warp_cuda.warp3_bilinear_reference(srcs, minv)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    max_abs = float((got - want).abs().max())
    del got, want
    new = lambda: warp_cuda.warp3_bilinear(srcs, minv)  # noqa: E731
    ms = time_ms(new, 10)
    plain_ms = time_ms(lambda: warp_cuda.warp3_bilinear_reference(srcs, minv), 1)
    grid = grid_for(minv, (h, w), (h, w))
    batch = srcs[None].expand(lanes, 3, h, w).contiguous()
    library_ms = time_ms(lambda: F.grid_sample(
        batch, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True), 10)
    del grid, batch
    hw = h * w
    bound_ms, bound_by = bound(3 * hw * 4.0 + lanes * 3 * hw * 4.0
                               + lanes * 36.0, lanes * hw * float(B9_OPS))
    log(f"[12 B9 warp3] {lanes} lanes of 3 shared {h}x{w} planes: bitwise "
        f"equal {equal}; kernel {ms:.3f} ms vs plain {plain_ms:.3f} ms, "
        f"library grid_sample {library_ms:.3f} ms (zeros padding, grid "
        f"precomputed, no 1/32 quantisation), bound {bound_ms:.3f} ms "
        f"({bound_by}) -> {'OK' if equal else 'MISMATCH'}")
    if not equal:
        fail("B9 disagrees with its plain version")
    prof = profile_line("B9", new, "warp3_kernel")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                library_note="grid_sample(bilinear, zeros, align_corners) "
                             "on a precomputed grid; it does not quantise "
                             "to 1/32 px", **prof,
                **design_report("B9", "warp", B9_INSTANCE, ms, bound_ms))


def phase_b1_masked(dev):
    from libstacker_tpu_torch.ops import ecc as ecc_ops, ecc_cuda
    from libstacker_tpu_torch.params import MotionType

    rng = np.random.default_rng(13)
    h, w, b = FULL_H, FULL_W, KERNEL_LANES
    img = torch.from_numpy(smoothed_image(rng, h, w)).to(dev)
    mask = torch.ones((h, w), device=dev)
    mask[: h // 2, : w // 2] = 0.0  # a quarter of the mask zero
    srcs = ecc_ops._prepare_masked_input(img, mask, 5).contiguous()
    tmpl = torch.from_numpy(smoothed_image(rng, h, w)).to(dev)
    tmpl = tmpl[None].repeat(b, 1, 1).contiguous()
    m3 = torch.from_numpy(near_identity_homographies(rng, b, h, w)).to(dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    active[b // 3] = False
    motion = MotionType.Homography
    tex = ecc_cuda.pack_texels(srcs)
    got = ecc_cuda.ecc_iteration_moments(srcs, tmpl, m3, motion, active=active,
                                         texels=tex)
    want = ecc_cuda.ecc_iteration_moments_reference(srcs, tmpl, m3, motion,
                                                    active=active)
    torch.cuda.synchronize()
    g = got.double().cpu().numpy()
    wnt = want.double().cpu().numpy()
    zero_ok = not np.any(g[~active.cpu().numpy()] != 0.0)
    stats_rel = float((np.abs(g[:, :6] - wnt[:, :6])
                       / (np.abs(wnt[:, :6]) + 1e-6)).max())
    worst_rel = group_rel(g, wnt, motion.num_params)
    max_abs = float(np.abs(g - wnt).max())
    kept = float(wnt[active.cpu().numpy(), 0].mean()) / (h * w)
    ms = time_ms(lambda: ecc_cuda.ecc_iteration_moments(
        srcs, tmpl, m3, motion, texels=tex), 20)
    plain_ms = time_ms(lambda: ecc_cuda.ecc_iteration_moments_reference(
        srcs, tmpl, m3, motion), 2)
    bound_ms, bound_by = bound(4.0 * h * w * (4 + b) + 4.0 * b * 66,
                               float(b) * h * w * (B1_OPS + 1))
    ok = zero_ok and stats_rel < MOMENT_REL_BAR and worst_rel < MOMENT_REL_BAR
    log(f"[13 B1 masked ecc_moments] {b} homography lanes at {h}x{w}, "
        f"mask zero on a quarter ({kept:.3f} of pixels counted per active "
        f"lane): stats rel {stats_rel:.3e}, group-norm rel {worst_rel:.3e} "
        f"(bar {MOMENT_REL_BAR:g}), max abs {max_abs:.3e}, inactive lane "
        f"zero {zero_ok}; kernel {ms:.3f} ms vs plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.3f} ms ({bound_by}) "
        f"-> {'OK' if ok else 'MISMATCH'}")
    if not ok:
        fail("B1's masked form disagrees with its plain version")
    rec = design_report("B1m P=8 with the Gram", "ecc_moments",
                        B1M_INSTANCE, ms, bound_ms)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None, **rec)


def draw_streak(frames, idx, value=255):
    """A bright 3-px diagonal line across frame ``idx`` (in place)."""
    _, h, w, _ = frames.shape
    n_pts = 4 * w
    t = torch.linspace(0.0, 1.0, n_pts, device=frames.device)
    xs = torch.round(0.1 * w + t * 0.8 * w).long()
    ys = torch.round(0.2 * h + t * 0.6 * h).long()
    for d in (-1, 0, 1):
        frames[idx, (ys + d).clamp(0, h - 1), xs] = value


def phase_ecc_sigma(dev, frames, clean):
    """Sigma-clip at full width: the streaked burst's kappa-sigma stack
    against phase 5's clean mean stack."""
    import dataclasses

    import torch.nn.functional as F

    from libstacker_tpu_torch import ecc_match_arrays

    dirty = frames.clone()
    for i in STREAK_FRAMES:
        draw_streak(dirty, i)
    mean_dirty = ecc_match_arrays(dirty, headline_params(), device_output=True)
    params = dataclasses.replace(headline_params(), stacking="sigma_clip",
                                 sigma_kappa=2.5, sigma_iters=1)
    (out, stats), cold_s, warm_s, launches = drive(
        lambda: ecc_match_arrays(dirty, params, return_stats=True,
                                 device_output=True))
    del dirty
    c = 64
    d_mean = (mean_dirty - clean).abs().mean(-1)
    d_sig = (out - clean).abs().mean(-1)
    # the streak's footprint in the stack: where it moved the mean stack
    # by at least half of one frame's full-contrast share
    core = d_mean > 0.5 * 0.5 / FULL_N
    interior = torch.zeros_like(core)
    interior[c:-c, c:-c] = True
    core &= interior
    near = F.max_pool2d(core[None, None].float(), 19, 1, 9)[0, 0] > 0
    far = interior & ~near
    err_mean = float(d_mean[core].mean())
    err_sig = float(d_sig[core].mean())
    far_err = float(d_sig[far].mean())
    rho = np.asarray(stats.ecc_rho)
    ok = (stats.frames_kept == FULL_N and int(core.sum()) > 1000
          and err_sig < SIGMA_STREAK_RATIO * err_mean
          and far_err < SIGMA_FAR_BAR and bool(torch.isfinite(out).all())
          and tuple(out.shape) == (FULL_H, FULL_W, 3)
          and launches["warp_moments"] == 1 + params.sigma_iters
          and not missing(launches, ("ecc_moments", "ecc_blur")))
    splits = ", ".join(f"{k} {v:.1f}" for k, v in stats.phase_ms.items())
    log(f"[14 ECC sigma-clip] {FULL_N}x{FULL_H}x{FULL_W} u8, a 3-px streak "
        f"in frames {list(STREAK_FRAMES)}, kappa 2.5, 1 clip pass: cold "
        f"{cold_s:.3f} s, warm {warm_s:.3f} s = {FULL_N / warm_s:.2f} "
        f"frames/s | stages ms: {splits} | kept {stats.frames_kept}/{FULL_N}, "
        f"mean rho {rho.mean():.5f} | streak core ({int(core.sum())} px): "
        f"mean stack err {err_mean:.3e}, sigma-clip err {err_sig:.3e} (bar "
        f"{SIGMA_STREAK_RATIO} x mean) | away from it {far_err:.3e} (bar "
        f"{SIGMA_FAR_BAR}) | clipped fraction "
        f"{stats.clipped_sample_frac:.5f} | launches {launches} "
        f"-> {'OK' if ok else 'FAILED'}")
    if not ok:
        fail("the full-size sigma-clip stack missed a bar")
    return launches


def phase_ecc_mask(dev, frames):
    from libstacker_tpu_torch import ecc_match_arrays

    mask = np.full((FULL_H, FULL_W), 255, np.uint8)
    mask[: FULL_H // 4, : FULL_W // 4] = 0
    (out, stats), cold_s, warm_s, launches = drive(
        lambda: ecc_match_arrays(frames, headline_params(), mask=mask,
                                 return_stats=True, device_output=True))
    rho = np.asarray(stats.ecc_rho)
    c = 64
    ref0 = frames[0].float() / 255.0
    f0_diff = float((out[c:-c, c:-c] - ref0[c:-c, c:-c]).abs().mean())
    ok = (stats.frames_kept == FULL_N and float(rho.mean()) >= RHO_BAR
          and f0_diff < FRAME0_MEAN_BAR and bool(torch.isfinite(out).all())
          and "phase init" not in stats.phase_ms
          and not missing(launches, ("ecc_moments_masked", "ecc_blur",
                                     "warp_accum")))
    splits = ", ".join(f"{k} {v:.1f}" for k, v in stats.phase_ms.items())
    log(f"[15 ECC masked] {FULL_N}x{FULL_H}x{FULL_W} u8, mask zero on the "
        f"top-left {FULL_H // 4}x{FULL_W // 4}: cold {cold_s:.3f} s, warm "
        f"{warm_s:.3f} s = {FULL_N / warm_s:.2f} frames/s | stages ms: "
        f"{splits} | kept {stats.frames_kept}/{FULL_N}, mean rho "
        f"{rho.mean():.5f} (bar {RHO_BAR}) | stack vs frame 0 mean abs "
        f"{f0_diff:.2e} | launches {launches} -> {'OK' if ok else 'FAILED'}")
    if not ok:
        fail("the full-size masked ECC stack missed a bar")
    return launches


def phase_kp_variants(dev, frames, truth, ref):
    from libstacker_tpu_torch import (KeyPointMatchParameters, constants,
                                      keypoint_match_arrays)
    from libstacker_tpu_torch.ops import resize

    n = frames.shape[0]
    mask = np.full((FULL_H, FULL_W), 255, np.uint8)
    mask[: FULL_H // 4, : FULL_W // 4] = 0
    cases = (
        ("sigma_clip", dict(stacking="sigma_clip"), None, None,
         KP_DETECT + KP_REFIT + ("warp_moments",), None),
        ("replicate", dict(border_mode=constants.BORDER_REPLICATE), None,
         None, KP_DETECT + KP_REFIT + ("warp_frames_accum",),
         KP_P99_BAR),
        ("scaled-800 mask", {}, 800.0, mask,
         KP_DETECT + KP_REFIT + ("warp_accum",), None),
    )
    results = {}
    for label, kw, sdw, m, kernels, bar in cases:
        params = KeyPointMatchParameters(**kw)
        scale_hw = resize.scale_image_size(FULL_H, FULL_W, sdw) if sdw else None
        grid = FULL_W / scale_hw[1] if scale_hw else 1.0
        corner_bar = params.ransac_reproj_threshold * grid
        (dropped, out, stats), cold_s, warm_s, launches = drive(
            lambda: keypoint_match_arrays(
                frames, params, scale_down_width=sdw, mask=m,
                return_stats=True, device_output=True))
        q = p99(out, ref)
        hs, oks = kp_homographies(frames, params, scale_hw, m)
        c_err = corner_err(hs, truth[1:][oks], FULL_H, FULL_W)
        ok = (dropped == 0 and bool(torch.isfinite(out).all())
              and c_err < corner_bar and (bar is None or q < bar)
              and tuple(out.shape) == (FULL_H, FULL_W, 3)
              and not missing(launches, kernels)
              and not stray(launches, ("orb_extract", "warp")))
        extra = ("" if stats.clipped_sample_frac is None else
                 f" | clipped fraction {stats.clipped_sample_frac:.5f}")
        splits = ", ".join(f"{k} {v:.1f}" for k, v in stats.phase_ms.items())
        log(f"[16 keypoint {label}] {n}x{FULL_H}x{FULL_W} u8, detection on "
            f"{scale_hw or (FULL_H, FULL_W)}: cold {cold_s:.3f} s, warm "
            f"{warm_s:.3f} s = {n / warm_s:.2f} frames/s | stages ms: "
            f"{splits} | kept {stats.frames_kept}/{n} | matches min "
            f"{min(stats.match_counts)} | corners by H vs truth within "
            f"{c_err:.3f} px (bar {corner_bar:.2f}) | stack vs truth stack "
            f"p99 {q:.4f} (bar {bar if bar is not None else 'none'}){extra} "
            f"| launches {launches} -> {'OK' if ok else 'FAILED'}")
        if not ok:
            fail(f"the keypoint {label} stack missed a bar")
        results[label] = launches
        del out
    return results


def phase_b7(dev):
    """B7 (with and without the Gram) and B1 without the Gram against their
    plain versions at the main path's full-resolution shape."""
    from libstacker_tpu_torch.ops import ecc as ecc_ops, ecc_cuda
    from libstacker_tpu_torch.params import MotionType

    rng = np.random.default_rng(17)
    h, w, b = FULL_H, FULL_W, KERNEL_LANES
    img = torch.from_numpy(smoothed_image(rng, h, w)).to(dev)
    srcs = torch.stack(ecc_ops._input_fields(img, 5)).contiguous()
    src = srcs[0]
    tmpl = torch.from_numpy(smoothed_image(rng, h, w)).to(dev)
    tmpl = tmpl[None].repeat(b, 1, 1).contiguous()
    m3 = torch.from_numpy(near_identity_homographies(rng, b, h, w)).to(dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    active[b // 2] = False
    aff = m3[:1].clone()
    aff[:, 2] = torch.tensor([0.0, 0.0, 1.0], device=dev)
    hom = MotionType.Homography
    tex = ecc_cuda.pack_texels(srcs)

    worst = {"ic": 0.0, "lite": 0.0}
    max_abs = {"ic": 0.0, "lite": 0.0}
    zero_ok = True
    for motion, mats, act in ((hom, m3, active),
                              (MotionType.Affine, aff, None)):
        for gram in (True, False):
            kw = dict(quant_affine=motion != hom, active=act,
                      with_hessian=gram)
            pairs = [("ic", ecc_cuda.ecc_ic_iteration_moments(
                          src, tmpl[: len(mats)], mats, motion, **kw),
                      ecc_cuda.ecc_ic_iteration_moments_reference(
                          src, tmpl[: len(mats)], mats, motion, **kw))]
            if not gram:
                pairs.append(("lite", ecc_cuda.ecc_iteration_moments(
                                  srcs, tmpl[: len(mats)], mats, motion,
                                  texels=tex, **kw),
                              ecc_cuda.ecc_iteration_moments_reference(
                                  srcs, tmpl[: len(mats)], mats, motion,
                                  **kw)))
            torch.cuda.synchronize()
            for key, got, want in pairs:
                g = got.double().cpu().numpy()
                wnt = want.double().cpu().numpy()
                if act is not None:
                    zero_ok &= not np.any(g[~act.cpu().numpy()] != 0.0)
                worst[key] = max(worst[key], group_rel(
                    g, wnt, motion.num_params, with_hessian=gram))
                max_abs[key] = max(max_abs[key], float(np.abs(g - wnt).max()))
    ms = time_ms(
        lambda: ecc_cuda.ecc_ic_iteration_moments(src, tmpl, m3, hom), 20)
    ms_gram = time_ms(
        lambda: ecc_cuda.ecc_ic_iteration_moments(src, tmpl, m3, hom,
                                                  with_hessian=True), 10)
    plain_ms = time_ms(lambda: ecc_cuda.ecc_ic_iteration_moments_reference(
        src, tmpl, m3, hom), 1)
    lite_ms = time_ms(lambda: ecc_cuda.ecc_iteration_moments(
        srcs, tmpl, m3, hom, with_hessian=False, texels=tex), 20)
    lite_plain_ms = time_ms(lambda: ecc_cuda.ecc_iteration_moments_reference(
        srcs, tmpl, m3, hom, with_hessian=False), 1)
    torch.cuda.synchronize()
    hw = float(h * w)
    bound_ms, bound_by = bound(4.0 * hw * (1 + b) + 4.0 * b * 30,
                               b * hw * B7_LITE_OPS)
    gram_bound_ms, _ = bound(4.0 * hw * (1 + b) + 4.0 * b * 66,
                             b * hw * B7_OPS)
    lite_bound_ms, lite_bound_by = bound(4.0 * hw * (3 + b) + 4.0 * b * 30,
                                         b * hw * B1_LITE_OPS)
    ok = (zero_ok and worst["ic"] < MOMENT_REL_BAR
          and worst["lite"] < MOMENT_REL_BAR)
    log(f"[17 B7 ecc_ic_moments, B1 without the Gram] {b} homography lanes "
        f"(one inactive) + 1 affine lane at {h}x{w}, with and without the "
        f"Gram: B7 group-norm rel {worst['ic']:.3e}, B1 lite "
        f"{worst['lite']:.3e} (bar {MOMENT_REL_BAR:g}), inactive lanes zero "
        f"{zero_ok}; B7 {ms:.3f} ms ({ms_gram:.3f} with the Gram) vs plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; "
        f"{gram_bound_ms:.3f} with the Gram); B1 lite {lite_ms:.3f} ms vs "
        f"plain {lite_plain_ms:.3f} ms, bound {lite_bound_ms:.3f} ms "
        f"({lite_bound_by}) -> {'OK' if ok else 'MISMATCH'}")
    if not ok:
        fail("B7 or B1 without the Gram disagrees with its plain version")
    rec7 = design_report("B7 P=8", "ecc_ic_moments", B7_INSTANCE, ms,
                         bound_ms)
    rec7g = design_report("B7 P=8 with the Gram", "ecc_ic_moments",
                          B7_GRAM_INSTANCE, ms_gram, gram_bound_ms)
    rec_lite = design_report("B1 lite P=8", "ecc_moments", B1_LITE_INSTANCE,
                             lite_ms, lite_bound_ms)
    b7 = dict(max_abs_err=max_abs["ic"], ms=ms, plain_ms=plain_ms,
              bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
              ms_with_gram=ms_gram, bound_ms_with_gram=gram_bound_ms,
              library_note="no PyTorch call fuses a warp with 30-66 "
                           "reductions", **rec7,
              **{f"with_gram_{k}": v for k, v in rec7g.items()})
    lite = dict(max_abs_err=max_abs["lite"], ms=lite_ms,
                plain_ms=lite_plain_ms, bound_ms=lite_bound_ms,
                bound_by=lite_bound_by, library_ms=None,
                library_note="no PyTorch call fuses a warp with 30 "
                             "reductions", **rec_lite)
    return b7, lite


def sr_deposits(minv, valid, h, w, factor):
    """Fine pixel-frames whose nearest tap is inside and valid (this run's
    data: the samples B6 deposits)."""
    from libstacker_tpu_torch.ops import sr_cuda

    gy, gx = sr_cuda._fine_coords(h, w, factor, minv.device)
    total = 0
    for m, v in zip(minv, valid):
        if not bool(v):
            continue
        den = m[2, 0] * gx + m[2, 1] * gy + m[2, 2]
        sx = (m[0, 0] * gx + m[0, 1] * gy + m[0, 2]) / den
        sy = (m[1, 0] * gx + m[1, 1] * gy + m[1, 2]) / den
        qx, qy = torch.round(sx), torch.round(sy)
        total += int(((qx >= 0) & (qx <= w - 1) & (qy >= 0)
                      & (qy <= h - 1) & (den > 1e-6)).sum())
    return total


def sr_parity(got, want):
    """(bitwise, max abs) of a kernel's outputs against its plain
    version's (a tuple of arrays or one image)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    bitwise = all(bool(torch.equal(a, c)) for a, c in zip(got, want))
    max_abs = max(float((a - c).abs().max()) for a, c in zip(got, want))
    return bitwise, max_abs


def phase_b6(dev, frames):
    """B6 in both forms on frames 0-7 of phase 5's burst, as
    super_res_stack calls it on CUDA (the image form) and as the JAX
    package's counterpart returns it (the deposit)."""
    from libstacker_tpu_torch.ops import sr_cuda

    frames = frames[:SR_FRAMES]
    n, h, w, _ = frames.shape
    rng = np.random.default_rng(18)
    minv = torch.from_numpy(near_identity_homographies(rng, n, h, w)).to(dev)
    minv[0] = torch.eye(3, device=dev)  # frame 0 deposits as itself
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[5] = False
    lines, ok = [], True
    bitwise_all = {"deposit": True, "image": True}
    max_abs = {"deposit": 0.0, "image": 0.0}
    for factor in (2, 3):
        for sigma in (0.3, 0.1):
            fb = sigma < 0.15
            args = (frames, minv, valid, factor, sigma, True, fb)
            got = sr_cuda.sr_deposit(*args)
            want = sr_cuda.sr_deposit_reference(*args)
            gi = sr_cuda.sr_image(*args)
            wi = sr_cuda.sr_image_reference(*args)
            torch.cuda.synchronize()
            # the deposit is held through the image it gives
            d_img = sr_cuda.normalise(got)
            parts = []
            for form, bitwise, m_abs, a, b in (
                ("deposit", *sr_parity(got, want), d_img, wi),
                ("image", *sr_parity(gi, wi), gi, wi),
            ):
                d = (a - b).abs()
                frac = float((d > 1e-4).float().mean())
                med = float(d.median())
                ok &= bitwise or (frac <= 1e-3 and med < 1e-6)
                bitwise_all[form] &= bitwise
                max_abs[form] = max(max_abs[form], m_abs)
                parts.append(f"{form} " + ("bitwise" if bitwise else
                             f"not bitwise, image (d > 1e-4) {frac:.2e}, "
                             f"median {med:.1e}"))
                del d
            lines.append(f"x{factor} sigma {sigma}: {', '.join(parts)}")
            del got, want, gi, wi, d_img
            torch.cuda.empty_cache()
    why = ("" if all(bitwise_all.values()) else
           " (where not bitwise: the weights go through the two exp "
           "implementations, the kernel's expf and PyTorch's)")
    log(f"[18 B6 sr_deposit / sr_image] frames 0-{n - 1} of phase 5's burst "
        f"({h}x{w} u8, near-identity homographies, lane 5 dropped): "
        f"{'; '.join(lines)}{why}; max abs: deposit sums "
        f"{max_abs['deposit']:.3e}, image {max_abs['image']:.3e} -> "
        f"{'OK' if ok else 'MISMATCH'}")
    if not ok:
        fail("B6 disagrees with its plain version")

    fhw = 4.0 * h * w
    deposits = sr_deposits(minv, valid, h, w, 2)
    # the kernel skips a dropped frame whole: only the kept frames (and
    # their maps) are read and swept
    kept = int(valid.sum())
    read = kept * h * w * 3.0 + kept * 36.0 + n
    ops = kept * fhw * B6_OPS_ANY + deposits * B6_OPS_DEPOSIT
    bound_ms, bound_by = bound(read + fhw * (3 + 1) * 4.0, ops)
    img_bound_ms, img_bound_by = bound(read + fhw * 3 * 4.0,
                                       ops + fhw * B6_OPS_FINALISE)
    log(f"    bounds at x2: deposit {bound_ms:.3f} ms ({bound_by}), image "
        f"{img_bound_ms:.3f} ms ({img_bound_by}); {kept} frames kept, "
        f"{deposits / (kept * fhw):.3f} of their fine pixel-frames deposit")
    rec, rec_i = {}, {}
    for sigma in (0.3, 0.1):
        fb = sigma < 0.15
        args = (frames, minv, valid, 2, sigma, True, fb)
        dep = lambda: sr_cuda.sr_deposit(*args)  # noqa: E731
        image = lambda: sr_cuda.sr_image(*args)  # noqa: E731
        route = lambda: sr_cuda.normalise(sr_cuda.sr_deposit(*args))  # noqa: E731
        ms = time_ms(dep, 20)
        # the image form against the route it replaces: the deposit and
        # the PyTorch normalisation
        i_ms, route_ms = paired_ms(image, route, 20)
        tag = "deposit + normalise"
        log(f"    x2 sigma {sigma}: deposit {ms:.3f} ms; image {i_ms:.3f} ms "
            f"vs {tag} {route_ms:.3f} ms")
        prof_i = profile_line(f"x2 sigma {sigma} image", image, "sr_kernel")
        prof_r = profile_line(f"x2 sigma {sigma} {tag}", route, "sr_")
        prof_d = profile_line(f"x2 sigma {sigma} deposit", dep, "sr_kernel")
        if sigma == 0.3:
            plain_ms = time_ms(lambda: sr_cuda.sr_deposit_reference(*args), 2)
            plain_i_ms = time_ms(lambda: sr_cuda.sr_image_reference(*args), 2)
            rec = dict(max_abs_err=max_abs["deposit"], ms=ms,
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=None,
                       library_note="no PyTorch call computes a nearest-tap "
                                    "Gaussian deposit over frames", **prof_d,
                       **design_report("B6 deposit x2", "sr_deposit",
                                       B6_INSTANCE, ms, bound_ms))
            rec_i = dict(max_abs_err=max_abs["image"], ms=i_ms,
                         plain_ms=plain_i_ms, bound_ms=img_bound_ms,
                         bound_by=img_bound_by, library_ms=None,
                         library_note="no PyTorch call computes a "
                                      "nearest-tap Gaussian deposit over "
                                      "frames",
                         replaced_route=tag, replaced_route_ms=route_ms,
                         **prof_i,
                         **{f"replaced_route_{k}": v
                            for k, v in prof_r.items()},
                         **design_report("B6 image x2", "sr_deposit",
                                         B6I_INSTANCE, i_ms, img_bound_ms))
        else:
            rec_i.update(fallback_ms=i_ms,
                         fallback_replaced_route_ms=route_ms,
                         **{f"fallback_{k}": v for k, v in prof_i.items()},
                         **{f"fallback_replaced_route_{k}": v
                            for k, v in prof_r.items()})
            rec.update(fallback_ms=ms,
                       **{f"fallback_{k}": v for k, v in prof_d.items()})
    return rec, rec_i


def box2(img):
    """2x2 box mean of an [2H, 2W, 3] image."""
    h2, w2, c = img.shape
    return img.reshape(h2 // 2, 2, w2 // 2, 2, c).mean(dim=(1, 3))


def phase_ecc_sr(dev, frames):
    import dataclasses

    from libstacker_tpu_torch import ecc_match_arrays

    frames = frames[:SR_FRAMES].contiguous()
    n = frames.shape[0]
    mean = ecc_match_arrays(frames, headline_params(), device_output=True)
    params = dataclasses.replace(headline_params(), output_scale=2)
    (out, stats), cold_s, warm_s, launches = drive(
        lambda: ecc_match_arrays(frames, params, return_stats=True,
                                 device_output=True))
    c = 64
    box_err = float((box2(out) - mean)[c:-c, c:-c].abs().mean())
    splits = ", ".join(f"{k} {v:.1f}" for k, v in stats.phase_ms.items())
    ok = (stats.frames_kept == n and bool(torch.isfinite(out).all())
          and tuple(out.shape) == (2 * FULL_H, 2 * FULL_W, 3)
          and box_err < SR_BOX_BAR and launches["sr_image"] == 1
          and launches["sr_deposit"] == 0 and launches["warp_accum"] == 0
          and not missing(launches, ("ecc_moments", "ecc_blur")))
    log(f"[19 ECC super-resolution] {n}x{FULL_H}x{FULL_W} u8, headline "
        f"parameters, output_scale=2 -> {tuple(out.shape)}: cold "
        f"{cold_s:.3f} s, warm {warm_s:.3f} s | stages ms: {splits} | kept "
        f"{stats.frames_kept}/{n} | 2x2 box mean vs the mean stack mean abs "
        f"{box_err:.3e} (bar {SR_BOX_BAR}) | launches {launches} -> "
        f"{'OK' if ok else 'FAILED'}")
    if not ok:
        fail("the full-size ECC super-resolution missed a bar")
    return launches


def phase_kp_sr(dev, frames, mean_out):
    from libstacker_tpu_torch import KeyPointMatchParameters, keypoint_match_arrays

    n = frames.shape[0]
    params = KeyPointMatchParameters(output_scale=2)
    (dropped, out, stats), cold_s, warm_s, launches = drive(
        lambda: keypoint_match_arrays(frames, params, return_stats=True,
                                      device_output=True))
    c = 64
    box_err = float((box2(out) - mean_out)[c:-c, c:-c].abs().mean())
    splits = ", ".join(f"{k} {v:.1f}" for k, v in stats.phase_ms.items())
    ok = (dropped == 0 and bool(torch.isfinite(out).all())
          and tuple(out.shape) == (2 * FULL_H, 2 * FULL_W, 3)
          and box_err < SR_BOX_BAR and launches["sr_image"] == 1
          and launches["sr_deposit"] == 0 and launches["warp_accum"] == 0
          and not missing(launches, KP_DETECT + KP_REFIT)
          and not stray(launches))
    log(f"[20 keypoint super-resolution] {n}x{FULL_H}x{FULL_W} u8, default "
        f"parameters, output_scale=2 -> {tuple(out.shape)}: cold "
        f"{cold_s:.3f} s, warm {warm_s:.3f} s | stages ms: {splits} | kept "
        f"{stats.frames_kept}/{n} | 2x2 box mean vs phase 9's mean stack "
        f"mean abs {box_err:.3e} (bar {SR_BOX_BAR}) | launches B8 "
        f"{launches['fast']}, B3h {launches['orb_harris']}, B3d "
        f"{launches['orb_describe']}, B6 image {launches['sr_image']}, "
        f"B6 deposit {launches['sr_deposit']}: "
        f"{launches} -> {'OK' if ok else 'FAILED'}")
    if not ok:
        fail("the full-size keypoint super-resolution missed a bar")
    return launches


def phase_solvers(dev, frames, clean):
    """solver='lazy', solver='ic' and phase_init_rotation=True on phase 5's
    burst, each cold and warm."""
    import dataclasses

    from libstacker_tpu_torch import ecc_match_arrays
    from libstacker_tpu_torch.ops import ecc as ecc_ops

    results = {}
    ref0 = frames[0].float() / 255.0
    c = 64
    for label, kw, need in (
        ("solver=lazy", dict(solver="lazy"), ("ecc_moments_lite",)),
        ("solver=ic", dict(solver="ic"), ("ecc_ic_moments",)),
        ("phase_init_rotation", dict(phase_init_rotation=True),
         ("ecc_moments",)),
    ):
        params = dataclasses.replace(headline_params(), **kw)

        def run():
            ecc_ops.rescued_lane_count = 0
            return ecc_match_arrays(frames, params, return_stats=True,
                                    device_output=True)

        (out, stats), cold_s, warm_s, launches = drive(run)
        rescued = ecc_ops.rescued_lane_count
        rho = np.asarray(stats.ecc_rho)
        iters = np.asarray(stats.ecc_iterations)
        f0_diff = float((out[c:-c, c:-c] - ref0[c:-c, c:-c]).abs().mean())
        q = p99(out, clean)
        splits = ", ".join(f"{k} {v:.1f}" for k, v in stats.phase_ms.items())
        ok = (stats.frames_kept == FULL_N and float(rho.mean()) >= RHO_BAR
              and f0_diff < FRAME0_MEAN_BAR and q < SOLVER_P99_BAR
              and bool(torch.isfinite(out).all())
              and tuple(out.shape) == (FULL_H, FULL_W, 3)
              and not missing(launches, need + ("warp_accum",)))
        log(f"[21 ECC {label}] {FULL_N}x{FULL_H}x{FULL_W} u8, headline "
            f"parameters: cold {cold_s:.3f} s, warm {warm_s:.3f} s = "
            f"{FULL_N / warm_s:.2f} frames/s | stages ms: {splits} | iters "
            f"(full-res) mean {iters.mean():.2f} max {iters.max()} | mean "
            f"rho {rho.mean():.5f} | kept {stats.frames_kept}/{FULL_N} | "
            f"stack vs frame 0 mean abs {f0_diff:.2e} | vs phase 5's forward "
            f"stack p99 {q:.4f} (bar {SOLVER_P99_BAR}) | launches B1 with "
            f"the Gram {launches['ecc_moments']}, without "
            f"{launches['ecc_moments_lite']}, B7 {launches['ecc_ic_moments']}"
            f" | lanes re-solved by the forward rescue {rescued} -> "
            f"{'OK' if ok else 'FAILED'}")
        if not ok:
            fail(f"the full-size ECC {label} run missed a bar")
        results[label] = launches
        del out
    return results


def write_tiff16(path, rgb16, deflate: bool) -> None:
    """A 48-bit RGB baseline TIFF (little-endian, one strip of 64 rows
    each), uncompressed or Deflate (zlib level 1) with the horizontal
    predictor, written with numpy and zlib alone."""
    import struct
    import zlib

    h, w, _ = rgb16.shape
    rows = 64
    strips = []
    for y0 in range(0, h, rows):
        s = rgb16[y0:y0 + rows]
        if deflate:
            s = s.copy()
            s[:, 1:] -= rgb16[y0:y0 + rows, :-1]  # uint16 wraps mod 2^16
        raw = np.ascontiguousarray(s, dtype="<u2").tobytes()
        strips.append(zlib.compress(raw, 1) if deflate else raw)
    offsets = np.cumsum([8] + [len(b) for b in strips[:-1]])
    arrays = pos = 8 + sum(len(b) for b in strips)
    bits = struct.pack("<3H", 16, 16, 16) + b"\0\0"
    offs = np.asarray(offsets, "<u4").tobytes()
    counts = np.asarray([len(b) for b in strips], "<u4").tobytes()
    pos += len(bits) + len(offs) + len(counts)
    n = len(strips)
    # (tag, type, count, value or offset); one strip's values are inline
    one = n == 1
    tags = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 3, arrays),
            (259, 3, 1, 8 if deflate else 1), (262, 3, 1, 2),
            (273, 4, n, 8 if one else arrays + len(bits)), (277, 3, 1, 3),
            (278, 4, 1, rows),
            (279, 4, n, len(strips[0]) if one
             else arrays + len(bits) + len(offs)),
            (284, 3, 1, 1), (317, 3, 1, 2 if deflate else 1)]
    ifd = b"".join(struct.pack("<HHII", t, typ, c, v) if typ == 4 or c > 1
                   else struct.pack("<HHIHH", t, typ, c, v, 0)
                   for t, typ, c, v in tags)
    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<I", pos))
        for b in strips:
            f.write(b)
        f.write(bits + offs + counts)
        f.write(struct.pack("<H", len(tags)) + ifd + b"\0\0\0\0")


def phase_files(dev):
    """The file entry points on the card's host: 8 frames of 1080x1920
    written as 16-bit PNGs by ``save_image(..., bit_depth=16)``, as 48-bit
    TIFFs (uncompressed and Deflate with predictor 2, in turns) and as
    8-bit PNGs, decoded by ``load_frames`` with and without
    ``preserve_depth``, and ``ecc_match(files)`` / ``keypoint_match(files)``
    held bitwise against their ``_arrays`` forms on the decoded arrays.
    The native library that decodes them is printed; where neither
    ``native/stacker_io.cpp`` nor ``csrc/image_io.cpp`` builds, the phase
    fails and prints both compilers' reasons."""
    import shutil

    from libstacker_tpu_torch import (
        KeyPointMatchParameters, ecc_match, ecc_match_arrays,
        keypoint_match, keypoint_match_arrays, save_image,
    )
    from libstacker_tpu_torch.utils import io, native_loader
    from libstacker_tpu_torch.utils.synth import make_burst, make_textured_burst

    t0 = time.perf_counter()
    backend = native_loader.backend()
    build_s = time.perf_counter() - t0
    if backend is None:
        reason = (native_loader.build_error() or "").replace("\n", " | ")
        fail(f"no native image library loads on this host: {reason}")
    n, h, w = SLICE_N, SLICE_H, SLICE_W
    rgb8 = make_burst(n, h, w, seed=5)[0].numpy()
    # 16-bit content whose high byte is the 8-bit burst
    rgb16 = (rgb8.astype(np.uint16) << 8) | np.random.default_rng(5).integers(
        0, 256, rgb8.shape, dtype=np.uint16)
    kp8 = make_textured_burst(n, h, w, seed=1)[0].numpy()
    d = REPO / "build" / "smoke_files"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    p16, p8, pkp = ([d / f"{tag}{i}.png" for i in range(n)]
                    for tag in ("ecc16_", "ecc8_", "kp8_"))
    t16 = [d / f"ecc16_{i}.tif" for i in range(n)]
    t0 = time.perf_counter()
    for i in range(n):
        save_image(p16[i], rgb16[i], bit_depth=16)
        save_image(p8[i], rgb8[i])
        save_image(pkp[i], kp8[i])
    write_s = time.perf_counter() - t0
    for i in range(n):
        write_tiff16(t16[i], rgb16[i], deflate=i % 2 == 1)

    checks = {}
    t0 = time.perf_counter()
    checks["16-bit PNG, 8-bit decode = high byte"] = np.array_equal(
        io.load_frames(p16), rgb8)
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    checks["16-bit PNG, preserve_depth"] = np.array_equal(
        io.load_frames(p16, preserve_depth=True), rgb16)
    decode16_s = time.perf_counter() - t0
    checks["48-bit TIFF, preserve_depth"] = np.array_equal(
        io.load_frames(t16, preserve_depth=True), rgb16)
    # both native loaders round 16-bit TIFF RGB to (v + 128) // 257, as
    # libtiff's RGBA route does (a PNG keeps the high byte, strip_16)
    tiff8 = ((rgb16.astype(np.uint32) + 128) // 257).astype(np.uint8)
    checks["48-bit TIFF, 8-bit decode"] = np.array_equal(
        io.load_frames(t16), tiff8)
    checks["8-bit PNG decode"] = np.array_equal(io.load_frames(p8), rgb8)
    u16_from_8 = io.load_frames(p8, preserve_depth=True)
    checks["8-bit PNG, preserve_depth = x257"] = np.array_equal(
        u16_from_8, rgb8.astype(np.uint16) * 257)

    def entry(label, run_files, run_arrays, kernels):
        reset_counts()
        torch.cuda.synchronize()
        got = run_files()
        torch.cuda.synchronize()
        launches = read_counts()
        want = run_arrays()
        key = f"{label} = _arrays"
        checks[key] = (np.array_equal(got, want)
                       and not missing(launches, kernels)
                       and not stray(launches))
        return launches

    params = headline_params()
    kp = KeyPointMatchParameters()
    results = {}
    results["ecc_match files"] = entry(
        "ecc_match(files)", lambda: ecc_match(p8, params, device=dev),
        lambda: ecc_match_arrays(rgb8, params, device=dev),
        ("ecc_moments", "warp_accum"))
    results["ecc_match files preserve_depth"] = entry(
        "ecc_match(files, preserve_depth)",
        lambda: ecc_match(p8, params, preserve_depth=True, device=dev),
        lambda: ecc_match_arrays(u16_from_8, params, device=dev),
        ("ecc_moments", "warp_accum"))
    results["ecc_match 16-bit PNG files preserve_depth"] = entry(
        "ecc_match(16-bit PNG files, preserve_depth)",
        lambda: ecc_match(p16, params, preserve_depth=True, device=dev),
        lambda: ecc_match_arrays(rgb16, params, device=dev),
        ("ecc_moments", "warp_accum"))
    results["ecc_match 48-bit TIFF files preserve_depth"] = entry(
        "ecc_match(48-bit TIFF files, preserve_depth)",
        lambda: ecc_match(t16, params, preserve_depth=True, device=dev),
        lambda: ecc_match_arrays(rgb16, params, device=dev),
        ("ecc_moments", "warp_accum"))
    results["keypoint_match files"] = entry(
        "keypoint_match(files)",
        lambda: keypoint_match(pkp, kp, device=dev)[1],
        lambda: keypoint_match_arrays(io.load_frames(pkp), kp,
                                      device=dev)[1],
        KP_DETECT + ("warp_accum",))
    shutil.rmtree(d, ignore_errors=True)
    ok = all(checks.values())
    log(f"[22 file entry points] {n}x{h}x{w}: native image library "
        f"{backend!r} (built and loaded in {build_s:.2f} s); wrote "
        f"{3 * n} PNGs in {write_s:.2f} s ({n} of them 16-bit) and {n} "
        f"48-bit TIFFs; decoded the {n} 16-bit PNGs in {decode_s:.2f} s at "
        f"8 bits, {decode16_s:.2f} s at 16; "
        + "; ".join(f"{k} {v}" for k, v in checks.items())
        + f" -> {'OK' if ok else 'FAILED'}")
    if not ok:
        fail("a file entry point disagrees with its _arrays form")
    return results


# the streams and the CLI at full width (phases 24-25)
STREAM_N = 24
STREAM_CHUNK = 8
CLI_N = 6
# phase 23: frames held against the CPU path, and its bar; the rank
# cell's burst; the eager float32 chain before the kernel on 100 4K frames
SHARP_CPU_FRAMES = 4
SHARP_REL_BAR = 1e-5
SHARP_CELL_FRAMES = 32
SHARP_EAGER_MS = (225.7, 227.6)


def phase_sharpness(dev, frames):
    """Phase 23: the one-pass sharpness kernel on the grey of phase 5's
    burst and on its first 32 frames, timed by CUDA events and by
    ``torch.profiler``, against its bound, the plain version on the card
    and the port's CPU path on the first frames."""
    from libstacker_tpu_torch import sharpness_all
    from libstacker_tpu_torch.ops import color
    from libstacker_tpu_torch.ops import sharpness_cuda
    # the benchmark's count of the kernel's bytes and operations
    from stackbench.roofline import sharpness as roofline

    t_phase = time.perf_counter()
    grey = color.burst_grey_u8(frames)
    n, h, w = grey.shape
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    gpu = sharpness_all(grey)
    torch.cuda.synchronize()
    launches = read_counts()["sharpness"]
    peak = torch.cuda.max_memory_allocated() - base
    s1, m1 = sharpness_cuda.sharpness_sums(grey, 3)
    s2, m2 = sharpness_cuda.sharpness_sums(grey, 3)
    repeat = bool(torch.equal(s1, s2) and torch.equal(m1, m2))
    k = SHARP_CPU_FRAMES
    t0 = time.perf_counter()
    cpu_s, cpu_m = sharpness_cuda.sharpness_sums(grey[:k].cpu(), 3)
    cpu = sharpness_all(grey[:k].cpu())
    cpu_secs = time.perf_counter() - t0
    equal = bool(torch.equal(s1[:k].cpu(), cpu_s)
                 and torch.equal(m1[:, :k].cpu(), cpu_m))
    rel = max(float(((gpu[m][:k].cpu().double() - cpu[m].double())
                     / cpu[m].double()).abs().max()) for m in cpu)
    rank_gpu = np.argsort(gpu["teng"][:k].cpu().numpy(), kind="stable")
    rank_cpu = np.argsort(cpu["teng"].numpy(), kind="stable")
    finite = all(bool(torch.isfinite(v).all()) and v.shape == (n,)
                 for v in gpu.values())
    ok = (rel <= SHARP_REL_BAR and np.array_equal(rank_gpu, rank_cpu)
          and finite and equal and repeat and launches == 2)
    del s1, s2, m1, m2
    recs = {}
    for lanes in (n, SHARP_CELL_FRAMES):
        x = grey[:lanes].contiguous()
        ms = time_ms(lambda: sharpness_cuda.sharpness_sums(x, 3), 20)
        prof = device_profile(lambda: sharpness_all(x), "sharpness_")
        b_s, b_by = roofline.bound_s(lanes, h, w)
        b_ms = b_s * 1e3
        recs[lanes] = dict(ms=ms, device_ms=prof[1], kernel_device_ms=prof[2],
                           device_ops=prof[0], bound_ms=b_ms, bound_by=b_by)
        log(f"    {lanes}x{h}x{w} u8: kernel {ms:.4f} ms by events, "
            f"{prof[2]:.4f} ms of its two kernels' device time "
            f"({prof[0]} device operations, {prof[1]:.4f} ms a "
            f"sharpness_all); bound {b_ms:.4f} ms ({b_by}, "
            f"{b_ms / ms:.3f} of it)")
    plain_ms = time_ms(lambda: sharpness_cuda.sharpness_sums_reference(
        grey, 3), 1)
    rec = recs[n]
    rec.update(plain_ms=plain_ms, cell_32=recs[SHARP_CELL_FRAMES],
               bitwise_equal=equal, repeat_bitwise=repeat,
               launches_a_call=launches, peak_gib=peak / 2**30,
               **design_report("sharpness u8 ksize 3", "sharpness",
                               SHARP_INSTANCE, rec["ms"], rec["bound_ms"]))
    log(f"[23 sharpness] the one-pass kernel on the grey of phase 5's "
        f"burst ({n}x{h}x{w} u8): {rec['ms']:.4f} ms (the eager chain "
        f"before it: {SHARP_EAGER_MS[0]}-{SHARP_EAGER_MS[1]} ms), plain "
        f"version on the card {plain_ms:.1f} ms; {launches} launches a "
        f"sharpness_all; peak memory {peak / 2**30:.4f} GiB above the "
        f"burst; two runs bitwise equal {repeat} | frames 0-{k - 1} vs "
        f"the port's CPU path ({cpu_secs:.1f} s on the CPU): sums and "
        f"metrics equal {equal}, max rel {rel:.3e} (bar {SHARP_REL_BAR}), "
        f"TENG ranking equal {np.array_equal(rank_gpu, rank_cpu)} | phase "
        f"{time.perf_counter() - t_phase:.1f} s -> {'OK' if ok else 'FAILED'}")
    if not ok:
        fail("sharpness on the card disagrees with the CPU path")
    del grey
    torch.cuda.empty_cache()
    return rec


def write_pngs(d, frames, ext: str = "png") -> list:
    """u8 [N,H,W,3] -> PNG files in ``d`` (zlib level 1; ``ext="jpg"``:
    JPEG at quality 95), one thread a file."""
    import concurrent.futures
    import shutil

    from PIL import Image

    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    paths = [d / f"f{i:03d}.{ext}" for i in range(frames.shape[0])]
    opts = {"compress_level": 1} if ext == "png" else {"quality": 95}

    def one(i):
        Image.fromarray(frames[i]).save(paths[i], **opts)

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(one, range(len(paths))))
    return [str(p) for p in paths]


def copy_overlap(fn):
    """Run ``fn`` under ``torch.profiler`` -> (host-to-device copy ms from
    pinned memory, ms of it overlapping kernels, kernel ms)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.events() if ev.device_type == cuda]
    copies = [(ev.time_range.start, ev.time_range.end) for ev in evs
              if "HtoD" in ev.name and "Pinned" in ev.name]
    kernels = sorted((ev.time_range.start, ev.time_range.end) for ev in evs
                     if "Memcpy" not in ev.name and "Memset" not in ev.name)
    union = []
    for a, b in kernels:
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    over = sum(max(0, min(b, d) - max(a, c))
               for a, b in copies for c, d in union)
    return (sum(b - a for a, b in copies) / 1e3, over / 1e3,
            sum(b - a for a, b in union) / 1e3)


class DecodeClock:
    """Sums the seconds spent in ``utils.io.load_frames`` (the streams'
    decode thread and the whole-burst decode) while installed."""

    def __init__(self):
        from libstacker_tpu_torch.utils import io

        self.io, self.orig, self.s = io, io.load_frames, 0.0

    def __enter__(self):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return self.orig(*a, **kw)
            finally:
                self.s += time.perf_counter() - t0

        self.io.load_frames = timed
        return self

    def __exit__(self, *exc):
        self.io.load_frames = self.orig


def timed_run(fn):
    """-> (result, wall s, launch counts, decode s), counters zeroed
    just before the run and read just after."""
    reset_counts()
    torch.cuda.synchronize()
    with DecodeClock() as clock:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return result, wall, read_counts(), clock.s


def phase_streams(dev):
    """Phase 24: the streams at full width from PNG files, each held
    against the whole-burst entry point on the same files, with its
    kernels' launches, wall, decode seconds and copy overlap; then one
    kill-and-resume, bitwise."""
    import dataclasses

    from libstacker_tpu_torch import (
        KeyPointMatchParameters, ecc_match, ecc_match_stream, keypoint_match,
        keypoint_match_stream,
    )
    from libstacker_tpu_torch.utils import io, native_loader
    from libstacker_tpu_torch.utils.synth import make_burst, make_textured_burst

    t_phase = time.perf_counter()
    frames, _ = make_burst(STREAM_N, FULL_H, FULL_W, seed=7, device=dev)
    draw_streak(frames, STREAM_N // 3)
    frames = frames.cpu().numpy()
    t0 = time.perf_counter()
    ecc_files = write_pngs(REPO / "build" / "smoke_stream_ecc", frames)
    kp = make_textured_burst(KP_N, FULL_H, FULL_W, seed=0, device=dev)[0]
    kp_files = write_pngs(REPO / "build" / "smoke_stream_kp", kp.cpu().numpy())
    write_s = time.perf_counter() - t0
    # the first chunk's frames also as JPEGs: the zlib reader gives them
    # ERR_FORMAT, and utils.io sends them to PIL's pool
    jpgs = write_pngs(REPO / "build" / "smoke_stream_jpg",
                      frames[:STREAM_CHUNK], "jpg")
    del frames, kp

    def per_file(paths):
        """s per file through the native route and through PIL's thread
        pool, in turns -> ({native: [s, s]}, the frames agree bitwise)."""
        per = {True: [], False: []}
        decoded = {}
        for native in (True, False, False, True):
            t0 = time.perf_counter()
            decoded[native] = io.load_frames(paths, use_native=native)
            per[native].append((time.perf_counter() - t0) / len(paths))
        return per, np.array_equal(decoded[True], decoded[False])

    # s per 4K PNG and JPEG, one chunk of the same files each, then PNG on
    # one thread
    chunk = ecc_files[:STREAM_CHUNK]
    per, png_same = per_file(chunk)
    per_jpg, jpg_same = per_file(jpgs)
    one = {}
    for native in (True, False):
        t0 = time.perf_counter()
        io.load_frames(chunk[:2], use_native=native, num_threads=1)
        one[native] = (time.perf_counter() - t0) / 2
    params = headline_params()
    sigma_p = dataclasses.replace(params, stacking="sigma_clip")
    c = 64
    results, lines, checks = {}, [], {}
    checks["4K PNG decode: native = PIL"] = png_same
    checks["4K JPEG decode: native route = PIL"] = jpg_same

    def record(label, stream_run, whole_run, need, compare):
        (got, wall, launches, dec) = timed_run(stream_run)
        (want, wall_w, _, dec_w) = timed_run(whole_run)
        good, note = compare(got, want)
        checks[label] = (good and not missing(launches, need)
                         and not stray(launches))
        results[label] = launches
        lines.append(
            f"{label}: stream {wall:.3f} s (decode {dec:.3f} s on the host "
            f"thread) vs whole-burst {wall_w:.3f} s (decode {dec_w:.3f} s) | "
            f"launches " + ", ".join(f"{k} {launches[k]}" for k in need)
            + f", orb_extract {launches['orb_extract']} | {note}")
        return got

    def ecc_mean_cmp(got, want):
        d = np.abs(got[0][c:-c, c:-c] - want[0][c:-c, c:-c])
        note = (f"kept {got[1].frames_kept}/{STREAM_N}, vs ecc_match(files) "
                f"interior max {d.max():.3e} (bar {STACK_MAX_BAR})")
        return (got[1].frames_kept == STREAM_N and d.max() < STACK_MAX_BAR
                and bool(np.isfinite(got[0]).all())
                and got[0].shape == (FULL_H, FULL_W, 3)), note

    def ecc_sigma_cmp(got, want):
        d = np.abs(got[0] - want[0])
        frac = float((d <= 1e-4).mean())
        note = (f"clipped {got[1].clipped_sample_frac:.3e} of samples (whole "
                f"{want[1].clipped_sample_frac:.3e}), vs ecc_match(files, "
                f"sigma_clip) within 1e-4 on {frac:.6f} (bar 0.999), max "
                f"{d.max():.3e} (bar 0.05)")
        return (frac > 0.999 and d.max() < 0.05
                and got[1].clipped_sample_frac > 0.0), note

    def kp_cmp(got, want):
        d = np.abs(got[1][c:-c, c:-c] - want[1][c:-c, c:-c])
        q = float(np.quantile(d, 0.99))
        note = (f"dropped {got[0]}, vs keypoint_match(files) interior p99 "
                f"{q:.4f} (bar 0.02), max {d.max():.3f} (bar 0.2)")
        return got[0] == want[0] == 0 and q < 0.02 and d.max() < 0.2, note

    mean = record(
        "ecc_match_stream",
        lambda: ecc_match_stream(ecc_files, params, chunk_size=STREAM_CHUNK,
                                 return_stats=True, device=dev),
        lambda: ecc_match(ecc_files, params, return_stats=True, device=dev),
        ("ecc_moments", "warp_accum"), ecc_mean_cmp)
    record(
        "ecc_match_stream sigma_clip",
        lambda: ecc_match_stream(ecc_files, sigma_p, chunk_size=STREAM_CHUNK,
                                 return_stats=True, device=dev),
        lambda: ecc_match(ecc_files, sigma_p, return_stats=True, device=dev),
        ("ecc_moments", "warp_moments"), ecc_sigma_cmp)
    record(
        "keypoint_match_stream",
        lambda: keypoint_match_stream(kp_files, KeyPointMatchParameters(),
                                      chunk_size=STREAM_CHUNK, device=dev),
        lambda: keypoint_match(kp_files, KeyPointMatchParameters(),
                               device=dev),
        KP_DETECT + ("warp_accum",), kp_cmp)
    if results["ecc_match_stream sigma_clip"]["warp_accum"]:
        checks["ecc sigma stream without B2"] = False

    # the host-to-device copies of the ECC mean stream against its kernels
    copy_ms, over_ms, kern_ms = copy_overlap(
        lambda: ecc_match_stream(ecc_files, params, chunk_size=STREAM_CHUNK,
                                 device=dev))

    # kill after two chunks, resume from the checkpoint: bitwise
    ck = REPO / "build" / "smoke_stream_ck.npz"
    ck.unlink(missing_ok=True)
    orig = io.prefetched_chunks

    def crashing(*a, **kw):
        for i, chunk in enumerate(orig(*a, **kw)):
            if i == 2:
                raise RuntimeError("simulated crash")
            yield chunk

    io.prefetched_chunks = crashing
    try:
        ecc_match_stream(ecc_files, params, chunk_size=STREAM_CHUNK,
                         checkpoint_path=ck, checkpoint_every=1, device=dev)
        crashed = False
    except RuntimeError:
        crashed = True
    finally:
        io.prefetched_chunks = orig
    saved = ck.exists()
    resumed = ecc_match_stream(ecc_files, params, chunk_size=STREAM_CHUNK,
                               checkpoint_path=ck, checkpoint_every=1,
                               device=dev)
    checks["kill-and-resume bitwise"] = (crashed and saved and not ck.exists()
                                         and np.array_equal(resumed, mean[0]))
    ok = all(checks.values())
    log(f"[24 decode] s per 4K RGB PNG (PIL, zlib level 1) over {len(chunk)} "
        f"files: native {native_loader.backend()!r} "
        + "/".join(f"{t:.4f}" for t in per[True])
        + f" (pool of {os.cpu_count()}), PIL "
        + "/".join(f"{t:.4f}" for t in per[False])
        + f" (thread pool of {min(len(chunk), os.cpu_count() or 1)}); one "
        f"thread: native {one[True]:.4f}, PIL {one[False]:.4f}; native = "
        f"PIL {png_same}")
    log(f"[24 decode] s per 4K RGB JPEG (PIL, quality 95) over {len(jpgs)} "
        f"files: native route ({native_loader.backend()!r}, PIL's pool for "
        f"what it does not take) "
        + "/".join(f"{t:.4f}" for t in per_jpg[True]) + ", PIL "
        + "/".join(f"{t:.4f}" for t in per_jpg[False])
        + f"; native route = PIL {jpg_same}")
    log(f"[24 streams] {STREAM_N}x{FULL_H}x{FULL_W} (a streak in frame "
        f"{STREAM_N // 3}) and {KP_N}x{FULL_H}x{FULL_W} textured u8 as PNG "
        f"(written in {write_s:.1f} s), chunk_size={STREAM_CHUNK}, headline / "
        f"default parameters; host-to-device copies of the ECC mean stream "
        f"{copy_ms:.2f} ms, {over_ms:.2f} ms of them under kernels "
        f"({over_ms / max(copy_ms, 1e-9):.2f}; kernels {kern_ms:.1f} ms); "
        f"kill after 2 chunks and resume: bitwise "
        f"{checks['kill-and-resume bitwise']} | phase "
        f"{time.perf_counter() - t_phase:.1f} s -> {'OK' if ok else 'FAILED'}")
    for line in lines:
        log(f"    {line}")
    if not ok:
        fail("a full-width stream missed a bar: "
             + ", ".join(k for k, v in checks.items() if not v))
    return results


def phase_cli(dev):
    """Phase 25: ``stack_burst.main`` in process on full-width frames,
    one blurred: it is ranked worst and dropped, keypoint drops none and
    the four PNGs are written.  Then the same burst as 48-bit PNGs (the
    8-bit frames in the high byte, seeded noise in the low) with
    ``--preserve-depth --out-depth 16``: the same checks, four 16-bit
    PNGs, each within the stack bar of the 8-bit run's image."""
    import concurrent.futures
    import contextlib
    import io as pyio
    import shutil

    from libstacker_tpu_torch import save_image, stack_burst
    from libstacker_tpu_torch.ops import filters
    from libstacker_tpu_torch.utils import io
    from libstacker_tpu_torch.utils.synth import make_textured_burst

    t_phase = time.perf_counter()
    frames, _ = make_textured_burst(CLI_N, FULL_H, FULL_W, seed=9, device=dev)
    blurred = 3
    f = frames[blurred].permute(2, 0, 1).float()
    frames[blurred] = filters.gaussian_blur(f, 9, 3.0).round().clamp(
        0, 255).to(torch.uint8).permute(1, 2, 0)
    d = REPO / "build" / "smoke_cli"
    shutil.rmtree(d, ignore_errors=True)
    frames = frames.cpu().numpy()
    write_pngs(d / "in", frames)
    rgb16 = (frames.astype(np.uint16) << 8) | np.random.default_rng(9).integers(
        0, 256, frames.shape, dtype=np.uint16)
    del frames
    (d / "in16").mkdir()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(CLI_N) as pool:
        list(pool.map(lambda i: save_image(d / "in16" / f"f{i:03d}.png",
                                           rgb16[i], bit_depth=16),
                      range(CLI_N)))
    write16_s = time.perf_counter() - t0
    del rgb16
    want = sorted(f"{m}_{t}.png" for m in ("keypoint", "ecc")
                  for t in ("full", "w400"))

    def run(src, out, extra):
        args = [str(src), "--out", str(out), "--device", dev.type,
                "--max-count", "50",
                "--epsilon", "1e-4", "--coarse-levels", "1", *extra]
        text = pyio.StringIO()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = stack_burst.main(args)
        wall = time.perf_counter() - t0
        launches = read_counts()
        lines = text.getvalue().splitlines()
        table = lines[lines.index(
            "Files ordered by TENG (low quality first)") + 1:]
        worst = table[0].split()[0]
        written = sorted(p.name for p in out.iterdir())
        kp_dropped = [ln for ln in lines if ln.startswith("keypoint_match(")]
        ok = (rc == 0 and worst.endswith(f"f{blurred:03d}.png")
              and f"stacking {CLI_N - 1} frames" in text.getvalue()
              and written == want and len(kp_dropped) == 2
              and all(ln.endswith(": 0") for ln in kp_dropped)
              and not missing(launches,
                              KP_DETECT + ("ecc_moments", "warp_accum"))
              and not stray(launches))
        log(f"    {' '.join(extra) or 'u8 frames'}: rc {rc}, ranked worst "
            f"{Path(worst).name}, {'; '.join(kp_dropped)}, wrote {written}, "
            f"in {wall:.2f} s | launches B1 {launches['ecc_moments']}, B2 "
            f"{launches['warp_accum']}, B8 {launches['fast']}, B3h "
            f"{launches['orb_harris']}, B3d {launches['orb_describe']}, B3 "
            f"{launches['orb_extract']} -> {'OK' if ok else 'FAILED'}")
        if not ok:
            fail("the CLI on the card missed a check:\n" + text.getvalue())
        return launches

    log(f"[25 stack_burst CLI] {CLI_N}x{FULL_H}x{FULL_W} PNGs, frame "
        f"{blurred} blurred, headline ECC flags; the 48-bit copies written "
        f"in {write16_s:.2f} s ({CLI_N} threads)")
    launches = {"stack_burst": run(d / "in", d / "out", [])}
    launches["stack_burst --preserve-depth"] = run(
        d / "in16", d / "out16", ["--preserve-depth", "--out-depth", "16"])
    c = 64
    worst = 0.0
    for name in want:
        img8 = io.load_frames([d / "out" / name])[0]
        img16 = io.load_frames([d / "out16" / name], preserve_depth=True)[0]
        diff = np.abs(img16[c:-c, c:-c] / 65535.0 - img8[c:-c, c:-c] / 255.0)
        worst = max(worst, float(diff.max()))
    ok = worst < STACK_MAX_BAR
    shutil.rmtree(d, ignore_errors=True)
    log(f"    16-bit images against the 8-bit run's: interior max "
        f"{worst:.4f} (bar {STACK_MAX_BAR}) | phase "
        f"{time.perf_counter() - t_phase:.1f} s -> {'OK' if ok else 'FAILED'}")
    if not ok:
        fail("the 16-bit workflow's images are off the 8-bit run's")
    return launches


# phase 26: the mesh at full width (bars: tests/test_mesh_public_api.py
# and tests/test_parallel.py)
MESH_ECC_ATOL = 2e-4
MESH_NCCL_N = 8
MESH_SPATIAL_N = 16
MESH_SOLVE_HW = (540, 960)
MESH_HALO = 64


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rows_frame(dev):
    """The row-band warp's input: one smoothed 2160x3840x3 float32 frame
    on ``dev`` (seed 7) and a forward map that rotates it by 1 degree,
    scales by 1.002 and moves rows 12 px up, across band edges."""
    img = smoothed_image(np.random.default_rng(7), FULL_H, FULL_W)
    rgb = torch.from_numpy(np.stack([img, img * 0.5, 255.0 - img], -1)).to(dev)
    ang = np.radians(1.0)
    a, b = 1.002 * np.cos(ang), 1.002 * np.sin(ang)
    cx, cy = FULL_W / 2.0, FULL_H / 2.0
    m3 = np.array([[a, b, (1 - a) * cx - b * cy + 3.5],
                   [-b, a, b * cx + (1 - a) * cy - 12.0],
                   [0, 0, 1]], np.float32)
    return rgb, m3


def phase_mesh(dev):
    """Phase 26: ``mesh=`` at full width on shards of the one card: the
    ECC headline over 3 shards, sigma-clip and SR x2 over 4, the keypoint
    path over 4, ``mesh="auto"``, a one-process NCCL group, the ECC mean
    stream over 4 shards, and the row bands (4 bands of the card).  Each
    case against the port's dense path; walls of shards that share one
    card are no speed figure."""
    import dataclasses

    import torch.distributed as dist

    from libstacker_tpu_torch import (
        KeyPointMatchParameters, MotionType, ecc_match, ecc_match_arrays,
        ecc_match_stream, keypoint_match_arrays, sharpness_tenengrad,
    )
    from libstacker_tpu_torch.models import _entry
    from libstacker_tpu_torch.ops import color, ecc as ecc_ops, phasecorr
    from libstacker_tpu_torch.ops import warp, warp_batch, warp_cuda
    from libstacker_tpu_torch.parallel import mesh as pmesh
    from libstacker_tpu_torch.utils.synth import make_burst, make_textured_burst

    t_phase = time.perf_counter()
    card = [dev] * 4
    mesh3, mesh4 = pmesh.make_mesh(card[:3]), pmesh.make_mesh(card)
    params = headline_params()
    lines, checks, results = [], {}, {}

    def case(label, run, need, judge):
        """Run ``run`` cold, then warm with the counters zeroed just
        before and read just after; ``judge(result) -> (good, note)``."""
        result, cold_s, warm_s, launches = drive(run)
        good, note = judge(result)
        checks[label] = good and not missing(launches, need) \
            and not stray(launches)
        results[f"mesh {label}"] = launches
        lines.append(
            f"{label}: cold {cold_s:.3f} s, warm {warm_s:.3f} s | launches "
            + ", ".join(f"{k} {launches[k]}" for k in need)
            + f" | {note} -> {'OK' if checks[label] else 'FAILED'}")
        return result

    # the ECC headline over 3 shards: 100 lanes + 2 pad lanes
    frames, _ = make_burst(FULL_N, FULL_H, FULL_W, seed=0, device=dev)
    dense, dstats = ecc_match_arrays(frames, params, return_stats=True,
                                     device_output=True)

    def ecc_cmp(res):
        out, st = res
        d = float((out - dense).abs().max())
        note = (f"kept {st.frames_kept}/{FULL_N} (dense "
                f"{dstats.frames_kept}), vs dense max abs {d:.3e} (bar "
                f"{MESH_ECC_ATOL}), iterations equal "
                f"{st.ecc_iterations == dstats.ecc_iterations}")
        return (st.frames_kept == dstats.frames_kept == FULL_N
                and d <= MESH_ECC_ATOL), note

    case("ecc headline, 3 shards",
         lambda: ecc_match_arrays(frames, params, return_stats=True,
                                  device_output=True, mesh=mesh3),
         ("ecc_moments", "warp_accum"), ecc_cmp)
    # are the sharded solves' warps the dense ones, bit for bit?
    grey = color.burst_grey_u8(frames).to(torch.float32)
    solve = dict(motion_type=params.motion_type, num_iters=50, eps=1e-4,
                 gauss_filt_size=5, coarse_levels=1)
    init = phasecorr.phase_init_warps(grey[1:], grey[0], params.motion_type)
    dres = ecc_ops.find_transform_ecc_batched(
        grey[1:], grey[0], warp_init=init, **solve)
    padded, _ = _entry.pad_burst(frames, 3)
    mw = pmesh._ecc_solve_gathered(
        pmesh.shard_frames(padded, mesh3), grey[0], mesh3, phase_init=True,
        phase_init_rotation=False, scale_hw=None, input_mask=None,
        mode=None, **solve)[0]
    dw = dres.warp_matrix.cpu().numpy()
    warp_bitwise = bool(np.array_equal(mw[1:FULL_N], dw))
    warp_diff = float(np.abs(mw[1:FULL_N] - dw).max())
    del grey, init, dres, padded
    lines.append(f"    the sharded warps bitwise the dense ones: "
                 f"{warp_bitwise} (max diff {warp_diff:.3e})")

    # mesh="auto" on the card: a one-device mesh
    def auto_cmp(res):
        out, st = res
        same = bool(torch.equal(out, dense))
        d = float((out - dense).abs().max())
        return (same or d <= MESH_ECC_ATOL) and st.frames_kept == FULL_N, (
            f"bitwise the dense path {same} (max abs {d:.3e}; bar "
            f"{MESH_ECC_ATOL} where not bitwise)")

    case("ecc mesh='auto'",
         lambda: ecc_match_arrays(frames, params, return_stats=True,
                                  device_output=True, mesh="auto"),
         ("ecc_moments", "warp_accum"), auto_cmp)

    # sigma-clip over 4 shards on the streaked burst
    dirty = frames.clone()
    for i in STREAK_FRAMES:
        draw_streak(dirty, i)
    sig_p = dataclasses.replace(params, stacking="sigma_clip",
                                sigma_kappa=2.5, sigma_iters=1)
    sig_dense = ecc_match_arrays(dirty, sig_p, device_output=True)

    def sig_cmp(out):
        d = (out - sig_dense).abs()
        frac = float((d <= MESH_ECC_ATOL).float().mean())
        return frac > 0.99 and float(d.max()) < 0.05, (
            f"vs dense within 2e-4 on {frac:.6f} (bar 0.99), max "
            f"{float(d.max()):.3e} (bar 0.05)")

    case("ecc sigma-clip, 4 shards",
         lambda: ecc_match_arrays(dirty, sig_p, device_output=True,
                                  mesh=mesh4),
         ("ecc_moments", "warp_moments"), sig_cmp)
    del dirty, sig_dense

    # super-resolution x2 over 4 shards: B6's deposit form per shard
    sr_p = dataclasses.replace(params, output_scale=2)
    sr_frames = frames[:SR_FRAMES].contiguous()
    sr_dense = ecc_match_arrays(sr_frames, sr_p, device_output=True)

    def sr_cmp(out):
        d = (out - sr_dense).abs()
        mean, q = float(d.mean()), float(torch.quantile(
            d.flatten()[::7], 0.999))
        return mean < 2e-4 and q < 5e-3, (
            f"vs dense mean {mean:.3e} (bar 2e-4), 0.999 quantile "
            f"{q:.3e} (bar 5e-3, every 7th value)")

    case("ecc SR x2, 4 shards",
         lambda: ecc_match_arrays(sr_frames, sr_p, device_output=True,
                                  mesh=mesh4),
         ("ecc_moments", "sr_deposit"), sr_cmp)
    checks["SR without the image form"] = results[
        "mesh ecc SR x2, 4 shards"]["sr_image"] == 0
    del sr_frames, sr_dense

    # one-process NCCL: init, global mesh, global shards, the step
    ref_grey = color.rgb_to_gray_u8(frames[0]).to(torch.float32)
    local = frames[:MESH_NCCL_N].contiguous()
    kw = dict(motion_type=params.motion_type, num_iters=50, eps=1e-4,
              coarse_levels=1)
    one, one_ok = pmesh.ecc_stack_step(local, ref_grey,
                                       pmesh.make_mesh([dev]), **kw)
    pmesh.init_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        backend = dist.get_backend()

        def nccl_run():
            gm = pmesh.make_global_mesh()
            return pmesh.ecc_stack_step(pmesh.shard_frames_global(local, gm),
                                        ref_grey, gm, **kw)

        res, cold_s, warm_s, launches = drive(nccl_run)
        same = bool(torch.equal(res[0], one)) and np.array_equal(res[1],
                                                                  one_ok)
        checks["nccl"] = (backend == "nccl" and same and bool(one_ok.all())
                          and not missing(launches,
                                          ("ecc_moments", "warp_accum")))
        results["mesh one-process NCCL"] = launches
        lines.append(
            f"one-process {backend} group ({MESH_NCCL_N} frames, world 1): "
            f"cold {cold_s:.3f} s, warm {warm_s:.3f} s | launches "
            f"ecc_moments {launches['ecc_moments']}, warp_accum "
            f"{launches['warp_accum']} | equal to the one-process mesh "
            f"{same} -> {'OK' if checks['nccl'] else 'FAILED'}")
    finally:
        dist.destroy_process_group()
    del frames, local, dense

    # the keypoint path over 4 shards
    kp, _ = make_textured_burst(KP_N, FULL_H, FULL_W, seed=0, device=dev)
    kd_drop, kdense = keypoint_match_arrays(kp, KeyPointMatchParameters(),
                                            device_output=True)

    def kp_cmp(res):
        drop, out = res
        d = (out - kdense).abs()
        mean, mx = float(d.mean()), float(d.max())
        return drop == kd_drop and mean < 5e-3 and mx < 0.06, (
            f"dropped {drop} (dense {kd_drop}), vs dense mean {mean:.3e} "
            f"(bar 5e-3), max {mx:.3e} (bar 0.06)")

    case("keypoint, 4 shards",
         lambda: keypoint_match_arrays(kp, KeyPointMatchParameters(),
                                       device_output=True, mesh=mesh4),
         KP_DETECT + ("warp_accum",), kp_cmp)
    del kp, kdense

    # the ECC mean stream over 4 shards on phase 24's PNG files
    files = sorted(str(p) for p in
                   (REPO / "build" / "smoke_stream_ecc").glob("*.png"))
    whole = ecc_match(files, params, device=dev)
    c = 64

    def stream_cmp(res):
        out, st = res
        d = float(np.abs(out[c:-c, c:-c] - whole[c:-c, c:-c]).max())
        return len(files) == STREAM_N and st.frames_kept == STREAM_N and \
            d < STACK_MAX_BAR, (
                f"{len(files)} files, kept {st.frames_kept}, vs "
                f"ecc_match(files) interior max {d:.3e} (bar "
                f"{STACK_MAX_BAR})")

    case(f"ecc stream, 4 shards, chunk_size={STREAM_CHUNK}",
         lambda: ecc_match_stream(files, params, chunk_size=STREAM_CHUNK,
                                  return_stats=True, mesh=mesh4),
         ("ecc_moments", "warp_accum"), stream_cmp)

    # the row bands: 4 bands of the card
    rows = pmesh.make_mesh(card, data=1, spatial=4)
    rgb, m3 = rows_frame(dev)
    minv = warp.invert_3x3(torch.from_numpy(m3).to(dev))
    want = warp_cuda.warp_bilinear(
        rgb.permute(2, 0, 1).contiguous(), minv.expand(3, 3, 3).contiguous()
    ).permute(1, 2, 0)

    def rows_cmp(out):
        # every tap of the 1-degree map lies within the halo: each band
        # is the dense warp's rows, bit for bit
        same = bool(torch.equal(out.view(torch.int32), want.view(torch.int32)))
        return same, (f"vs the dense warp: bitwise {same} (max diff "
                      f"{float((out - want).abs().max()):.3e})")

    case(f"warp_rows_sharded, {FULL_H}x{FULL_W}x3 f32, halo {MESH_HALO}",
         lambda: pmesh.warp_rows_sharded(rgb, m3, rows, halo=MESH_HALO),
         ("warp",), rows_cmp)
    band = profile_line(
        f"row warp's B5, 4 bands of 3 planes of {FULL_H // 4}x{FULL_W} "
        f"from strips of {FULL_H // 4 + 2 * MESH_HALO} rows",
        lambda: pmesh.warp_rows_sharded(rgb, m3, rows, halo=MESH_HALO),
        "::warp_kernel<")
    lines.append(f"row warp's B5: {band['kernel_device_ms'] / 4:.4f} ms of "
                 f"device time a band")
    del rgb, want

    greys = color.rgb_to_gray_u8(make_burst(FULL_N, FULL_H, FULL_W, seed=0,
                                            device=dev)[0]).to(torch.float32)
    teng = sharpness_tenengrad(greys).cpu().numpy()
    grid = pmesh.make_mesh(card, data=2, spatial=2)

    def teng_cmp(got):
        rel = float(np.abs(got / teng - 1.0).max())
        return rel < 1e-5, f"vs sharpness_tenengrad max rel {rel:.2e} " \
            f"(bar 1e-5)"

    case(f"sharpness_teng_spatial, {FULL_N} greys, data 2 x spatial 2",
         lambda: pmesh.sharpness_teng_spatial(greys, grid), (), teng_cmp)
    del greys

    burst, truth = make_burst(MESH_SPATIAL_N, FULL_H, FULL_W, seed=3,
                              device=dev, max_shift=2.0, max_angle=0.0)
    tp = dataclasses.replace(params, motion_type=MotionType.Translation,
                             coarse_levels=0, epsilon=1e-5)
    sdense = ecc_match_arrays(burst, tp, scale_down_width=min(MESH_SOLVE_HW),
                              device_output=True)
    tw = torch.from_numpy(truth[1:, :2].astype(np.float32)).to(dev)
    tstack = warp_batch.warp_sum_burst(
        burst, tw, torch.ones(MESH_SPATIAL_N - 1, dtype=torch.bool,
                              device=dev), perspective=False)
    tstack = tstack / MESH_SPATIAL_N
    mg = 4

    def spatial_cmp(res):
        total, ok = res
        got = total / (1 + int(ok.sum()))
        d = float((got - sdense)[mg:-mg, mg:-mg].abs().max())
        q = float(torch.quantile(
            (got - tstack)[mg:-mg, mg:-mg].abs().flatten()[::5], 0.99))
        return bool(ok.all()) and d < 1e-5 and q < 0.005, (
            f"kept {int(ok.sum())}/{MESH_SPATIAL_N - 1}, vs the dense scaled "
            f"path interior max {d:.3e} (bar 1e-5), vs the known shifts p99 "
            f"{q:.3e} (bar 0.005)")

    case(f"ecc_stack_step_spatial, {MESH_SPATIAL_N} frames, solve grid "
         f"{MESH_SOLVE_HW[0]}x{MESH_SOLVE_HW[1]}, halo {MESH_HALO}",
         lambda: pmesh.ecc_stack_step_spatial(
             burst[1:], burst[0], rows, MESH_SOLVE_HW,
             motion_type=MotionType.Translation, num_iters=50, eps=1e-5,
             halo=MESH_HALO),
         ("ecc_moments", "warp_frames_accum"), spatial_cmp)
    del burst, sdense, tstack

    ok = all(checks.values())
    log(f"[26 mesh] shards of one {torch.cuda.get_device_name(0)} "
        f"(walls of shards sharing one card are no speed figure) | phase "
        f"{time.perf_counter() - t_phase:.1f} s -> "
        f"{'OK' if ok else 'FAILED'}")
    for line in lines:
        log(f"    {line}")
    if not ok:
        fail("a mesh case missed a bar: "
             + ", ".join(k for k, v in checks.items() if not v))
    return results


# phase 27: a mesh row across two processes of the one card under gloo
DCN_RANKS = 2
DCN_N = 8  # the first 8 frames of phase 5's burst
DCN_TIMEOUT_S = 180
DCN_KERNELS = ("ecc_moments", "warp", "warp_frames_accum")


def dcn_inputs(dev):
    """Phase 27's inputs, rebuilt from their seeds in every process:
    the row-band frame and its map, the grey of the first 8 frames of
    phase 5's burst, and those frames."""
    from libstacker_tpu_torch.ops import color
    from libstacker_tpu_torch.utils.synth import make_burst

    rgb, m3 = rows_frame(dev)
    burst, _ = make_burst(DCN_N, FULL_H, FULL_W, seed=0, device=dev)
    greys = color.rgb_to_gray_u8(burst).to(torch.float32)
    return rgb, m3, greys, burst


def dcn_run(mesh, inputs) -> dict:
    """The three row-band functions on ``mesh``: ``warp_rows_sharded``,
    ``sharpness_teng_spatial``, ``ecc_stack_step_spatial`` (frames 1-7
    against frame 0, phase 5's motion model, solved at 540x960)."""
    from libstacker_tpu_torch.parallel import mesh as pmesh

    rgb, m3, greys, burst = inputs
    warped = pmesh.warp_rows_sharded(rgb, m3, mesh, halo=MESH_HALO)
    teng = pmesh.sharpness_teng_spatial(greys, mesh)
    total, ok = pmesh.ecc_stack_step_spatial(
        burst[1:], burst[0], mesh, MESH_SOLVE_HW,
        motion_type=headline_params().motion_type, halo=MESH_HALO)
    return dict(warp=warped, teng=torch.from_numpy(teng), ecc=total,
                ok=torch.from_numpy(ok))


def dcn_worker(rank: int, port: int, outdir: str) -> int:
    """One rank of phase 27 (``chip_smoke.py --dcn-worker RANK PORT
    DIR``): joins a gloo group of 2, builds ``make_global_mesh(data=1,
    spatial=2)`` on ``cuda:0``, runs the three functions cold, then warm
    with the launch counters zeroed just before and read just after, and
    writes the warm results, the counts and the walls into ``DIR``."""
    import torch.distributed as dist

    from libstacker_tpu_torch.parallel import mesh as pmesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    pmesh.init_distributed(f"127.0.0.1:{port}", DCN_RANKS, rank,
                           backend="gloo")
    try:
        mesh = pmesh.make_global_mesh(data=1, spatial=DCN_RANKS,
                                      devices=[dev])
        assert mesh.spans and mesh.s0 == rank, mesh
        inputs = dcn_inputs(dev)
        got, cold_s, warm_s, launches = drive(lambda: dcn_run(mesh, inputs))
    finally:
        dist.destroy_process_group()
    out = Path(outdir) / f"rank{rank}"
    out.mkdir(parents=True, exist_ok=True)
    for k, v in got.items():
        np.save(out / f"{k}.npy", v.cpu().numpy())
    (out / "run.json").write_text(json.dumps(dict(
        cold_s=cold_s, warm_s=warm_s, launches=launches,
        shape=mesh.shape, s0=mesh.s0)))
    return 0


def phase_dcn(dev):
    """Phase 27: a mesh row across processes.  Two worker processes of
    this script, each with ``devices=["cuda:0"]`` under gloo, build
    ``make_global_mesh(data=1, spatial=2)`` and run the three row-band
    functions at full width; each result must equal this process's
    one-process ``make_mesh([dev] * 2, data=1, spatial=2)`` and the
    other rank's bitwise.  A worker that fails or passes its timeout
    fails the phase."""
    import shutil

    from libstacker_tpu_torch.ops import warp, warp_cuda
    from libstacker_tpu_torch.parallel import mesh as pmesh

    t_phase = time.perf_counter()
    inputs = dcn_inputs(dev)
    one, cold_s, warm_s, one_launches = drive(
        lambda: dcn_run(pmesh.make_mesh([dev] * 2, data=1, spatial=2),
                        inputs))
    # the one-process row warp against the dense warp, bit for bit
    rgb, m3 = inputs[0], inputs[1]
    minv = warp.invert_3x3(torch.from_numpy(m3).to(dev))
    dense = warp_cuda.warp_bilinear(
        rgb.permute(2, 0, 1).contiguous(), minv.expand(3, 3, 3).contiguous()
    ).permute(1, 2, 0)
    one_dense = bool(torch.equal(one["warp"].view(torch.int32),
                                 dense.view(torch.int32)))
    del inputs, rgb, dense
    torch.cuda.empty_cache()
    outdir = REPO / "build" / "smoke_dcn"
    shutil.rmtree(outdir, ignore_errors=True)
    port = free_port()
    t_workers = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--dcn-worker",
         str(r), str(port), str(outdir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(DCN_RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, DCN_TIMEOUT_S
                            - (time.perf_counter() - t_workers)))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        fail(f"phase 27: a worker passed its {DCN_TIMEOUT_S} s timeout")
    workers_s = time.perf_counter() - t_workers
    if any(p.returncode != 0 for p in procs):
        fail("phase 27: a worker failed:\n" + "\n".join(
            f"[rank {r} exit {p.returncode}] {o[-3000:]}"
            for r, (p, o) in enumerate(zip(procs, outs))))
    lines, good, results = [], True, {}
    for r in range(DCN_RANKS):
        d = outdir / f"rank{r}"
        run = json.loads((d / "run.json").read_text())
        equal = {}
        for k, v in one.items():
            got = torch.from_numpy(np.load(d / f"{k}.npy"))
            want = v.cpu()
            equal[k] = bool(torch.equal(got, want))
            if not equal[k] and got.shape == want.shape \
                    and got.is_floating_point():
                equal[k] = f"max diff {float((got - want).abs().max()):.3e}"
        launches = run["launches"]
        results[f"mesh rank {r} of 2 processes"] = launches
        ok_r = (all(v is True for v in equal.values())
                and run["shape"] == {"data": 1, "spatial": 2}
                and run["s0"] == r and not missing(launches, DCN_KERNELS))
        good = good and ok_r
        lines.append(
            f"rank {r} (bands from {run['s0']}): cold {run['cold_s']:.3f} "
            f"s, warm {run['warm_s']:.3f} s | launches "
            + ", ".join(f"{k} {launches[k]}" for k in DCN_KERNELS)
            + " | bitwise the one-process mesh: "
            + ", ".join(f"{k} {v}" for k, v in equal.items())
            + f" -> {'OK' if ok_r else 'FAILED'}")
    one_ok = bool(one["ok"].all())
    good = good and one_ok and one_dense
    shutil.rmtree(outdir, ignore_errors=True)
    log(f"[27 spatial across processes] warp_rows_sharded "
        f"({FULL_H}x{FULL_W}x3 f32), sharpness_teng_spatial ({DCN_N} "
        f"greys), ecc_stack_step_spatial (frames 1-{DCN_N - 1} of phase "
        f"5's burst, solve grid {MESH_SOLVE_HW[0]}x{MESH_SOLVE_HW[1]}, halo "
        f"{MESH_HALO}) on make_global_mesh(data=1, spatial=2) of "
        f"{DCN_RANKS} gloo processes on one "
        f"{torch.cuda.get_device_name(0)} | one-process mesh: cold "
        f"{cold_s:.3f} s, warm {warm_s:.3f} s, launches "
        + ", ".join(f"{k} {one_launches[k]}" for k in DCN_KERNELS)
        + f", kept {int(one['ok'].sum())}/{DCN_N - 1}, row warp bitwise "
        f"the dense warp {one_dense} | workers "
        f"{workers_s:.1f} s | phase {time.perf_counter() - t_phase:.1f} s "
        f"-> {'OK' if good else 'FAILED'}")
    for line in lines:
        log(f"    {line}")
    if not good:
        fail("phase 27: a rank's results differ from the one-process mesh, "
             "its row warp from the dense warp, or a kernel of the path did "
             "not launch")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dcn-worker", nargs=3, metavar=("RANK", "PORT", "DIR"),
                    default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    try:
        import libstacker_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside the script "
              f"({e})", file=sys.stderr)
        return 1
    from libstacker_tpu_torch.utils.device import resolve_device

    if args.dcn_worker:
        rank, port, outdir = args.dcn_worker
        return dcn_worker(int(rank), int(port), outdir)
    dev = resolve_device("cuda")
    smi = phase_device()
    torch.cuda.synchronize()
    b1 = phase_b1(dev)
    torch.cuda.synchronize()
    b2 = phase_b2(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    b2["affine_4000x6000"] = phase_wide_affine(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    phase_slice_parity(dev)
    torch.cuda.synchronize()
    launches, ecc_frames, ecc_truth, ecc_clean = phase_full(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    blur = phase_blur(dev, ecc_frames)
    torch.cuda.synchronize()
    frames, truth, grey = textured_grey(dev)
    b8 = phase_b8(dev, grey)
    torch.cuda.empty_cache()
    b3, b3h, b3d = phase_b3(dev, grey)
    del grey
    torch.cuda.empty_cache()
    phase_kp_parity(dev)
    kp, kp_ref, kp_out = phase_kp_full(dev, frames, truth)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    refit = phase_refit(dev, frames)
    torch.cuda.empty_cache()
    b4 = phase_b4(dev, ecc_frames, ecc_truth)
    torch.cuda.empty_cache()
    b5, b5f, b5a = phase_b5(dev, frames, truth)
    torch.cuda.empty_cache()
    b9 = phase_b9(dev, frames)
    torch.cuda.empty_cache()
    b1m = phase_b1_masked(dev)
    torch.cuda.empty_cache()
    sigma = phase_ecc_sigma(dev, ecc_frames, ecc_clean)
    torch.cuda.empty_cache()
    masked = phase_ecc_mask(dev, ecc_frames)
    torch.cuda.empty_cache()
    b7, b1_lite = phase_b7(dev)
    torch.cuda.empty_cache()
    b6, b6i = phase_b6(dev, ecc_frames)
    torch.cuda.empty_cache()
    ecc_sr = phase_ecc_sr(dev, ecc_frames)
    torch.cuda.empty_cache()
    solvers = phase_solvers(dev, ecc_frames, ecc_clean)
    torch.cuda.empty_cache()
    sharp = phase_sharpness(dev, ecc_frames)
    del ecc_frames, ecc_clean
    torch.cuda.empty_cache()
    kp_var = phase_kp_variants(dev, frames, truth, kp_ref)
    torch.cuda.empty_cache()
    kp_sr = phase_kp_sr(dev, frames, kp_out)
    del frames, truth, kp_ref, kp_out
    torch.cuda.empty_cache()
    files = phase_files(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    streams = phase_streams(dev)
    torch.cuda.empty_cache()
    cli = phase_cli(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mesh = phase_mesh(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    dcn = phase_dcn(dev)
    torch.cuda.synchronize()
    by_path = {"ecc_match_arrays": launches,
               **{f"keypoint_match_arrays {k}": v for k, v in kp.items()},
               "ecc_match_arrays sigma_clip": sigma,
               "ecc_match_arrays mask": masked,
               **{f"keypoint_match_arrays {k}": v for k, v in kp_var.items()},
               "ecc_match_arrays output_scale=2": ecc_sr,
               **{f"ecc_match_arrays {k}": v for k, v in solvers.items()},
               "keypoint_match_arrays output_scale=2": kp_sr,
               **files, **streams, **cli, **mesh, **dcn}

    def counts(name):
        per = {path: c[name] for path, c in by_path.items() if c[name]}
        return dict(launches=sum(per.values()), launches_by_path=per)

    kernels = [
        dict(name="ecc_moments", route="cuda",
             source="libstacker_tpu_torch/csrc/ecc_moments.cu",
             replaces="libstacker_tpu/ops/ecc_pallas.py:92",
             **counts("ecc_moments"), **b1),
        dict(name="warp_accum", route="cuda",
             source="libstacker_tpu_torch/csrc/warp_accum.cu",
             replaces="libstacker_tpu/ops/warp_accum_pallas.py:47",
             **counts("warp_accum"), **b2),
        dict(name="fast", route="cuda",
             source="libstacker_tpu_torch/csrc/fast.cu",
             replaces="libstacker_tpu/ops/fast_pallas.py:52",
             **counts("fast"), **b8),
        dict(name="orb_extract", route="cuda",
             source="libstacker_tpu_torch/csrc/orb_extract.cu",
             replaces="libstacker_tpu/ops/orb_pallas.py:54",
             replaces_note="on no entry point's path since B3h / B3d",
             **counts("orb_extract"), **b3),
        dict(name="orb_harris", route="cuda",
             source="libstacker_tpu_torch/csrc/orb_describe.cu",
             replaces="libstacker_tpu/ops/orb_pallas.py:54",
             replaces_note="_extract_kernel's windows at the candidates "
                           "with the Harris response the JAX package "
                           "takes from them (libstacker_tpu/ops/fast.py:237) "
                           "and its top-k of the level's keypoints "
                           "(libstacker_tpu/ops/orb.py:270-272)",
             **counts("orb_harris"), **b3h),
        dict(name="orb_describe", route="cuda",
             source="libstacker_tpu_torch/csrc/orb_describe.cu",
             replaces="libstacker_tpu/ops/orb_pallas.py:54",
             replaces_note="_extract_kernel's windows at the kept keypoints "
                           "with the IC angle, blur and rBRIEF the JAX "
                           "package takes from them "
                           "(libstacker_tpu/ops/orb.py:99-153)",
             **counts("orb_describe"), **b3d),
        dict(name="warp_moments", route="cuda",
             source="libstacker_tpu_torch/csrc/warp_accum.cu",
             replaces="libstacker_tpu/ops/warp_accum_pallas.py:47",
             replaces_note="_warp_accum_kernel with moments=True, via "
                           "warp_moments_rgb_pallas (:291)",
             **counts("warp_moments"), **b4),
        dict(name="warp", route="cuda",
             source="libstacker_tpu_torch/csrc/warp.cu",
             replaces="libstacker_tpu/ops/warp_pallas.py:217",
             replaces_note="the planar form: on the row-band warp "
                           "(parallel.warp_rows_sharded); the entry points "
                           "run the interleaved forms",
             **counts("warp"), **b5),
        dict(name="warp_frames", route="cuda",
             source="libstacker_tpu_torch/csrc/warp.cu",
             replaces="libstacker_tpu/ops/warp_pallas.py:217",
             replaces_note="_warp_kernel as warp_frames_batch calls it "
                           "(libstacker_tpu/ops/warp_batch.py:231), one "
                           "slot per plane",
             **counts("warp_frames"), **b5f),
        dict(name="warp_frames_accum", route="cuda",
             source="libstacker_tpu_torch/csrc/warp.cu",
             replaces="libstacker_tpu/ops/warp_pallas.py:217",
             replaces_note="_warp_kernel in the keypoint path's "
                           "index-mapping stack and the sum after it "
                           "(libstacker_tpu/models/keypoint.py:277-285)",
             **counts("warp_frames_accum"), **b5a),
        dict(name="warp3", route="cuda",
             source="libstacker_tpu_torch/csrc/warp.cu",
             replaces="libstacker_tpu/ops/warp_pallas.py:475",
             replaces_note="on no entry point's path (the JAX package "
                           "calls it only from tests)",
             **counts("warp3"), **b9),
        dict(name="ecc_moments_masked", route="cuda",
             source="libstacker_tpu_torch/csrc/ecc_moments.cu",
             replaces="libstacker_tpu/ops/ecc_pallas.py:202",
             replaces_note="_moments_kernel with n_src == 4 (:202-247)",
             **counts("ecc_moments_masked"), **b1m),
        dict(name="ecc_moments_lite", route="cuda",
             source="libstacker_tpu_torch/csrc/ecc_moments.cu",
             replaces="libstacker_tpu/ops/ecc_pallas.py:92",
             replaces_note="_moments_kernel with with_hessian=False (the "
                           "lazy solver's sweep)",
             **counts("ecc_moments_lite"), **b1_lite),
        dict(name="ecc_blur", route="cuda",
             source="libstacker_tpu_torch/csrc/ecc_blur.cu",
             replaces=None,
             replaces_note="no TPU kernel: the JAX package's XLA-level "
                           "jnp blur of the input image and the templates "
                           "(libstacker_tpu/ops/ecc.py:236 _input_fields "
                           "and the solve's template prep)",
             **counts("ecc_blur"), **blur),
        dict(name="ransac_dlt", route="cuda",
             source="libstacker_tpu_torch/csrc/ransac_refit.cu",
             replaces=None,
             replaces_note="no TPU kernel: the JAX package's XLA-level "
                           "jnp eigh of the weighted DLT's Gram "
                           "(libstacker_tpu/ops/ransac.py:93 "
                           "_dlt_least_squares)",
             **counts("ransac_dlt"), **refit["dlt"]),
        dict(name="ransac_refine", route="cuda",
             source="libstacker_tpu_torch/csrc/ransac_refit.cu",
             replaces=None,
             replaces_note="no TPU kernel: the JAX package's XLA-level "
                           "jnp Gauss-Newton polish, ten 8x8 solves "
                           "(libstacker_tpu/ops/ransac.py:109 "
                           "_gauss_newton_refine)",
             **counts("ransac_refine"), **refit["refine"]),
        dict(name="sharpness", route="cuda",
             source="libstacker_tpu_torch/csrc/sharpness.cu",
             replaces=None,
             replaces_note="no TPU kernel: the JAX package's XLA-level "
                           "jnp metrics (libstacker_tpu/ops/sharpness.py"
                           ":38-97)",
             **counts("sharpness"), **sharp),
        dict(name="ecc_ic_moments", route="cuda",
             source="libstacker_tpu_torch/csrc/ecc_ic_moments.cu",
             replaces="libstacker_tpu/ops/ecc_pallas.py:460",
             **counts("ecc_ic_moments"), **b7),
        dict(name="sr_deposit", route="cuda",
             source="libstacker_tpu_torch/csrc/sr_deposit.cu",
             replaces="libstacker_tpu/ops/sr_pallas.py:47",
             replaces_note="the deposit form: on the mesh's "
                           "super-resolution path (each shard deposits, the "
                           "sums are reduced, then normalised once); the "
                           "one-device path runs the image form",
             **counts("sr_deposit"), **b6),
        dict(name="sr_image", route="cuda",
             source="libstacker_tpu_torch/csrc/sr_deposit.cu",
             replaces="libstacker_tpu/ops/sr_pallas.py:47",
             replaces_note="_sr_kernel's sweep with the normalisation the "
                           "JAX package runs after it "
                           "(libstacker_tpu/ops/stack.py:474)",
             **counts("sr_image"), **b6i),
    ]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
