#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):

1. device: card name and power limit (``nvidia-smi``), torch / CUDA
   versions, and the ``nvcc`` build of the four kernels from ``csrc/``
   (one ``nvcc`` per source, all started together);
2. kernel B1 (``ecc_moments.cu``) against its plain PyTorch version at
   the main path's full-resolution shape (99 homography lanes of
   2160x3840, one of them inactive) plus one affine lane;
3. kernel B2 (``warp_accum.cu``) against its plain version at the main
   path's shape (99 u8 frames of 2160x3840, one dropped), and its
   u8-source result against its f32-source result (must be bitwise
   equal);
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
   some centres at the clamp edges);
8. the keypoint slice on CUDA against the port's own CPU path on a
   4x540x960 burst (``ok`` flags, corners mapped by H, stacked
   interior);
9. the full keypoint slice: 20x2160x3840 through ``keypoint_match_arrays``
   with the default parameters, at full resolution and with
   ``scale_down_width=800``, each cold and warm, with the kernels'
   launch counters of the warm runs, the homographies against the
   burst's true warps (image corners within the RANSAC threshold on the
   detection grid) and the stack against the ground-truth-warp stack.

Each kernel record carries its time (CUDA events), its plain version's
time, the bound of the same work at the card's published rates (bytes
over 3.35 TB/s, operations over 67 T/s, the larger of the two) and the
time of one PyTorch call computing the same function where one exists.
The last two lines are the kernel record and the device record (JSON).
The script needs CUDA and the repository beside it; without either it
exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
KERNELS = ("ecc_moments", "warp_accum", "fast", "orb_extract")

# headline configuration (bench.py:181-290): 100 frames of 4K
FULL_N, FULL_H, FULL_W = 100, 2160, 3840
SLICE_N, SLICE_H, SLICE_W = 8, 1080, 1920
# keypoint bench configuration (bench.py:499-560,
# benchmarks/bench_keypoint.py:19-45): 20 textured frames of 4K
KP_N = 20
KP_SLICE_N, KP_SLICE_H, KP_SLICE_W = 4, 540, 960
KP_K, KP_RADIUS, KP_T, KP_B = 218, 21, 20, 31  # level 0: 2 x quota 109
# the kernels see frames 1..N-1 of the burst on the main path
KERNEL_LANES = FULL_N - 1
KERNEL_FRAMES = FULL_N - 1

# bars (bench.py:166-167, tests/test_ecc_pallas.py:176-178,
# tests/test_pipeline_ecc.py:73-74)
MOMENT_REL_BAR = 1e-4
ACCUM_MAX_BAR = 1e-3
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

    worst_rel = stats_rel = max_abs = 0.0
    for motion, mats, act in (
        (MotionType.Homography, m3, active),
        (MotionType.Affine, aff, None),
    ):
        kw = dict(quant_affine=motion != MotionType.Homography, active=act)
        got = ecc_cuda.ecc_iteration_moments(srcs, tmpl[: len(mats)], mats,
                                             motion, **kw)
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
    ms = time_ms(lambda: ecc_cuda.ecc_iteration_moments(
        srcs, tmpl, m3, MotionType.Homography), 20)
    plain_ms = time_ms(lambda: ecc_cuda.ecc_iteration_moments_reference(
        srcs, tmpl, m3, MotionType.Homography), 2)
    torch.cuda.synchronize()
    bound_ms, bound_by = bound(4.0 * h * w * (3 + b) + 4.0 * b * 66,
                               float(b) * h * w * B1_OPS)
    ok = stats_rel < MOMENT_REL_BAR and worst_rel < MOMENT_REL_BAR
    log(f"[2 B1 ecc_moments] {b} homography lanes + 1 affine lane at "
        f"{h}x{w}: stats rel {stats_rel:.3e}, group-norm rel "
        f"{worst_rel:.3e} (bar {MOMENT_REL_BAR:g}), max abs {max_abs:.3e}; "
        f"kernel {ms:.3f} ms vs plain {plain_ms:.3f} ms for {b} lanes, "
        f"bound {bound_ms:.3f} ms ({bound_by}) "
        f"-> {'OK' if ok else 'MISMATCH'}")
    if not ok:
        fail("B1 disagrees with its plain version")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def phase_b2(dev):
    from libstacker_tpu_torch.ops import color, warp, warp_accum_cuda
    from libstacker_tpu_torch.utils.synth import make_burst

    n = KERNEL_FRAMES
    frames, truth = make_burst(n, FULL_H, FULL_W, seed=3, device=dev)
    minv = warp.invert_3x3(torch.from_numpy(truth).float().to(dev))
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[n // 2] = False
    got = warp_accum_cuda.warp_accum_rgb(frames, minv, valid)
    want = warp_accum_cuda.warp_accum_rgb_reference(frames, minv, valid)
    got_f32 = warp_accum_cuda.warp_accum_rgb(
        color.to_unit_f32(frames), minv, valid)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    u8_f32 = float((got - got_f32).abs().max())
    ms = time_ms(lambda: warp_accum_cuda.warp_accum_rgb(frames, minv, valid), 20)
    plain_ms = time_ms(
        lambda: warp_accum_cuda.warp_accum_rgb_reference(frames, minv, valid), 2)
    hw = FULL_H * FULL_W
    bound_ms, bound_by = bound((n - 1) * hw * 3.0 + hw * 3 * 4.0 + n * 40.0,
                               float(n - 1) * hw * B2_OPS)
    ok = max_abs < ACCUM_MAX_BAR and u8_f32 == 0.0
    log(f"[3 B2 warp_accum] {n} u8 frames of {FULL_H}x{FULL_W} (one "
        f"dropped): max abs {max_abs:.3e} (bar {ACCUM_MAX_BAR:g}), u8 vs "
        f"f32 source {u8_f32:.1e} (bar 0); kernel {ms:.3f} ms vs plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}) "
        f"-> {'OK' if ok else 'MISMATCH'}")
    if not ok:
        fail("B2 disagrees with its plain version")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def headline_params():
    from libstacker_tpu_torch import EccMatchParameters, MotionType

    return EccMatchParameters(
        motion_type=MotionType.Homography, max_count=50, epsilon=1e-4,
        gauss_filt_size=5, coarse_levels=1,
    )


def phase_slice_parity(dev):
    """The slice's stages on CUDA and on the CPU from one u8 burst."""
    from libstacker_tpu_torch.ops import ecc as ecc_ops, phasecorr
    from libstacker_tpu_torch.models import ecc as ecc_models
    from libstacker_tpu_torch.utils.synth import make_burst

    params = headline_params()
    frames, _ = make_burst(SLICE_N, SLICE_H, SLICE_W, seed=5, device=dev)
    frames_np = frames.cpu().numpy()

    def run(device):
        f = torch.from_numpy(frames_np).to(device)
        grey = ecc_models._ecc_grey(f)
        init = phasecorr.phase_init_warps(grey[1:], grey[0],
                                          params.motion_type)
        res = ecc_ops.find_transform_ecc_batched(
            grey[1:], grey[0], params.motion_type, 50, 1e-4, 5,
            coarse_levels=1, warp_init=init,
        )
        stack = ecc_models._ecc_warp_accumulate(
            f, res.warp_matrix, res.ok, params.motion_type) / SLICE_N
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
    from libstacker_tpu_torch.ops import ecc_cuda, warp_accum_cuda
    from libstacker_tpu_torch.utils.synth import make_burst

    params = headline_params()
    frames, _ = make_burst(FULL_N, FULL_H, FULL_W, seed=0, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ecc_match_arrays(frames, params, device_output=True)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0

    ecc_cuda.launch_count = 0
    warp_accum_cuda.launch_count = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, stats = ecc_match_arrays(frames, params, return_stats=True,
                                  device_output=True)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = {"ecc_moments": ecc_cuda.launch_count,
                "warp_accum": warp_accum_cuda.launch_count}

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
          and min(launches.values()) > 0)
    log(f"[5 full slice] {FULL_N}x{FULL_H}x{FULL_W} u8, homography, "
        f"coarse_levels=1: cold {cold_s:.3f} s, warm {warm_s:.3f} s = "
        f"{FULL_N / warm_s:.2f} frames/s | stages ms: {splits} | iters "
        f"(full-res) mean {iters.mean():.2f} max {iters.max()} | mean rho "
        f"{rho.mean():.5f} | kept {stats.frames_kept}/{FULL_N} | stack vs "
        f"frame 0 mean abs {f0_diff:.2e} | launches {launches} -> "
        f"{'OK' if ok else 'FAILED'}")
    if not ok:
        fail("the full-size slice missed a bar")
    return launches


def textured_grey(dev):
    """The keypoint bench's burst (``utils/synth.make_textured_burst``)
    and its uint8 grey, as the keypoint path computes it."""
    from libstacker_tpu_torch.models import keypoint
    from libstacker_tpu_torch.utils.synth import make_textured_burst

    frames, truth = make_textured_burst(KP_N, FULL_H, FULL_W, seed=0,
                                        device=dev)
    return frames, truth, keypoint._grey(frames)


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
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def phase_b3(dev, grey):
    from libstacker_tpu_torch.ops import fast, fast_cuda, orb_cuda

    n, h, w = grey.shape
    score = fast_cuda.fast_scores(grey, KP_T, KP_B)
    cand = fast.top_k_keypoints(score > 0, score, KP_K)
    del score
    ys, xs = cand.ys.contiguous(), cand.xs.contiguous()
    # centres at and beyond every clamp edge
    ys[:, :4] = torch.tensor([0, 5, h - 1, h + 7], dtype=torch.int32)
    xs[:, :4] = torch.tensor([w - 1, 0, 3, -9], dtype=torch.int32)
    got = orb_cuda.extract_patches(grey, ys, xs, KP_RADIUS)
    want = orb_cuda.extract_patches_reference(grey, ys, xs, KP_RADIUS)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    max_abs = float((got - want).abs().max())
    ms = time_ms(lambda: orb_cuda.extract_patches(grey, ys, xs, KP_RADIUS), 20)
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
    touched = torch.zeros_like(grey, dtype=torch.bool)
    touched[bi.expand_as(py), py.expand(-1, -1, -1, side),
            px.expand(-1, -1, side, -1)] = True
    in_bytes = float(touched.sum()) + ys.numel() * 8.0
    del touched
    bound_ms, bound_by = bound(in_bytes + got.numel() * 4.0, 0.0)
    log(f"[7 B3 orb_extract] {n} frames of {h}x{w}, K={KP_K}, radius "
        f"{KP_RADIUS} (4 centres at the clamp edges): bitwise equal "
        f"{equal}; kernel {ms:.4f} ms vs plain {plain_ms:.4f} ms, library "
        f"gather {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
        f"-> {'OK' if equal else 'MISMATCH'}")
    if not equal:
        fail("B3 disagrees with its plain version")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


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
    from libstacker_tpu_torch.ops import orb
    from libstacker_tpu_torch.utils.synth import make_textured_burst

    p = KeyPointMatchParameters()
    frames, _ = make_textured_burst(KP_SLICE_N, KP_SLICE_H, KP_SLICE_W,
                                    seed=5, device=dev)
    frames_np = frames.cpu().numpy()

    def run(device):
        f = torch.from_numpy(frames_np).to(device)
        feats = orb.orb_detect_and_compute(keypoint._grey(f))
        gen = torch.Generator(device=device).manual_seed(0)
        hs, oks, _, _ = keypoint._match_and_estimate(
            feats, gen, p.method, p.ransac_reproj_threshold,
            p.match_keep_ratio, p.match_ratio, p.max_iters, p.confidence)
        stack = keypoint._warp_and_accumulate(f, hs, oks, [0.0] * 3)
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


def kp_homographies(frames, params, scale_hw):
    """The full-resolution homographies of one ``keypoint_match_arrays``
    run (seed 0), recomputed through the same stages."""
    from libstacker_tpu_torch.models import keypoint
    from libstacker_tpu_torch.ops import orb

    feats = orb.orb_detect_and_compute(keypoint._grey(frames, scale_hw))
    gen = torch.Generator(device=frames.device).manual_seed(0)
    hs, oks, _, _ = keypoint._match_and_estimate(
        feats, gen, params.method, params.ransac_reproj_threshold,
        params.match_keep_ratio, params.match_ratio, params.max_iters,
        params.confidence)
    if scale_hw is not None:
        hs = keypoint._adjust_h_for_scale(hs, scale_hw, frames.shape[1:3])
    return hs[oks].cpu().numpy(), oks.cpu().numpy()


def phase_kp_full(dev, frames, truth):
    from libstacker_tpu_torch import KeyPointMatchParameters, keypoint_match_arrays
    from libstacker_tpu_torch.ops import fast_cuda, orb_cuda, resize, warp_accum_cuda
    from libstacker_tpu_torch.ops.warp_batch import warp_accumulate_rgb
    from libstacker_tpu_torch.ops import color

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
        for mod in (fast_cuda, orb_cuda, warp_accum_cuda):
            mod.launch_count = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dropped, out, stats = keypoint_match_arrays(
            frames, params, scale_down_width=sdw, return_stats=True,
            device_output=True)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        launches = {"fast": fast_cuda.launch_count,
                    "orb_extract": orb_cuda.launch_count,
                    "warp_accum": warp_accum_cuda.launch_count}
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
              and min(launches.values()) > 0)
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
        del out
    return results


def main() -> int:
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

    dev = resolve_device("cuda")
    smi = phase_device()
    torch.cuda.synchronize()
    b1 = phase_b1(dev)
    torch.cuda.synchronize()
    b2 = phase_b2(dev)
    torch.cuda.synchronize()
    phase_slice_parity(dev)
    torch.cuda.synchronize()
    launches = phase_full(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    frames, truth, grey = textured_grey(dev)
    b8 = phase_b8(dev, grey)
    torch.cuda.empty_cache()
    b3 = phase_b3(dev, grey)
    del grey
    torch.cuda.empty_cache()
    phase_kp_parity(dev)
    kp = phase_kp_full(dev, frames, truth)
    torch.cuda.synchronize()
    by_path = {"ecc_match_arrays": launches,
               **{f"keypoint_match_arrays {k}": v for k, v in kp.items()}}

    def counts(name):
        per = {path: c[name] for path, c in by_path.items() if name in c}
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
             **counts("orb_extract"), **b3),
    ]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
