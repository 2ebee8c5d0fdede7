"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages as
numpy arrays; JAX stays on the CPU (tests/conftest.py) and the port runs
its plain CPU path (``device="cpu"``)."""

from __future__ import annotations

import numpy as np
import torch
from scipy.ndimage import gaussian_filter


def smooth(rng, shape, sigma=2.0) -> np.ndarray:
    """Smoothed random float32 content on the 0..255 scale."""
    return gaussian_filter(
        rng.random(shape).astype(np.float32) * 255.0, sigma
    ).astype(np.float32)


def t(a) -> torch.Tensor:
    """numpy -> CPU tensor (a copy, so JAX and torch never share)."""
    return torch.from_numpy(np.array(a))


def n(x) -> np.ndarray:
    """tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def frac_off(a, b, tol=1e-4) -> float:
    """Fraction of elements differing by more than ``tol``."""
    return float((np.abs(n(a) - n(b)) > tol).mean())


def rotation_inverse_map(h, w, deg, scale=1.0, dx=0.0, dy=0.0,
                         persp=(0.0, 0.0)) -> np.ndarray:
    """A 3x3 float32 inverse map: rotation by ``deg`` and scale about the
    image centre, a shift, and an optional perspective row."""
    a = np.radians(deg)
    c, s = scale * np.cos(a), scale * np.sin(a)
    cx, cy = w / 2.0, h / 2.0
    return np.array([
        [c, s, (1 - c) * cx - s * cy + dx],
        [-s, c, s * cx + (1 - c) * cy + dy],
        [persp[0], persp[1], 1.0],
    ], np.float32)


def burst(seed, n_frames, h, w, **kw):
    """Synthetic u8 burst (numpy [N,H,W,3]) and its truth warps
    (libstacker_tpu_torch.utils.synth.make_burst on the CPU)."""
    from libstacker_tpu_torch.utils.synth import make_burst

    frames, truth = make_burst(n_frames, h, w, seed=seed, **kw)
    return frames.cpu().numpy(), truth


def measure_resize(seeds=20) -> None:
    """uint8 resize residual of the port against the JAX package: pixels
    1 LSB apart over ``seeds`` random inputs per case (ROADMAP.md Queue
    C), and the first levels of a 1080x1920 ORB pyramid chain."""
    import jax
    import jax.numpy as jnp
    from libstacker_tpu.ops import resize as jresize
    from libstacker_tpu_torch import constants as C
    from libstacker_tpu_torch.ops import resize

    def off(a, b):
        return int((n(a).astype(int) != n(b).astype(int)).sum())

    for src, dst in (((100, 140), (64, 89)), ((540, 960), (200, 355))):
        bad = total = 0
        for seed in range(seeds):
            x = np.random.default_rng(seed).integers(
                0, 256, (2,) + src).astype(np.uint8)
            got = resize.resize(t(x), dst, C.INTER_AREA)
            bad += off(got, jresize.resize(jnp.asarray(x), dst, C.INTER_AREA))
            total += got.numel()
        print(f"INTER_AREA {src} -> {dst}, seeds 0..{seeds - 1}: {bad} of "
              f"{total} pixels 1 LSB apart")
    x = np.random.default_rng(9).integers(0, 256, (2, 1080, 1920)).astype(np.uint8)
    got, want = t(x), jnp.asarray(x)
    for level in range(1, 4):
        d = (round(1080 / 1.2 ** level), round(1920 / 1.2 ** level))
        got = resize.resize(got, d, C.INTER_LINEAR)
        want = jax.vmap(lambda g, d=d: jresize.resize(g, d, C.INTER_LINEAR))(want)
        print(f"INTER_LINEAR 1080x1920 chain, level {level} {d}: "
              f"{off(got, want)} of {got.numel()} pixels 1 LSB apart")


def measure_keypoint_accuracy(n_frames=6, h=1080, w=1920, width=400.0) -> None:
    """Largest distance between the image corners mapped by each
    estimated homography and by the true warp, for the JAX package and
    the port (seed 0, default parameters), at full resolution and with
    detection on the ``scale_down_width=width`` grid."""
    import jax
    import jax.numpy as jnp
    from libstacker_tpu.models import keypoint as jkp
    from libstacker_tpu_torch import KeyPointMatchParameters
    from libstacker_tpu_torch.models import keypoint as pkp
    from libstacker_tpu_torch.ops import color, orb, resize, warp
    from libstacker_tpu_torch.utils.synth import make_textured_burst

    frames, truth = make_textured_burst(n_frames, h, w, seed=0)
    p = KeyPointMatchParameters()
    args = (p.method, p.ransac_reproj_threshold, p.match_keep_ratio,
            p.match_ratio, p.max_iters, p.confidence)
    corners = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1],
                        [w - 1, h - 1, 1.0]])

    def err(hs):
        a = corners @ np.swapaxes(np.asarray(hs, np.float64), -1, -2)
        b = corners @ np.swapaxes(truth[1:], -1, -2)
        return float(np.abs(a[..., :2] / a[..., 2:] - b[..., :2] / b[..., 2:]).max())

    for sdw in (None, width):
        shw = resize.scale_image_size(h, w, sdw) if sdw else None
        feats = orb.orb_detect_and_compute(color.burst_grey_u8(frames, shw))
        hs = pkp._match_and_estimate(
            feats, torch.Generator().manual_seed(0), *args)[0]
        jfeats = jkp._grey_and_detect(jnp.asarray(frames.numpy()), shw)
        jhs = jkp._match_and_estimate(jfeats, jax.random.PRNGKey(0), *args)[0]
        if shw:
            hs = warp.rescale_maps(hs, shw, (h, w))
            jhs = jkp._adjust_h_for_scale(jhs, shw, (h, w))
        print(f"{n_frames}x{h}x{w}, detection on {shw or (h, w)}: corners "
              f"within {err(hs):.3f} px of the truth (port), "
              f"{err(jhs):.3f} px (JAX package)")


if __name__ == "__main__":
    # PYTHONPATH=. python tests/_torch_parity.py {resize|keypoint}
    # (from the repo root; CPU, both packages)
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    {"resize": measure_resize,
     "keypoint": measure_keypoint_accuracy}[sys.argv[1]]()
