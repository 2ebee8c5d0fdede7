"""Focus / sharpness metrics over ``[..., H, W]`` grey frames.

Counterpart of ``libstacker_tpu/ops/sharpness.py`` (:38-97), the
reference's four metrics (SURVEY.md R10-R13):

- LAPM  ``sharpness_modified_laplacian``  (ref src/lib.rs:1032-1070)
- LAPV  ``sharpness_variance_of_laplacian`` (ref src/lib.rs:1074-1090)
- TENG  ``sharpness_tenengrad``            (ref src/lib.rs:1101-1147)
- GLVN  ``sharpness_normalized_gray_level_variance`` (src/lib.rs:1151-1166)

Every metric comes from one pass, ``ops/sharpness_cuda.sharpness_sums``:
six per-frame sums of the filtered planes (each plane the port's
``ops/filters.sep_filter2d``, equal to the JAX package's tap for tap),
squared and summed in float64, then rounded once to float32.  CUDA
tensors run ``csrc/sharpness.cu``; CPU tensors its plain version, which
scores ``_SCORE_CHUNK`` frames a pass (each pass keeps a few float32 and
float64 planes per frame alive).  u8, u16 and float32 grey is read as it
is; any other dtype is first converted to float32.  A numpy input is
copied to ``device`` ("cuda" by default; asking for CUDA without a card
raises); a tensor stays on its own device.  Every metric returns a
float32 tensor of the leading shape ``[...]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from . import sharpness_cuda

# frames scored per pass of the plain version (the CPU path)
_SCORE_CHUNK = 16


def _scores(img, k_size: int, device) -> dict:
    """The four metrics of ``img`` ``[..., H, W]``: name -> ``[...]``
    float32."""
    sharpness_cuda.check_k_size(k_size)
    if isinstance(img, torch.Tensor):
        resolve_device(img.device)
    else:
        img = torch.from_numpy(np.ascontiguousarray(img)).to(
            resolve_device(device))
    lead = img.shape[:-2]
    flat = img.reshape((-1,) + tuple(img.shape[-2:]))
    if flat.dtype not in sharpness_cuda.DTYPES:
        flat = flat.to(torch.float32)
    _, metrics = sharpness_cuda.sharpness_sums(flat.contiguous(), k_size)
    return {name: metrics[i].reshape(lead)
            for i, name in enumerate(sharpness_cuda.METRICS)}


def sharpness_modified_laplacian(img, device="cuda") -> torch.Tensor:
    """LAPM (Nayar89): mean(|Lx| + |Ly|) with Lx = sep_filter(kx=[-1,2,-1],
    ky=gauss3) and Ly the transpose pair (ref src/lib.rs:1032-1070)."""
    return _scores(img, 3, device)["lapm"]


def sharpness_variance_of_laplacian(img, device="cuda") -> torch.Tensor:
    """LAPV (Pech2000): population variance of the ksize=3 Laplacian
    with BORDER_REPLICATE (ref src/lib.rs:1074-1090)."""
    return _scores(img, 3, device)["lapv"]


def sharpness_tenengrad(img, k_size: int = 3, device="cuda") -> torch.Tensor:
    """TENG (Krotkov86): mean(gx^2 + gy^2) of Sobel gradients
    (ref src/lib.rs:1101-1147; k_size validated to {1,3,5,7} at
    src/lib.rs:1103-1107)."""
    return _scores(img, k_size, device)["teng"]


def sharpness_normalized_gray_level_variance(img, device="cuda") -> torch.Tensor:
    """GLVN (Santos97): population variance / mean (mean clamped to eps,
    ref src/lib.rs:1151-1166)."""
    return _scores(img, 3, device)["glvn"]


def sharpness_all(img, teng_k_size: int = 3, device="cuda") -> dict:
    """All four metrics of a batch -> dict with keys lapm/lapv/teng/glvn,
    each a ``[...]`` float32 tensor (ref examples/main.rs:37-49 scores
    the frames one by one): one pass over the frames."""
    return _scores(img, teng_k_size, device)
