"""Host-side image IO: the 8-bit ``load_frames`` path.

Counterpart of ``libstacker_tpu/utils/io.py`` (``collect_image_files``
:34, ``normalize_files`` :50, ``imread_rgb`` :80, ``rgb_to_gray_u8_host``
:119, ``load_frames`` :339), decode through a PIL thread pool.  The
native C++ loader and the 16-bit (``preserve_depth``) decode are not
ported yet (ROADMAP.md Queue A item 14).

Channel order is RGB in memory, as in the reference.
"""

from __future__ import annotations

import concurrent.futures
import os
from pathlib import Path
from typing import List, Sequence, Union

import numpy as np

from ..errors import NotEnoughFilesError, StackerIoError

PathLike = Union[str, os.PathLike]

_IMAGE_EXTENSIONS = {".jpg", ".jpeg", ".tif", ".png"}


def collect_image_files(directory: PathLike) -> List[Path]:
    """Return paths of all jpg/jpeg/tif/png files in a directory
    (non-recursive), mirroring ``collect_image_files`` at
    reference ``examples/main.rs:10-22``."""
    directory = Path(directory)
    try:
        entries = sorted(directory.iterdir())
    except OSError as e:
        raise StackerIoError(str(e)) from e
    return [
        p
        for p in entries
        if p.is_file() and p.suffix.lower() in _IMAGE_EXTENSIONS
    ]


def normalize_files(files) -> list:
    """Normalise a ``files`` argument: a bare str/PathLike is a
    directory of frames (or a single image file), NOT an iterable of
    one-character file names; anything else is materialised as a
    list."""
    if isinstance(files, (str, os.PathLike)):
        if os.path.isdir(files):
            return list(collect_image_files(files))
        return [files]
    return list(files)


def imread_rgb(path: PathLike) -> np.ndarray:
    """Decode one image file to an RGB uint8 array ``[H,W,3]``;
    grayscale files are expanded to 3 channels and 16-bit files keep
    their high byte (same semantics as the reference's ``imread_rgb``)."""
    from PIL import Image

    try:
        with Image.open(path) as im:
            if im.mode in ("I;16", "I;16B", "I;16L", "I;16N", "I"):
                arr = np.asarray(im, dtype=np.uint32)
                arr8 = (arr >> 8).clip(0, 255).astype(np.uint8)
                if arr8.ndim == 2:
                    arr8 = np.repeat(arr8[:, :, None], 3, axis=2)
                return arr8
            im = im.convert("RGB")
            return np.asarray(im, dtype=np.uint8)
    except OSError as e:
        raise StackerIoError(f"{path}: {e}") from e


def rgb_to_gray_u8_host(rgb: np.ndarray) -> np.ndarray:
    """Host (numpy) Rec.601 luma with OpenCV's exact fixed-point rounding:
    grey = (9798*R + 19235*G + 3735*B + 2^14) >> 15."""
    r = rgb[..., 0].astype(np.int32)
    g = rgb[..., 1].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)
    return ((9798 * r + 19235 * g + 3735 * b + (1 << 14)) >> 15).astype(np.uint8)


def load_frames(
    files: Sequence[PathLike], *, num_threads: int | None = None,
) -> np.ndarray:
    """Decode ``files`` into one batched ``[N,H,W,3] uint8`` tensor.

    All frames must share the first frame's spatial size (every frame is
    warped onto frame 0's grid)."""
    files = normalize_files(files)
    if not files:
        raise NotEnoughFilesError()
    if num_threads is None:
        num_threads = min(len(files), os.cpu_count() or 1)
    if num_threads <= 1 or len(files) == 1:
        frames = [imread_rgb(f) for f in files]
    else:
        with concurrent.futures.ThreadPoolExecutor(num_threads) as pool:
            frames = list(pool.map(imread_rgb, files))
    shape0 = frames[0].shape
    for f, arr in zip(files, frames):
        if arr.shape != shape0:
            raise StackerIoError(
                f"frame size mismatch: {f} has {arr.shape}, expected {shape0}"
            )
    return np.stack(frames, axis=0)
