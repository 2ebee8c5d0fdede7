"""libstacker_tpu_torch — the PyTorch / CUDA port of libstacker_tpu.

A second package beside ``libstacker_tpu`` (the JAX reference, which it
never imports): the same public surface, written as plain PyTorch
functions on tensors, with the TPU's Pallas kernels rewritten by hand in
CUDA for Hopper (``csrc/``, built on first use by
``utils/cuda_build.py``).  Two paths are ported: the ECC-homography
align-and-stack path (``ecc_match`` / ``ecc_match_arrays``) and the
ORB-keypoint path (``keypoint_match`` / ``keypoint_match_arrays``:
ORB, Hamming 2-NN, RANSAC), both with the mean stack; ROADMAP.md lists
what follows.
"""

from . import constants  # noqa: F401
from .errors import (  # noqa: F401
    InvalidParamsError,
    NotEnoughFilesError,
    ProcessingError,
    StackerError,
    StackerIoError,
)
from .params import (  # noqa: F401
    EccMatchParameters,
    KeyPointMatchParameters,
    MotionType,
)
from .models.ecc import ecc_match, ecc_match_arrays, ecc_match_stream  # noqa: F401
from .models.keypoint import (  # noqa: F401
    keypoint_match,
    keypoint_match_arrays,
    keypoint_match_stream,
)
from .utils.io import (  # noqa: F401
    imread,
    imread_gray,
    imread_unchanged,
    load_frames,
    save_image,
)

__version__ = "0.1.0"
