"""libstacker_tpu_torch — the PyTorch / CUDA port of libstacker_tpu.

A second package beside ``libstacker_tpu`` (the JAX reference, which it
never imports): the same public surface, written as plain PyTorch
functions on tensors, with the TPU's Pallas kernels rewritten by hand in
CUDA for Hopper (``csrc/``, built on first use by
``utils/cuda_build.py``).  Ported: the ECC align-and-stack path
(``ecc_match`` / ``ecc_match_arrays`` / ``ecc_match_stream``) and the
ORB-keypoint path (``keypoint_match`` / ``keypoint_match_arrays`` /
``keypoint_match_stream``: ORB, Hamming 2-NN, RANSAC), each with the
mean, sigma-clip and (whole-burst) super-resolution stacks; the
resumable chunked streams (``utils/checkpoint.py``); the four
``sharpness_*`` metrics; image I/O; and the reference's example
workflow (``python -m libstacker_tpu_torch.stack_burst``).  Every
entry point and stream takes ``mesh=``: the burst sharded over a device
mesh, its sums reduced across devices and processes
(``libstacker_tpu_torch.parallel``: ``make_mesh``, ``init_distributed``,
the sharded steps and the row-band functions).
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
from .ops.sharpness import (  # noqa: F401
    sharpness_all,
    sharpness_modified_laplacian,
    sharpness_normalized_gray_level_variance,
    sharpness_tenengrad,
    sharpness_variance_of_laplacian,
)

__version__ = "0.1.0"
