"""Convenience re-exports, mirroring the reference's ``prelude`` module
(ref src/lib.rs:1168-1173); a copy of ``libstacker_tpu/prelude.py``."""

from .constants import (  # noqa: F401
    BORDER_CONSTANT,
    BORDER_REFLECT,
    BORDER_REFLECT_101,
    BORDER_REPLICATE,
    LMEDS,
    RANSAC,
)
from .errors import (  # noqa: F401
    InvalidParamsError,
    NotEnoughFilesError,
    ProcessingError,
    StackerError,
    StackerIoError,
)
from .models.ecc import ecc_match, ecc_match_arrays, ecc_match_stream  # noqa: F401
from .models.keypoint import (  # noqa: F401
    keypoint_match,
    keypoint_match_arrays,
    keypoint_match_stream,
)
from .params import (  # noqa: F401
    EccMatchParameters,
    KeyPointMatchParameters,
    MotionType,
)
