"""Crash-safe checkpoint/resume for the streaming pipelines.

A copy of ``libstacker_tpu/utils/checkpoint.py`` (``burst_key`` :27,
``StreamCheckpoint`` :44).  A 1000-frame overnight burst should not
restart from frame 0 after a power blip.  The streams
(``ecc_match_stream`` / ``keypoint_match_stream``) carry tiny state
between chunks — the running accumulator, the per-frame ok flags and
the chunk index — so resumable processing is one small npz file written
atomically every ``checkpoint_every`` chunks (the reference has no
counterpart: its Rayon fold is all-or-nothing).

The checkpoint is keyed by a digest of the file list, the parameters,
the chunk size and the alignment mask: a stale or mismatched file is
IGNORED (the burst restarts cleanly), never half-applied.  On
successful completion the file is removed.
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from typing import Optional, Tuple

import numpy as np


def burst_key(files, params, scale_down_width, chunk_size: int,
              extra: str = "", mask=None) -> str:
    """Stable identity of a streaming run: same files (by name, in
    order), same parameters, same chunking, same mask content."""
    h = hashlib.sha256()
    for f in files:
        h.update(str(f).encode())
        h.update(b"\x00")
    h.update(repr(params).encode())
    h.update(f"|{scale_down_width}|{chunk_size}|{extra}".encode())
    if mask is not None:
        h.update(np.ascontiguousarray(mask).tobytes())
    return h.hexdigest()


class StreamCheckpoint:
    """Atomic npz checkpoint bound to one :func:`burst_key`."""

    def __init__(self, path, key: str):
        self.path = str(path)
        self.key = key

    def load(self) -> Tuple[int, Optional[dict]]:
        """-> (chunks_done, state) — (0, None) when absent, unreadable
        or keyed to a different run."""
        if not os.path.exists(self.path):
            return 0, None
        try:
            with np.load(self.path, allow_pickle=False) as z:
                if str(z["key"]) != self.key:
                    return 0, None
                state = {k: z[k] for k in z.files}
                return int(z["chunks_done"]), state
        except (OSError, KeyError, ValueError, zipfile.BadZipFile):
            return 0, None

    def save(self, chunks_done: int, **state) -> None:
        """Write-then-rename so a crash mid-save never corrupts an
        existing checkpoint."""
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, key=np.str_(self.key),
                     chunks_done=np.int64(chunks_done), **state)
        os.replace(tmp, self.path)

    def remove(self) -> None:
        try:
            os.remove(self.path)
        except OSError:
            pass
