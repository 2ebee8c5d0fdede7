"""Device resolution for the port's public entry points.

There is no silent CPU fallback: asking for CUDA on a machine without a
usable card raises.  Resolving a device also pins float32 matmuls and
convolutions to full precision — the resize matmuls and the filters
must not run in TF32, whose ~3 decimal digits would break the
bit-exact INTER_AREA path and the moment parity.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` -> ``torch.device``; raises if CUDA is asked for and
    missing.  Sets ``allow_tf32 = False`` for matmul and cuDNN."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False (pass device='cpu' to run the plain CPU path)"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


class ChunkUploader:
    """Host-to-device copies of decoded frame chunks for the streams.

    On CUDA, :meth:`put` copies a numpy chunk into one of two pinned host
    buffers and starts its ``non_blocking`` copy on a side stream, so the
    copy of chunk i+1 runs while chunk i's kernels do; :meth:`ready`
    makes the current stream wait for that copy.  A pinned buffer is
    refilled only after its previous copy has completed.  On the CPU the
    chunk is wrapped without a copy."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(self.device)
            self.buffers = [None, None]
            self.events = [None, None]
            self.turn = 0

    def put(self, frames):
        """Start the copy of ``frames`` ([n,H,W,3] numpy) -> a handle for
        :meth:`ready`."""
        host = torch.from_numpy(frames)
        if not self.cuda:
            return host, None
        k, self.turn = self.turn, 1 - self.turn
        if self.events[k] is not None:
            self.events[k].synchronize()  # its last copy has left it
        buf = self.buffers[k]
        n = host.shape[0]
        if (buf is None or buf.dtype != host.dtype
                or buf.shape[1:] != host.shape[1:] or buf.shape[0] < n):
            buf = self.buffers[k] = torch.empty(host.shape, dtype=host.dtype,
                                                pin_memory=True)
        staged = buf[:n]
        staged.copy_(host)
        with torch.cuda.stream(self.stream):
            out = staged.to(self.device, non_blocking=True)
            ev = self.events[k] = torch.cuda.Event()
            ev.record(self.stream)
        return out, ev

    def ready(self, handle) -> torch.Tensor:
        """The device tensor of a :meth:`put`, safe to use on the current
        stream."""
        out, ev = handle
        if ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            out.record_stream(cur)
        return out
