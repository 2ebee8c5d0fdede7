"""The upstream example's workflow (examples/main.rs:37-64, as the
port's ``stack_burst.py:195-218`` runs it) in a closed loop with one
caller: grey of the burst, all four sharpness metrics, the frames
sorted by TENG, the least sharp dropped and the sharpest put first,
then the configuration's entry point on the kept frames.  The port has
no array-level entry point for this workflow, so the loop repeats
``stack_burst.py``'s steps, with the port's own grey and
``sharpness_all``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from stackbench.drivers import burst
from stackbench.reference import _plain

_GREY_CHUNK = 16


class Loop(burst.Loop):
    def __init__(self, config, traffic, device, seed):
        super().__init__(config, traffic, device, seed)
        from libstacker_tpu_torch.ops import color
        from libstacker_tpu_torch.ops.sharpness import sharpness_all

        self._grey = color.rgb_to_gray_u8
        self._sharpness = sharpness_all
        self.spans = {"sharpness": []}

    def frames_stacked(self, b: int) -> int:
        return self.pool[b].shape[0] - 1

    def call(self, b: int, stats: bool):
        frames = self.pool[b]
        t0 = time.perf_counter()
        with torch.profiler.record_function("stage:sharpness"):
            grey = torch.cat([self._grey(frames[s : s + _GREY_CHUNK])
                              for s in range(0, frames.shape[0], _GREY_CHUNK)])
            scores = {k: v.cpu().numpy()
                      for k, v in self._sharpness(grey).items()}
            del grey
        if stats:
            self.spans["sharpness"].append((time.perf_counter() - t0) * 1e3)
        order = np.argsort(scores["teng"], kind="stable")
        keep = order[1:][::-1].copy()
        kept = frames[torch.from_numpy(keep).to(frames.device)]
        out, st, record = self.entry(kept, stats)
        record.update(scores=scores, keep=keep)
        return out, st, record

    def answer(self, b, record, out=None):
        a = super().answer(b, record, out)
        keep = record["keep"]
        a["key"] = (b, tuple(int(i) for i in keep))
        idx = torch.from_numpy(keep)
        a["frames"] = lambda: self.pool[b][idx.to(self.pool[b].device)]
        a["scores"] = record["scores"]
        a["keep"] = keep
        a["burst"] = b
        a["pool_frames"] = lambda: self.pool[b]
        return a

    def control_answer(self, b, ref, dtype):
        frames = self.pool[b]
        scores = {k: v.float().cpu().numpy() for k, v in
                  _plain.sharpness(_plain.grey(frames), dtype).items()}
        keep = np.argsort(scores["teng"], kind="stable")[1:][::-1].copy()
        idx = torch.from_numpy(keep).to(frames.device)
        kept = frames[idx]
        warps, ok = ref.align(kept, self.traffic, dtype)
        out = ref.stack(kept, warps, ok, dtype)
        return {"key": (b, tuple(int(i) for i in keep)),
                "frames": lambda: self.pool[b][idx], "warps": warps,
                "ok": ok, "dropped": None, "out": out, "scores": scores,
                "keep": keep, "burst": b,
                "pool_frames": lambda: self.pool[b]}
