"""A closed loop with one caller: each call hands one burst of the pool
to the configuration's entry point, on the card, and waits for the
stacked image (``device_output=True``, then a synchronise by the
harness).  This is how the library is used: one burst fills the card,
and the call returns when the stack is done.

The port's entry points return the stack but not the alignment, so the
loop records what the alignment stage returned by wrapping the module
attribute that the entry point calls (``ops.ecc.find_transform_ecc_batched``,
``models.keypoint._match_and_estimate``): one reference to a few small
tensors a call, no synchronise.
"""

from __future__ import annotations

import torch

from stackbench.gen import bursts as gen
from stackbench.reference import _plain


def patch(patches: list, mod, attr: str, fn) -> None:
    """Set ``mod.attr`` to ``fn``, remembering the old value in
    ``patches`` for ``Loop.close``."""
    patches.append((mod, attr, getattr(mod, attr)))
    setattr(mod, attr, fn)


class _Ecc:
    """``ecc_match_arrays``; the warps from the ECC solve."""

    def __init__(self, lt, config, traffic, patches):
        from libstacker_tpu_torch.ops import ecc as ecc_ops

        p = dict(config["params"])
        p["motion_type"] = lt.MotionType[p["motion_type"]]
        self.params = lt.EccMatchParameters(**p)
        self.fn = lt.ecc_match_arrays
        self.sdw = traffic.get("scale_down_width")
        self.last = None
        orig = ecc_ops.find_transform_ecc_batched

        def recorded(*args, **kwargs):
            res = orig(*args, **kwargs)
            self.last = (res.warp_matrix, res.ok)
            return res

        patch(patches, ecc_ops, "find_transform_ecc_batched", recorded)

    def __call__(self, frames, stats: bool):
        res = self.fn(frames, self.params, scale_down_width=self.sdw,
                      device_output=True, return_stats=stats)
        out, st = res if stats else (res, None)
        warps, ok = self.last
        return out, st, {"warps": warps, "ok": ok, "dropped": None}


class _Keypoint:
    """``keypoint_match_arrays``; the homographies from RANSAC."""

    def __init__(self, lt, config, traffic, patches):
        from libstacker_tpu_torch.models import keypoint as kp

        self.params = lt.KeyPointMatchParameters(**config["params"])
        self.fn = lt.keypoint_match_arrays
        self.sdw = traffic.get("scale_down_width")
        self.last = None
        orig = kp._match_and_estimate

        def recorded(*args, **kwargs):
            res = orig(*args, **kwargs)
            self.last = (res[0], res[1])
            return res

        patch(patches, kp, "_match_and_estimate", recorded)

    def __call__(self, frames, stats: bool):
        res = self.fn(frames, self.params, scale_down_width=self.sdw,
                      device_output=True, return_stats=stats)
        dropped, out = res[0], res[1]
        st = res[2] if stats else None
        hs, ok = self.last
        return out, st, {"warps": hs, "ok": ok, "dropped": dropped}


ENTRIES = {"ecc_match_arrays": _Ecc, "keypoint_match_arrays": _Keypoint}


class Loop:
    """The pool, the entry point and the answers of its calls."""

    def __init__(self, config: dict, traffic: dict, device, seed: int):
        import libstacker_tpu_torch as lt

        frame = config["frame"]
        self.hw = (frame["height"], frame["width"])
        self.traffic = traffic
        recipe = gen.RECIPES[config["content"]]
        self.pool = [
            recipe(traffic["depth"], *self.hw, seed=gen.burst_seed(seed, b),
                   device=device)[0]
            for b in range(traffic["pool"])
        ]
        self.patches = []
        self.entry = ENTRIES[config["entry"]](lt, config, traffic,
                                              self.patches)
        # the loop's own spans, name -> ms a call (traced calls only)
        self.spans = {}

    def frames_in(self, b: int) -> int:
        return self.pool[b].shape[0]

    def frames_stacked(self, b: int) -> int:
        return self.pool[b].shape[0]

    def call(self, b: int, stats: bool):
        """``(stacked image, PipelineStats or None, record)``."""
        return self.entry(self.pool[b], stats)

    def answer(self, b: int, record: dict, out=None) -> dict:
        """What a call answered, in full-resolution pixels: the frames it
        aligned, their warps onto frame 0 and kept flags, the dropped
        count it reported and (for a sampled call) its stacked image."""
        warps = record["warps"].to(torch.float64)
        sdw = self.traffic.get("scale_down_width")
        if sdw:
            small = _plain.scaled_size(*self.hw, sdw)
            warps = _plain.rescale_warps(warps, small, self.hw)
        return {"key": b, "frames": lambda: self.pool[b], "warps": warps,
                "ok": record["ok"].to(torch.bool), "dropped":
                record["dropped"], "out": out}

    def control_answer(self, b: int, ref, dtype) -> dict:
        """The answer of ``ref`` computed in ``dtype``, put in the
        program's place on burst ``b``."""
        frames = self.pool[b]
        warps, ok = ref.align(frames, self.traffic, dtype)
        return {"key": b, "frames": lambda: self.pool[b], "warps": warps,
                "ok": ok, "dropped": None,
                "out": ref.stack(frames, warps, ok, dtype)}

    def release(self, keep_bursts) -> None:
        """Free every pool burst the check does not read, and put back
        what the loop wrapped."""
        self.pool = [p if i in keep_bursts else None
                     for i, p in enumerate(self.pool)]
        while self.patches:
            mod, attr, old = self.patches.pop()
            setattr(mod, attr, old)
