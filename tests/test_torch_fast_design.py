"""What the design of kernel B8 (``libstacker_tpu_torch/csrc/fast.cu``)
relies on, checked on the CPU.

- The compass pre-test that decides which pixels run the arc trees
  (at least 2 of the circle positions 0, 4, 8, 12 past the threshold on
  one side) never rejects a corner: exhaustively over all 65536 circle
  masks, every mask that holds a contiguous run of 9 passes it.
- A u8 pixel ``p`` is staged as the s16x2 pair ``(p, -p)`` by one
  multiply, ``p * 0xFFFF0001`` modulo 2^32.
- The packed tree (windows of 3 by three-way s16x2 minima, windows of 9
  from three of those, the maximum of the 16 windows by three-way
  maxima), emulated here on uint32 words with int16 halves, gives the
  bright and dark arc strengths of the plain int tree (``ops/fast.py``)
  once the centre is subtracted from the low half and added to the high
  half: min and max commute with a shift.  Bitwise, on random circles.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from libstacker_tpu_torch.ops import fast  # noqa: E402

COMPASS = (0, 4, 8, 12)


def _has_run9(masks: np.ndarray) -> np.ndarray:
    """Does each 16-bit circle mask hold 9 contiguous set positions?"""
    bits = (masks[:, None] >> np.arange(16)) & 1
    ring = np.concatenate([bits, bits[:, :8]], axis=1)
    return np.stack([ring[:, i : i + 9].all(axis=1) for i in range(16)],
                    axis=1).any(axis=1)


def test_compass_pretest_never_rejects_a_corner():
    masks = np.arange(1 << 16, dtype=np.int64)
    run9 = _has_run9(masks)
    compass = sum((masks >> k) & 1 for k in COMPASS)
    assert int(run9.sum()) > 0
    assert not np.any(run9 & (compass < 2))


def _halves(x: np.ndarray):
    lo = (x & 0xFFFF).astype(np.uint16).view(np.int16).astype(np.int32)
    hi = (x >> 16).astype(np.uint16).view(np.int16).astype(np.int32)
    return lo, hi


def _join(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return (lo.astype(np.int16).view(np.uint16).astype(np.uint32)
            | (hi.astype(np.int16).view(np.uint16).astype(np.uint32) << 16))


def _min3(a, b, c):  # __vimin3_s16x2
    (al, ah), (bl, bh), (cl, ch) = _halves(a), _halves(b), _halves(c)
    return _join(np.minimum(np.minimum(al, bl), cl),
                 np.minimum(np.minimum(ah, bh), ch))


def _max3(a, b, c):  # __vimax3_s16x2
    (al, ah), (bl, bh), (cl, ch) = _halves(a), _halves(b), _halves(c)
    return _join(np.maximum(np.maximum(al, bl), cl),
                 np.maximum(np.maximum(ah, bh), ch))


def _max2(a, b):  # __vmaxs2
    (al, ah), (bl, bh) = _halves(a), _halves(b)
    return _join(np.maximum(al, bl), np.maximum(ah, bh))


def _stage(p: np.ndarray) -> np.ndarray:
    return (p.astype(np.uint64) * 0xFFFF0001 % (1 << 32)).astype(np.uint32)


def _packed_strengths(circle: np.ndarray, ctr: np.ndarray):
    """corner_score's tree on [M, 16] u8 circles -> (bright, dark)."""
    v = [_stage(circle[:, k]) for k in range(16)]
    w3 = [_min3(v[i], v[(i + 1) % 16], v[(i + 2) % 16]) for i in range(16)]
    w9 = [_min3(w3[i], w3[(i + 3) % 16], w3[(i + 6) % 16]) for i in range(16)]
    m = [_max3(*w9[i : i + 3]) for i in range(0, 15, 3)]
    best = _max2(_max3(m[0], m[1], m[2]), _max3(m[3], m[4], w9[15]))
    lo, hi = _halves(best)
    return lo - ctr, hi + ctr


def test_stage_is_p_and_minus_p():
    p = np.arange(256)
    lo, hi = _halves(_stage(p))
    np.testing.assert_array_equal(lo, p)
    np.testing.assert_array_equal(hi, -p)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_tree_equals_int_tree(seed):
    """Random circles and centres (differences over all of [-255, 255],
    with arcs of equal values mixed in) through the packed tree and the
    plain int tree of both signs."""
    rng = np.random.default_rng(seed)
    m = 20000
    circle = rng.integers(0, 256, (m, 16))
    ctr = rng.integers(0, 256, m)
    # a third of the circles get a run of equal values (ties, long arcs)
    runs = rng.integers(0, 16, m // 3)
    for k in range(9):
        circle[np.arange(m // 3), (runs + k) % 16] = circle[: m // 3, 0]
    circle[:100] = 0
    circle[100:200] = 255
    ctr[:50], ctr[100:150] = 255, 0
    tb, td = _packed_strengths(circle, ctr)
    e = [torch.from_numpy((circle[:, k] - ctr).astype(np.int16))
         for k in range(16)]
    want_b = fast._list_max(fast._arc9_min(e)).numpy()
    want_d = fast._list_max(fast._arc9_min([-x for x in e])).numpy()
    assert np.abs(circle - ctr[:, None]).max() == 255
    np.testing.assert_array_equal(tb, want_b)
    np.testing.assert_array_equal(td, want_d)
