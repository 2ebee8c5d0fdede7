"""PyTorch port vs libstacker_tpu: Hamming 2-NN matching and the ratio /
sort / keep filter (ops/matcher.py).

Same numpy descriptors through both packages on the CPU, the JAX side
vmapped over the train sets as ``_match_and_estimate`` runs it.  Hamming
distances are integers and the distance matrix is exact in both, so the
bar is identity: every index, distance, mask and count equal, ties
included (duplicated descriptors make them the rule here), broken by the
lower index as ``lax.top_k`` and the stable ``lexsort`` break them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import n, t  # noqa: E402
from libstacker_tpu.ops import matcher as jmatcher  # noqa: E402
from libstacker_tpu_torch.ops import matcher  # noqa: E402

torch.set_num_threads(2)


def _descriptor_sets(seed, q=60, tr=50, frames=3):
    """Query and train descriptors with many exact duplicates and
    near-duplicates (ties at every rank), plus invalid slots."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (12, 32), dtype=np.uint8)
    query = pool[rng.integers(0, 12, q)].copy()
    flip = rng.random((q, 32)) < 0.02
    query ^= (flip * rng.integers(1, 256, (q, 32))).astype(np.uint8)
    train = pool[rng.integers(0, 12, (frames, tr))].copy()
    qv = rng.random(q) > 0.1
    tv = rng.random((frames, tr)) > 0.15
    tv[-1, 2:] = False  # a frame with exactly two valid train points
    return query, train, qv, tv


def _jax_knn(query, train, qv, tv):
    return jax.vmap(
        lambda d, v: jmatcher.knn_match2(jnp.asarray(query), d,
                                         jnp.asarray(qv), v)
    )(jnp.asarray(train), jnp.asarray(tv))


@pytest.mark.parametrize("seed", [0, 1])
def test_knn_match2_identical(seed):
    query, train, qv, tv = _descriptor_sets(seed)
    got = matcher.knn_match2(t(query), t(train), t(qv), t(tv))
    want = _jax_knn(query, train, qv, tv)
    np.testing.assert_array_equal(n(got.train_idx), np.asarray(want.train_idx))
    np.testing.assert_array_equal(n(got.distance), np.asarray(want.distance))
    np.testing.assert_array_equal(n(got.valid), np.asarray(want.valid))
    # the exact distance matrix itself
    qb, tb = matcher.unpack_descriptor_bits(t(query)), \
        matcher.unpack_descriptor_bits(t(train[0]))
    np.testing.assert_array_equal(
        n(qb), np.asarray(jmatcher.unpack_descriptor_bits(jnp.asarray(query))))
    np.testing.assert_array_equal(
        n(matcher.hamming_distance_matrix(qb, tb)),
        np.asarray(jmatcher.hamming_distance_matrix(
            jmatcher.unpack_descriptor_bits(jnp.asarray(query)),
            jmatcher.unpack_descriptor_bits(jnp.asarray(train[0])))))


@pytest.mark.parametrize("ratio,keep", [(0.8, 0.75), (0.95, 0.5), (1.0, 1.0)])
def test_ratio_filter_sort_keep_identical(ratio, keep):
    query, train, qv, tv = _descriptor_sets(7)
    got = matcher.ratio_filter_sort_keep(
        matcher.knn_match2(t(query), t(train), t(qv), t(tv)), ratio, keep)
    want = jax.vmap(lambda m: jmatcher.ratio_filter_sort_keep(m, ratio, keep))(
        _jax_knn(query, train, qv, tv))
    for name in got._fields:
        np.testing.assert_array_equal(n(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert n(got.count).min() >= 0
