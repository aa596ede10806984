"""The scatter-add histograms (ops/count.dense_histogram, the HLL
class histogram of ops/sketch.hll_step) vs np.bincount."""

import numpy as np
import pytest

import jax.numpy as jnp

from kmer_tpu.ops.count import dense_histogram, index_histogram


@pytest.mark.parametrize("k,N", [(8, 5000), (8, 1024), (6, 3000), (4, 2048)])
def test_histogram_matches_bincount(k, N):
    rng = np.random.default_rng(k * 100 + N)
    idx = rng.integers(0, 4 ** k, N, dtype=np.int32)
    valid = rng.random(N) < 0.8
    got = dense_histogram(jnp.asarray(idx), jnp.asarray(valid), k)
    want = np.bincount(idx[valid], minlength=4 ** k)
    np.testing.assert_array_equal(np.asarray(got), want)
    # accumulation into a carried table adds
    again = dense_histogram(jnp.asarray(idx), jnp.asarray(valid), k, got)
    np.testing.assert_array_equal(np.asarray(again), 2 * want)


def test_histogram_all_invalid():
    idx = np.zeros(2048, np.int32)
    got = dense_histogram(jnp.asarray(idx), jnp.zeros(2048, bool), 8)
    assert int(np.asarray(got).sum()) == 0


def test_index_histogram_2d_input_shapes():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 4 ** 8, (16, 130), dtype=np.int32)
    valid = rng.random((16, 130)) < 0.5
    got = index_histogram(jnp.asarray(idx), jnp.asarray(valid), 4 ** 8)
    want = np.bincount(idx[valid].ravel(), minlength=4 ** 8)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_hll_step_histogram_matches_bincount():
    """hll_step's accumulated class histogram == np.bincount of the
    NumPy-computed classes of the same keys, on 2-D batches with short
    reads and limits."""
    from kmer_tpu.ops.canonical import canonical_kmer_lanes
    from kmer_tpu.ops.sketch import hll_classes, hll_step
    rng = np.random.default_rng(0)
    B, L, k, b = 16, 130, 21, 8
    codes = jnp.asarray(rng.integers(0, 4, (B, L), dtype=np.uint8))
    lengths = jnp.asarray(rng.integers(0, L + 1, B, dtype=np.int32))
    limits = jnp.asarray(rng.integers(1, L + 1, B, dtype=np.int32))
    hist = hll_step(codes, lengths, limits,
                    jnp.zeros((1 << (b + 5),), jnp.int32), k=k,
                    canonical=True, b=b)
    words, valid = canonical_kmer_lanes(codes, lengths, k, limits=limits)
    v = np.asarray(valid).reshape(-1)
    cls, _ = hll_classes([np.asarray(w).reshape(-1)[v] for w in words],
                         None, b)
    want = np.bincount(cls, minlength=1 << (b + 5))
    np.testing.assert_array_equal(np.asarray(hist), want)
    assert int(want.sum()) == int(v.sum())
