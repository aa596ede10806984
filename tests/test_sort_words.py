"""ops.count.sort_words (the flat lexicographic multi-word sort) vs a
NumPy ground truth: random keys, sentinels, duplicates, large and odd
sizes, presorted and reversed input."""

import numpy as np
import pytest

import jax.numpy as jnp

from kmer_tpu.ops.count import sort_words
from kmer_tpu.ops.extract import SENTINEL


def _np_sorted(words):
    """Ground truth: lexicographic sort of the word tuples."""
    keys = np.stack([np.asarray(w).reshape(-1) for w in words], axis=1)
    order = np.lexsort(keys.T[::-1])
    return [keys[order, i] for i in range(keys.shape[1])]


def _check(words):
    got = sort_words([jnp.asarray(w) for w in words])
    want = _np_sorted(words)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)


@pytest.mark.parametrize("W", [1, 2, 4])
@pytest.mark.parametrize("N", [1024, 1500, 4096])
def test_sort_random(W, N):
    rng = np.random.default_rng(N * 10 + W)
    _check([rng.integers(0, 2**32, N, dtype=np.uint32) for _ in range(W)])


def test_sort_with_sentinels():
    rng = np.random.default_rng(0)
    N = 2048
    hi = rng.integers(0, 2**11, N, dtype=np.uint32)
    lo = rng.integers(0, 2**32, N, dtype=np.uint32)
    inval = rng.random(N) < 0.3
    hi[inval] = np.uint32(SENTINEL)
    lo[inval] = np.uint32(SENTINEL)
    _check([hi, lo])


def test_sort_many_duplicates():
    rng = np.random.default_rng(1)
    N = 4096
    _check([rng.integers(0, 4, N, dtype=np.uint32),
            rng.integers(0, 8, N, dtype=np.uint32)])


def test_sort_large_odd_size():
    rng = np.random.default_rng(2)
    _check([rng.integers(0, 2**32, 6000, dtype=np.uint32)
            for _ in range(2)])


def test_sort_large_pow2():
    rng = np.random.default_rng(3)
    _check([rng.integers(0, 2**32, 8192, dtype=np.uint32)
            for _ in range(2)])


def test_sort_small():
    rng = np.random.default_rng(4)
    _check([rng.integers(0, 2**32, 100, dtype=np.uint32) for _ in range(2)])


def test_presorted_and_reversed():
    N = 2048
    asc = np.arange(N, dtype=np.uint32)
    _check([asc])
    _check([asc[::-1].copy()])
