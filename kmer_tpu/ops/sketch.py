"""Streaming distinct-k-mer estimation (F0 cardinality) — the
ntCard/HyperLogLog capability.

A HyperLogLog register file is per-bucket MAX of rho (the position of
the first set bit of the hashed key's tail).  Presence is enough:
registers derive from the SET of occupied (bucket, rho) classes, so
the device step is: extract keys (the existing slice-sum/canonical
path), mix them to 32-bit hashes, form class = bucket * 32 + min(rho,
31), and accumulate one (2^(b+5),) class histogram (a scatter-add,
ops/count.index_histogram) IN DEVICE MEMORY across all batches — the
host fetches ~2^(b+5) * 4 bytes once per corpus (128 KB at b=10)
instead of any per-batch key stream, and peak host memory is O(2^b)
regardless of corpus size.

The reference has no estimation capability at all (its only output is
the sorted dump, main.rs:87-90); this is a capability extension in the
spirit of ntCard.

Exactness of the hash pipeline (not the estimate) is pinned by a
bit-identical NumPy oracle (tests/test_sketch.py); the estimate obeys
the standard HLL error model sigma ~ 1.04/sqrt(2^b).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_RHO_SLOTS = 32           # class = bucket * 32 + min(rho, 31)
# per-cell saturation cap for the accumulated class histogram (see
# hll_step); a cell at the cap means "sum no longer equals windows"
HIST_CAP = np.int32(1 << 30)


def _u32(x, np_mode: bool):
    return np.uint32(x) if np_mode else jnp.uint32(x)


def _mix32(h, np_mode: bool):
    """murmur3 fmix32 — identical bit-for-bit under jnp (device) and
    numpy (the oracle)."""
    h = h ^ (h >> _u32(16, np_mode))
    h = h * _u32(0x85EBCA6B, np_mode)
    h = h ^ (h >> _u32(13, np_mode))
    h = h * _u32(0xC2B2AE35, np_mode)
    return h ^ (h >> _u32(16, np_mode))


def hash_words(words) -> jnp.ndarray:
    """32-bit mix of a multi-word key: fold the words through an
    FNV-style combine + the murmur3 finalizer (word count is static,
    so this unrolls).  Same bit-for-bit result under numpy."""
    np_mode = isinstance(words[0], np.ndarray)
    h = _u32(0x9E3779B9, np_mode)
    for w in words:
        h = _mix32((h ^ w) * _u32(0x01000193, np_mode)
                   + _u32(0x811C9DC5, np_mode), np_mode)
    return h


def _rho32(tail, width: int, np_mode: bool):
    """Position (1-based) of the highest set bit's leading-zero run in
    a `width`-bit tail: rho = clz_width(tail) + 1; tail == 0 gives
    width + 1.  Branch-free smear + popcount (same ops in jnp/numpy)."""
    u = lambda x: _u32(x, np_mode)                       # noqa: E731
    x = tail
    for s in (1, 2, 4, 8, 16):
        x = x | (x >> u(s))
    # popcount (SWAR)
    x = x - ((x >> u(1)) & u(0x55555555))
    x = (x & u(0x33333333)) + ((x >> u(2)) & u(0x33333333))
    x = (((x + (x >> u(4))) & u(0x0F0F0F0F)) * u(0x01010101)) >> u(24)
    # x = width - clz_width(tail)  ->  rho = width - x + 1
    return u(width) - x + u(1)


def hll_classes(words, valid, b: int):
    """(class_idx int32, valid) for the (bucket, rho) HLL histogram.

    bucket = top b hash bits; rho over the remaining (32 - b) bits.
    Works on jnp arrays (device) and numpy arrays (oracle) identically.
    """
    np_mode = isinstance(words[0], np.ndarray)
    u = lambda x: _u32(x, np_mode)                       # noqa: E731
    h = hash_words(words)
    bucket = h >> u(32 - b)
    tail = h & u((1 << (32 - b)) - 1)
    rho = _rho32(tail, 32 - b, np_mode)
    mn = np.minimum if np_mode else jnp.minimum
    rho = mn(rho, u(_RHO_SLOTS - 1))
    cls = (bucket * u(_RHO_SLOTS) + rho).astype(
        np.int32 if np_mode else jnp.int32)
    return cls, valid


@partial(jax.jit, static_argnames=("k", "canonical", "mask_ambiguous",
                                   "b", "packed_width", "positions"))
def hll_step(codes, lengths, limits, hist, *, k: int, canonical: bool,
             b: int = 10, mask_ambiguous: bool = False,
             packed_width: int = 0, positions: tuple | None = None):
    """One device batch of the estimator: extract + hash + class
    histogram, ACCUMULATED into `hist` ((2^(b+5),) int32, carried on
    device across batches — D2H happens once per corpus).  positions:
    spaced-seed match offsets (keys = bases at those offsets; k is
    then the popcount)."""
    if packed_width:
        from .encode import unpack_codes_u32
        codes = unpack_codes_u32(codes, packed_width)
    from .canonical import canonical_kmer_lanes
    from .count import index_histogram
    from .extract import kmer_lanes, mask_from_positions, spaced_lanes
    if positions is not None:
        words, valid = spaced_lanes(codes, lengths,
                                    mask_from_positions(positions),
                                    limits=limits, canonical=canonical,
                                    mask_ambiguous=mask_ambiguous)
    elif canonical:
        words, valid = canonical_kmer_lanes(codes, lengths, k, limits=limits,
                                            mask_ambiguous=mask_ambiguous)
    else:
        words, valid = kmer_lanes(codes, lengths, k, limits=limits,
                                  mask_ambiguous=mask_ambiguous)
    cls, v = hll_classes([w.reshape(-1) for w in words],
                         valid.reshape(-1), b)
    hb = index_histogram(cls, v, 1 << (b + 5))
    # saturate far below int32 wrap (a (bucket, rho) cell would wrap —
    # and read as UNOCCUPIED — once its windows approach 2^31 in a long
    # corpus): occupancy, all the estimator needs, only requires > 0,
    # and an unsaturated histogram still sums exactly for the
    # strict-mode totals cross-check.  hb per batch << 2^30 lanes, so
    # hist + hb cannot overflow before the clamp.
    return jnp.minimum(hist + hb, HIST_CAP)


def registers_from_histogram(hist: np.ndarray, b: int) -> np.ndarray:
    """(2^b,) uint8 HLL registers: per-bucket max occupied rho slot."""
    m = 1 << b
    h2 = np.asarray(hist).reshape(m, _RHO_SLOTS)
    occ = h2 > 0
    # argmax of reversed occupancy gives the highest occupied slot
    rev = occ[:, ::-1]
    top = _RHO_SLOTS - 1 - rev.argmax(axis=1)
    return np.where(occ.any(axis=1), top, 0).astype(np.uint8)


def estimate_from_registers(reg: np.ndarray, b: int) -> float:
    """Standard 32-bit HyperLogLog estimator with small-range (linear
    counting) and large-range corrections (Flajolet et al. 2007)."""
    m = float(1 << b)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    e = alpha * m * m / np.sum(np.exp2(-reg.astype(np.float64)))
    if e <= 2.5 * m:
        v = int(np.count_nonzero(reg == 0))
        if v > 0:
            e = m * np.log(m / v)
    elif e > (1 << 32) / 30.0:
        e = -(2.0 ** 32) * np.log1p(-e / 2.0 ** 32)
    return float(e)


def estimate_from_histogram(hist: np.ndarray, b: int) -> float:
    return estimate_from_registers(registers_from_histogram(hist, b), b)
