"""The sort-mode count steps (ops/count grouped count, compaction, the
pipeline's jitted steps) against flat sorts, the string oracle and the
NumPy oracle: key widths W = 1..4, canonical and skip-invalid modes,
short reads, ownership limits, group sizes that do not divide the key
stream, and 2-bit packed transfer."""

import numpy as np
import pytest

import jax.numpy as jnp

from kmer_tpu import KmerConfig, count_fasta
from kmer_tpu.ops import count as C
from kmer_tpu.ops.canonical import canonical_kmer_lanes
from kmer_tpu.ops.encode import words_per_key
from kmer_tpu.ops.extract import SENTINEL, kmer_lanes
from kmer_tpu.pipeline.count import (count_step_compact, count_step_sort,
                                     fetch_compact_rows, spaced_step_sort)
from kmer_tpu.pipeline.table import KmerTable
from kmer_tpu.utils import oracle


def _aggregate(k, std, is_start, counts):
    ks = np.stack([np.asarray(w).reshape(-1) for w in std], 1)
    cc = np.asarray(counts).reshape(-1)
    sel = np.asarray(is_start).reshape(-1) & (cc > 0)
    return KmerTable.from_pairs(k, ks[sel], cc[sel])


def _batch(seed, B, L, amb=False, hi_amb=5):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, hi_amb if amb else 4, (B, L), dtype=np.uint8)
    lengths = rng.integers(0, L + 1, B, dtype=np.int32)
    limits = rng.integers(1, L + 1, B, dtype=np.int32)
    return jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(limits)


def _lanes_truth(k, codes, lengths, limits, canon, amb):
    fn = canonical_kmer_lanes if canon else kmer_lanes
    words, valid = fn(codes, lengths, k, limits=limits, mask_ambiguous=amb)
    ks = np.stack([np.asarray(w).reshape(-1) for w in words], 1)
    v = np.asarray(valid).reshape(-1)
    return KmerTable.from_pairs(k, ks[v], np.ones(int(v.sum()), np.int64))


@pytest.mark.parametrize("k", [15, 21, 54])
def test_grouped_count_matches_truth(k):
    """W = 1, 2, 4 word keys with duplicates, comparator ties and
    invalid lanes: grouped_count at several group sizes == the
    aggregated truth."""
    rng = np.random.default_rng(k)
    n = 700
    W = words_per_key(k)
    s = 2 * k - 32 * (W - 1)
    valid = rng.random(n) < 0.85
    words = []
    for i in range(W):
        used = s if i == 0 else 32
        # tiny value range forces duplicate keys and sort-prefix ties
        w = rng.integers(0, min(1 << used, 6), n).astype(np.uint32)
        words.append(np.where(valid, w, 0xFFFFFFFF).astype(np.uint32))
    jw = [jnp.asarray(w) for w in words]
    jv = jnp.asarray(valid)
    truth = KmerTable.from_pairs(k, np.stack(words, 1)[valid],
                                 np.ones(int(valid.sum()), np.int64))
    for m in (8, 128, 1024):
        assert _aggregate(k, *C.grouped_count(jw, jv, k, m)) == truth, m


@pytest.mark.parametrize("k,canon", [(21, True), (21, False), (17, True),
                                     (31, False), (25, True)])
def test_repack_roundtrip(k, canon):
    """repack_words -> unpack_words is the identity on extracted keys,
    the residual word carries validity (SENTINEL exactly on invalid
    lanes), and num_keys is W-1."""
    codes, lengths, limits = _batch(3 * k + canon, 40, 80)
    fn = canonical_kmer_lanes if canon else kmer_lanes
    words, valid = fn(codes, lengths, k, limits=limits)
    flat = [w.reshape(-1) for w in words]
    rw, nk = C.repack_words(flat, valid.reshape(-1), k)
    assert nk == words_per_key(k) - 1
    v = np.asarray(valid).reshape(-1)
    assert ((np.asarray(rw[-1]) == SENTINEL) == ~v).all()
    for a, b in zip(C.unpack_words(rw, k), flat):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_count_step_unpacked_end_to_end(tmp_path):
    """count_fasta with 2-bit packed transfer off (u8 rows) == oracle."""
    from kmer_tpu.io.generator import random_reads_fasta
    p = tmp_path / "pe.fasta"
    p.write_text(random_reads_fasta(15, 70, seed=9))
    t = count_fasta(str(p), KmerConfig(k=21, canonical=True, batch_reads=8,
                                       max_read_len=96,
                                       packed_transfer=False))
    want = oracle.oracle_count(oracle.read_fasta_py(str(p)), 21,
                               canonical=True)
    assert t.to_dict() == dict(want)


@pytest.mark.parametrize("part_keys", [128, 2048])
@pytest.mark.parametrize("k,canon,amb", [(21, True, False),
                                         (21, False, True),
                                         (17, True, True),
                                         (31, False, False),
                                         (11, True, False)])
def test_compact_step_matches_sort_step(k, canon, amb, part_keys):
    """On-device compaction (count_step_compact -> KmerTable.from_compact)
    == the grouped sort step's table, across key widths, canonical and
    skip-invalid modes, short reads and limits, and partition sizes."""
    codes, lengths, limits = _batch(5 * k + 2 * canon + amb, 24, 60, amb)
    rows, total = count_step_compact(codes, lengths, limits, k=k,
                                     canonical=canon, mask_ambiguous=amb,
                                     group_keys=64, part_keys=part_keys)
    got = KmerTable.from_compact(k, fetch_compact_rows(rows, total))
    want = _aggregate(k, *count_step_sort(codes, lengths, limits, k=k,
                                          canonical=canon,
                                          mask_ambiguous=amb,
                                          group_keys=64))
    assert got == want
    assert got == _lanes_truth(k, codes, lengths, limits, canon, amb)


_GRID = [(5, True, True), (13, False, True), (21, True, False),
         (27, True, True), (31, True, False)]


@pytest.mark.parametrize("group_keys", [8, 64, 256, 4096])
@pytest.mark.parametrize("k,canon,amb", _GRID)
def test_grouped_step_bit_equals_flat_sort(k, canon, amb, group_keys):
    """The grouped step (partial aggregation in group_keys-sized sort
    slices) and the exact flat sort (group_keys=0) give the same table,
    across key widths, canonical selection and ambiguity masking."""
    codes, lengths, limits = _batch(7 * k + 2 * canon + amb, 48, 73, amb, 8)
    kw = dict(k=k, canonical=canon, mask_ambiguous=amb)
    got = _aggregate(k, *count_step_sort(codes, lengths, limits,
                                         group_keys=group_keys, **kw))
    s, is_start, counts = count_step_sort(codes, lengths, limits,
                                          group_keys=0, **kw)
    # the flat sort's runs are already unique and globally sorted
    flat = KmerTable.from_device_runs(k, s, is_start, counts)
    assert got == flat
    assert (np.diff(flat.keys[:, 0].astype(np.int64)) >= 0).all()


@pytest.mark.parametrize("group_keys", [8, 64, 256, 4096])
@pytest.mark.parametrize("k,canon", [(33, True), (45, False), (63, True),
                                     (16, True), (32, False)])
def test_grouped_multiword_keys_match_oracle(k, canon, group_keys):
    """Multi-word keys (k >= 33: 3- and 4-word keys) and the s == 0
    widths (k = 16/32, flag-payload residual) through the grouped step
    match the string oracle, with sparse ambiguity masking."""
    rng = np.random.default_rng(17 * k + canon)
    B, L = 24, 96
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    m = rng.random((B, L)) < 0.02
    codes = np.where(m, 4, codes).astype(np.uint8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    got = _aggregate(k, *count_step_sort(
        jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(lengths),
        k=k, canonical=canon, mask_ambiguous=True, group_keys=group_keys))
    seqs = ["".join("ACGTN"[c] for c in row[:n])
            for row, n in zip(codes, lengths)]
    want = oracle.oracle_count(seqs, k, canonical=canon, skip_invalid=True)
    assert got.to_dict() == dict(want)
    assert got.num_distinct > 0


def test_packed_width_unpacking():
    """The packed transfer (B, ceil(L/16)) uint32 rows unpacked on
    device give the same step outputs as the u8 rows."""
    from kmer_tpu.io.fasta import pack_batch_codes
    codes, lengths, limits = _batch(4, 16, 150)
    packed = jnp.asarray(pack_batch_codes(np.asarray(codes)))
    assert packed.shape == (16, -(-150 // 16))
    a = count_step_sort(codes, lengths, limits, k=21, canonical=True,
                        group_keys=256)
    b = count_step_sort(packed, lengths, limits, k=21, canonical=True,
                        group_keys=256, packed_width=150)
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    np.testing.assert_array_equal(np.asarray(a[2]), np.asarray(b[2]))


def test_count_fasta_small_groups_end_to_end(tmp_path):
    """count_fasta with 16-key sort groups (many partial runs for the
    host merge) == oracle, canonical and not."""
    from kmer_tpu.io.generator import reference_style_fasta
    p = tmp_path / "fp.fasta"
    p.write_text(reference_style_fasta(n_records=3, seed=47))
    for k, canon in ((21, True), (11, False)):
        t = count_fasta(str(p), KmerConfig(k=k, canonical=canon,
                                           batch_reads=8, max_read_len=128,
                                           sort_group_keys=16))
        want = oracle.oracle_count(oracle.read_fasta_py(str(p)), k,
                                   canonical=canon)
        assert t.to_dict() == dict(want), k


def test_group_larger_than_batch_end_to_end(tmp_path):
    """A sort group larger than the batch's whole key stream (the group
    shrinks to the stream) == oracle."""
    from kmer_tpu.io.generator import reference_style_fasta
    p = tmp_path / "tp.fasta"
    p.write_text(reference_style_fasta(n_records=3, seed=31))
    for k, canon in ((21, True), (11, False)):
        t = count_fasta(str(p), KmerConfig(k=k, canonical=canon,
                                           batch_reads=2, max_read_len=64,
                                           sort_group_keys=1 << 16))
        want = oracle.oracle_count(oracle.read_fasta_py(str(p)), k,
                                   canonical=canon)
        assert t.to_dict() == dict(want), k


def test_sentinel_padding_when_group_does_not_divide():
    """A key stream that group_keys does not divide is padded with
    sentinel lanes: the output grows to the next multiple, padded lanes
    count 0, and the counts still sum to the valid lanes."""
    codes, lengths, limits = _batch(11, 5, 30)
    words, valid = kmer_lanes(codes, lengths, 9, limits=limits)
    n = valid.size                       # 5 * 22 = 110 lanes
    std, is_start, counts = C.grouped_count(words, valid, 9, 64)
    assert counts.shape == (128,) and std[0].shape == (128,)
    assert int(np.asarray(counts)[n:].sum()) == 0
    assert int(np.asarray(counts).sum()) == int(np.asarray(valid).sum())


def test_multiword_k45_end_to_end(tmp_path):
    """k=45 (W=3) counting: grouped pipeline == the flat-sort pipeline
    (sort_group_keys=0) bit-exactly."""
    from kmer_tpu.io.generator import random_reads_fasta
    p = tmp_path / "bigk.fasta"
    p.write_text(random_reads_fasta(6, 120, seed=11))
    cfg = KmerConfig(k=45, canonical=True, batch_reads=8,
                     max_read_len=128, sort_group_keys=64)
    got = count_fasta(str(p), cfg)
    want = count_fasta(str(p), cfg.replace(sort_group_keys=0))
    assert got == want
    assert (got.keys == want.keys).all()


def test_spaced_grouped_bit_equals_flat():
    """Spaced-seed keys through the grouped step == the flat sort."""
    from kmer_tpu.ops.extract import parse_seed_mask
    codes, lengths, limits = _batch(99, 32, 64, True, 8)
    positions = parse_seed_mask("110101011")
    kw = dict(positions=positions, canonical=True, mask_ambiguous=True)
    got = _aggregate(6, *spaced_step_sort(codes, lengths, limits,
                                          group_keys=64, **kw))
    s, is_start, counts = spaced_step_sort(codes, lengths, limits,
                                           group_keys=0, **kw)
    assert got == KmerTable.from_device_runs(6, s, is_start, counts)
