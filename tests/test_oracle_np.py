"""The vectorized NumPy oracle (utils.oracle.oracle_count_np and its
FASTA reader) against the string oracle it must agree with."""

import numpy as np
import pytest

from kmer_tpu.utils import oracle


def _decode(keys, n):
    """std-layout key words -> ACGT strings, independently of the
    engine's decoder."""
    out = []
    for row in keys:
        v = 0
        for w in row:
            v = (v << 32) | int(w)
        out.append("".join("ACGT"[(v >> (2 * (n - 1 - i))) & 3]
                           for i in range(n)))
    return out


def _corpus(seed, amb):
    rng = np.random.default_rng(seed)
    R, L = 30, 90
    codes = rng.integers(0, 4, (R, L), dtype=np.uint8)
    if amb:
        codes = np.where(rng.random((R, L)) < 0.03, 4, codes).astype(np.uint8)
    lengths = rng.integers(0, L + 1, R)
    seqs = ["".join("ACGTN"[c] for c in row[:n])
            for row, n in zip(codes, lengths)]
    return codes, lengths, seqs


@pytest.mark.parametrize("k,canon,amb", [
    (1, False, False), (5, True, True), (15, False, True),
    (16, True, False), (21, True, True), (21, False, False),
    (31, False, True), (32, True, False), (45, True, True),
    (64, True, False)])
def test_oracle_count_np_matches_string_oracle(k, canon, amb):
    codes, lengths, seqs = _corpus(k * 3 + canon + amb, amb)
    keys, counts = oracle.oracle_count_np(codes, lengths, k,
                                          canonical=canon, skip_invalid=True)
    assert keys.shape[1] == (2 * k + 1 + 31) // 32
    got = dict(zip(_decode(keys, k), counts.tolist()))
    want = oracle.oracle_count(seqs, k, canonical=canon, skip_invalid=True)
    assert got == dict(want)
    # sorted unique, lexicographic in the words
    assert len(set(map(tuple, keys.tolist()))) == len(keys)
    assert keys.tolist() == sorted(keys.tolist())


@pytest.mark.parametrize("mask,canon", [("110101011", True),
                                        ("1" * 10 + "0" * 5 + "1" * 10,
                                         False)])
def test_oracle_count_np_spaced(mask, canon):
    codes, lengths, seqs = _corpus(len(mask), True)
    keys, counts = oracle.oracle_count_np(codes, lengths, 0, canonical=canon,
                                          skip_invalid=True, mask=mask)
    got = dict(zip(_decode(keys, mask.count("1")), counts.tolist()))
    want = oracle.oracle_spaced_count(seqs, mask, canonical=canon,
                                      skip_invalid=True)
    assert got == dict(want)


def test_oracle_strict_mode_rejects_ambiguous_window():
    codes, lengths, _ = _corpus(0, True)
    with pytest.raises(ValueError, match="ambiguous"):
        oracle.oracle_count_np(codes, np.full(len(codes), codes.shape[1]), 9)


def test_read_fasta_codes_np(tmp_path):
    """Multi-line records, lowercase, blank lines and unequal lengths
    parse like read_fasta_py; rows pad with code 4."""
    p = tmp_path / "r.fasta"
    p.write_text(">a\nACGT\nacg\n\n>b desc\nTTTTGGGG\n>c\nNNA\n")
    codes, lengths = oracle.read_fasta_codes_np(str(p))
    assert lengths.tolist() == [7, 8, 3]
    assert codes.shape == (3, 8)
    assert codes[0].tolist() == [0, 1, 2, 3, 0, 1, 2, 4]
    assert codes[2].tolist()[:3] == [4, 4, 0]
    seqs = oracle.read_fasta_py(str(p))
    assert [len(s) for s in seqs] == lengths.tolist()
