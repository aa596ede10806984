"""Config-matrix fuzz: random corpora x random KmerConfig combinations
must always match the pure-Python oracle — the cross-product of
features (canonical, skip_invalid, compact, packed, grouping, chunked
ingest, segmentation) is where unit tests miss interactions."""

import numpy as np
import pytest

from kmer_tpu import KmerConfig, count_fasta
from kmer_tpu.utils import oracle


def _random_corpus(rng, with_n=False):
    n_reads = int(rng.integers(3, 25))
    reads = []
    for _ in range(n_reads):
        ln = int(rng.integers(0, 120))
        s = "".join("ACGT"[c] for c in rng.integers(0, 4, ln))
        if with_n and ln > 4 and rng.random() < 0.7:
            pos = int(rng.integers(0, ln))
            s = s[:pos] + "N" + s[pos + 1:]
        reads.append(s)
    return reads


@pytest.mark.parametrize("trial", range(14))
def test_fuzz_config_matrix(tmp_path, monkeypatch, trial):
    rng = np.random.default_rng(1000 + trial)
    with_n = bool(rng.random() < 0.4)
    reads = _random_corpus(rng, with_n)
    text = "".join(f">r{i}\n{s}\n" for i, s in enumerate(reads))
    p = tmp_path / f"fz{trial}.fasta"
    p.write_text(text)

    k = int(rng.choice([4, 7, 11, 15, 16, 21, 27, 31, 33, 45, 63]))
    canonical = bool(rng.random() < 0.5)
    compact = bool(rng.random() < 0.4)
    # sometimes ship the corpus BGZF-compressed (block-parallel ingest)
    if rng.random() < 0.3:
        from kmer_tpu.io.bgzf import write_bgzf
        p = tmp_path / f"fz{trial}.fasta.bgz"
        write_bgzf(str(p), text, block=int(rng.choice([512, 4096])))
    cfg = KmerConfig(
        k=k,
        canonical=canonical,
        skip_invalid=with_n,
        compact=compact,
        packed_transfer=bool(rng.random() < 0.7),
        sort_group_keys=int(rng.choice([0, 7, 64, 256])),
        batch_reads=int(rng.choice([2, 8, 32])),
        max_read_len=int(rng.choice([max(k, 24), max(k, 40), 160])),
        ingest_chunk_bases=int(rng.choice([0, 97, 1 << 20])),
    )
    # ~half the trials force the native host aggregator (any size) so
    # the matrix also fuzzes the C++ sort-reduce against the oracle
    native = bool(rng.random() < 0.5)
    monkeypatch.setenv("KMER_TPU_NATIVE_AGG", "1" if native else "0")
    table = count_fasta(str(p), cfg)
    want = oracle.oracle_count(reads, k, canonical=canonical,
                               skip_invalid=with_n)
    assert table.to_dict() == dict(want), cfg


@pytest.mark.parametrize("trial", range(6))
def test_fuzz_gapped_matrix(tmp_path, trial):
    from collections import Counter
    rng = np.random.default_rng(7000 + trial)
    reads = _random_corpus(rng)
    text = "".join(f">g{i}\n{s}\n" for i, s in enumerate(reads))
    p = tmp_path / f"fg{trial}.fasta"
    p.write_text(text)

    l_len = int(rng.integers(3, 12))
    r_len = int(rng.integers(3, 12))
    c_min = l_len + r_len + int(rng.integers(0, 6))
    c_max = c_min + int(rng.integers(0, 10))
    cfg = KmerConfig(
        gapped=True, l_len=l_len, r_len=r_len, c_min=c_min, c_max=c_max,
        compact=bool(rng.random() < 0.5),
        packed_transfer=bool(rng.random() < 0.7),
        sort_group_keys=int(rng.choice([0, 64, 256])),
        batch_reads=int(rng.choice([2, 8, 32])),
        max_read_len=int(rng.choice([max(c_max, 48), 160])),
        ingest_chunk_bases=int(rng.choice([0, 97, 1 << 20])),
    )
    table = count_fasta(str(p), cfg)
    want = Counter(oracle.oracle_gapped_lines(
        reads, l_len=l_len, r_len=r_len, c_min=c_min, c_max=c_max))
    assert table.to_dict() == dict(want), cfg


def _random_fastq(rng, n_reads):
    lines = []
    reads, quals = [], []
    for i in range(n_reads):
        ln = int(rng.integers(1, 90))
        s = "".join("ACGT"[c] for c in rng.integers(0, 4, ln))
        q = "".join(chr(33 + int(x)) for x in rng.integers(0, 41, ln))
        reads.append(s)
        quals.append(q)
        lines += [f"@r{i}", s, "+", q]
    return reads, quals, "\n".join(lines) + "\n"


@pytest.mark.parametrize("trial", range(8))
def test_fuzz_fastq_minqual_matrix(tmp_path, trial):
    """FASTQ x min_qual x (plain | bgzf) x config fuzz vs the masked
    oracle — the quality filter composed with every ingest path."""
    from kmer_tpu.io.bgzf import write_bgzf
    from kmer_tpu.utils.oracle import mask_low_quality
    rng = np.random.default_rng(5000 + trial)
    reads, quals, text = _random_fastq(rng, int(rng.integers(3, 20)))
    if rng.random() < 0.5:
        p = tmp_path / f"fq{trial}.fastq.bgz"
        write_bgzf(str(p), text, block=int(rng.choice([512, 8192])))
    else:
        p = tmp_path / f"fq{trial}.fastq"
        p.write_text(text)
    k = int(rng.choice([5, 9, 15, 21, 31]))
    mq = int(rng.choice([0, 5, 15, 30]))
    canonical = bool(rng.random() < 0.5)
    cfg = KmerConfig(
        k=k, canonical=canonical, skip_invalid=True, min_qual=mq,
        compact=bool(rng.random() < 0.3),
        packed_transfer=bool(rng.random() < 0.5),
        sort_group_keys=int(rng.choice([0, 64, 256])),
        batch_reads=int(rng.choice([2, 8, 32])),
        max_read_len=int(rng.choice([max(k, 32), 128])),
        ingest_chunk_bases=int(rng.choice([0, 131, 1 << 20])),
    )
    table = count_fasta(str(p), cfg)
    masked = [mask_low_quality(s, q, mq) for s, q in zip(reads, quals)]
    want = oracle.oracle_count(masked, k, canonical=canonical,
                               skip_invalid=True)
    assert table.to_dict() == dict(want), cfg


@pytest.mark.parametrize("trial", range(6))
def test_fuzz_spaced_matrix(tmp_path, trial):
    """Random masks x random corpora x config fuzz vs the spaced
    string oracle."""
    rng = np.random.default_rng(9000 + trial)
    reads = _random_corpus(rng)
    text = "".join(f">r{i}\n{s}\n" for i, s in enumerate(reads))
    p = tmp_path / f"sz{trial}.fasta"
    p.write_text(text)
    # random mask: 1 + random 0/1 middle + 1; palindromize half the time
    mid = "".join(rng.choice(["0", "1"], size=int(rng.integers(0, 12))))
    mask = "1" + mid + "1"
    canonical = bool(rng.random() < 0.5)
    if canonical:
        mask = mask + mask[::-1]        # force palindromic
    cfg = KmerConfig(
        seed_mask=mask, canonical=canonical,
        packed_transfer=bool(rng.random() < 0.7),
        sort_group_keys=int(rng.choice([0, 64, 256])),
        batch_reads=int(rng.choice([2, 8, 32])),
        max_read_len=int(rng.choice([max(len(mask), 24), 160])),
        ingest_chunk_bases=int(rng.choice([0, 131, 1 << 20])),
    )
    table = count_fasta(str(p), cfg)
    want = oracle.oracle_spaced_count(reads, mask, canonical=canonical)
    assert table.to_dict() == dict(want), (mask, cfg)
