"""Distinct-k-mer estimation (ops/sketch + pipeline/sketch).

Two-level contract, mirroring the framework's differential style:
1. EXACT: the device hash/class pipeline is bit-identical to the NumPy
   oracle (same mixer, same rho, same classes), and the accumulated
   histogram equals the oracle histogram — so the only approximation
   anywhere is the HLL estimator math itself.
2. STATISTICAL: the estimate is within the standard HLL error band of
   the exact distinct count on corpora with known cardinality.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from kmer_tpu import KmerConfig
from kmer_tpu.ops import sketch
from kmer_tpu.utils import oracle


def test_hash_classes_device_equals_numpy_oracle():
    rng = np.random.default_rng(0)
    for W in (1, 2, 3):
        words_np = [rng.integers(0, 1 << 32, 5000, dtype=np.uint32)
                    for _ in range(W)]
        valid = rng.random(5000) < 0.9
        cls_np, _ = sketch.hll_classes(words_np, valid, b=10)
        cls_dev, _ = sketch.hll_classes([jnp.asarray(w) for w in words_np],
                                        jnp.asarray(valid), b=10)
        np.testing.assert_array_equal(cls_np, np.asarray(cls_dev))


def test_rho_known_values():
    # width=22 tail: leading zeros + 1; zero tail -> width + 1
    vals = np.array([1 << 21, 1 << 20, 3, 1, 0], np.uint32)
    rho = sketch._rho32(vals, 22, True)
    np.testing.assert_array_equal(rho, [1, 2, 21, 22, 23])


def test_hll_step_histogram_matches_oracle():
    """Device step (extract + hash + scatter-add class histogram)
    accumulates exactly the oracle histogram of the same reads."""
    from kmer_tpu.ops.encode import encode_seq, key_words_from_codes
    rng = np.random.default_rng(3)
    B, L, k, b = 12, 40, 21, 8
    seqs = ["".join("ACGT"[c] for c in rng.integers(0, 4, L))
            for _ in range(B)]
    codes = np.stack([encode_seq(s) for s in seqs])
    lengths = np.full((B,), L, np.int32)
    limits = np.full((B,), L, np.int32)
    hist = jnp.zeros((1 << (b + 5),), jnp.int32)
    hist = sketch.hll_step(jnp.asarray(codes), jnp.asarray(lengths),
                           jnp.asarray(limits), hist, k=k,
                           canonical=True, b=b)
    # oracle: canonical k-mers of every window, hashed in numpy
    kmers = []
    for s in seqs:
        kmers += list(oracle.oracle_kmers(s, k, canonical=True))
    keys = np.stack([key_words_from_codes(encode_seq(km)) for km in kmers])
    words = [keys[:, j].copy() for j in range(keys.shape[1])]
    cls, _ = sketch.hll_classes(words, np.ones(len(kmers), bool), b=b)
    want = np.bincount(cls, minlength=1 << (b + 5))
    np.testing.assert_array_equal(np.asarray(hist), want)


@pytest.mark.parametrize("b,tol_sigmas", [(8, 4.0), (10, 4.0)])
def test_estimate_accuracy_known_cardinality(b, tol_sigmas):
    """Estimator within tol_sigmas * 1.04/sqrt(m) of the truth for
    uniform random keys (seeded: deterministic, no flake)."""
    rng = np.random.default_rng(7)
    n = 60_000
    words = [rng.integers(0, 1 << 32, n, dtype=np.uint32),
             rng.integers(0, 1 << 32, n, dtype=np.uint32)]
    distinct = len(set(zip(words[0].tolist(), words[1].tolist())))
    cls, _ = sketch.hll_classes(words, np.ones(n, bool), b=b)
    hist = np.bincount(cls, minlength=1 << (b + 5))
    est = sketch.estimate_from_histogram(hist, b)
    sigma = 1.04 / np.sqrt(1 << b)
    assert abs(est - distinct) / distinct < tol_sigmas * sigma


def test_estimate_small_range_exactish():
    """Few distinct keys: linear-counting regime, near-exact."""
    rng = np.random.default_rng(1)
    base = rng.integers(0, 1 << 32, 50, dtype=np.uint32)
    words = [np.tile(base, 40)]           # 2000 keys, 50 distinct
    cls, _ = sketch.hll_classes(words, np.ones(2000, bool), b=10)
    hist = np.bincount(cls, minlength=1 << 15)
    est = sketch.estimate_from_histogram(hist, 10)
    assert abs(est - 50) <= 3


def test_estimate_distinct_files_end_to_end(tmp_path):
    """Driver + CLI: estimate vs the exact table on a genome-read
    corpus (repeated k-mers), plus the total cross-check."""
    from kmer_tpu import count_fasta
    from kmer_tpu.cli import main
    from kmer_tpu.io.generator import genome_reads_fasta
    from kmer_tpu.pipeline.sketch import estimate_distinct_files
    p = tmp_path / "g.fasta"
    p.write_text(genome_reads_fasta(300, 100, genome_len=5000, seed=5))
    cfg = KmerConfig(k=21, canonical=True, batch_reads=64,
                     max_read_len=128)
    est, total = estimate_distinct_files(str(p), cfg, b=10)
    exact = count_fasta(str(p), cfg)
    assert total == exact.total
    sigma = 1.04 / np.sqrt(1 << 10)
    assert abs(est - exact.num_distinct) / exact.num_distinct < 5 * sigma

    import io
    import contextlib
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["card", str(p), "-k", "21", "--canonical",
                   "--batch-reads", "64", "--max-read-len", "128"])
    assert rc == 0
    lines = dict(ln.split("\t") for ln in buf.getvalue().splitlines())
    assert int(lines["total_kmers"]) == exact.total
    assert int(lines["distinct_estimate"]) == round(est)


def test_estimate_with_min_qual(tmp_path):
    """Masked bases shrink the hashed-window total (skip_invalid path
    through the estimator)."""
    from kmer_tpu.io.generator import random_reads_fastq
    from kmer_tpu.pipeline.sketch import estimate_distinct_files
    p = tmp_path / "q.fastq"
    p.write_text(random_reads_fastq(40, 60, seed=2, qual_range=(0, 41)))
    cfg = KmerConfig(k=11, batch_reads=16, max_read_len=64,
                     skip_invalid=True, min_qual=15)
    est, total = estimate_distinct_files(str(p), cfg, b=8)
    _, total_all = estimate_distinct_files(
        str(p), cfg.replace(min_qual=0), b=8)
    assert 0 < total < total_all


def test_histo_two_pass_cli(tmp_path, capsys):
    """Streaming spectrum (histo --two-pass) == in-memory spectrum."""
    from kmer_tpu.cli import main
    from kmer_tpu.io.generator import genome_reads_fasta
    p = tmp_path / "h.fasta"
    p.write_text(genome_reads_fasta(60, 80, genome_len=2000, seed=9))
    args = ["histo", str(p), "-k", "15", "--canonical",
            "--batch-reads", "16", "--max-read-len", "96"]
    assert main(args) == 0
    in_mem = capsys.readouterr().out
    assert main(args + ["--two-pass", "--spill-dir",
                        str(tmp_path / "sp"), "--partitions", "4"]) == 0
    assert capsys.readouterr().out == in_mem


def test_multi_k_one_pass_equals_per_k(tmp_path):
    """Multi-k sketching in one ingest pass must produce the SAME
    histograms (hence estimates and totals) as separate single-k runs
    — segmentation at overlap max(ks)-1 keeps every smaller-k window
    owned exactly once."""
    from kmer_tpu.io.generator import genome_reads_fasta
    from kmer_tpu.pipeline.sketch import (estimate_distinct_files,
                                          estimate_distinct_multi_k)
    p = tmp_path / "mk.fasta"
    # read length > max_read_len so records split with seams
    p.write_text(genome_reads_fasta(60, 300, genome_len=4000, seed=13))
    cfg = KmerConfig(k=31, canonical=True, batch_reads=16,
                     max_read_len=128)
    ks = [11, 21, 31]
    multi = estimate_distinct_multi_k(str(p), ks, cfg, b=9)
    for kk, got in zip(ks, multi):
        want = estimate_distinct_files(str(p), cfg.replace(k=kk), b=9)
        assert got == want, kk


def test_card_cli_multi_k(tmp_path, capsys):
    from kmer_tpu.cli import main
    from kmer_tpu.io.generator import genome_reads_fasta
    p = tmp_path / "ck.fasta"
    p.write_text(genome_reads_fasta(40, 90, genome_len=2000, seed=14))
    assert main(["card", str(p), "-k", "11", "-k", "21",
                 "--batch-reads", "16", "--max-read-len", "96"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 and out[0].startswith("k=11\t")
    assert out[2].startswith("k=21\t")


def test_card_duplicate_k_and_bad_b(tmp_path, capsys):
    from kmer_tpu.cli import main
    from kmer_tpu.io.generator import genome_reads_fasta
    from kmer_tpu.pipeline.sketch import estimate_distinct_multi_k
    p = tmp_path / "dk.fasta"
    p.write_text(genome_reads_fasta(20, 60, genome_len=1000, seed=15))
    cfg = KmerConfig(k=11, batch_reads=8, max_read_len=64)
    # duplicates dedupe instead of double-accumulating the total
    [(e1, t1)] = estimate_distinct_multi_k(str(p), [11, 11], cfg, b=8)
    [(e2, t2)] = estimate_distinct_multi_k(str(p), [11], cfg, b=8)
    assert (e1, t1) == (e2, t2)
    # out-of-range precision is a clean CLI error, not a traceback
    assert main(["card", str(p), "-k", "11", "--buckets-log2", "12",
                 "--batch-reads", "8", "--max-read-len", "64"]) == 1
    assert "buckets_log2" in capsys.readouterr().err


def test_card_spaced_seed(tmp_path):
    """Distinct estimation over spaced keys: total equals the exact
    spaced window count and the estimate tracks the exact distinct."""
    from kmer_tpu import count_fasta
    from kmer_tpu.io.generator import genome_reads_fasta
    from kmer_tpu.pipeline.sketch import estimate_distinct_multi_k
    p = tmp_path / "cs.fasta"
    p.write_text(genome_reads_fasta(200, 100, genome_len=4000, seed=17))
    mask = "110101011"
    cfg = KmerConfig(seed_mask=mask, canonical=True, batch_reads=32,
                     max_read_len=128)
    [(est, total)] = estimate_distinct_multi_k(str(p), [21], cfg, b=10)
    exact = count_fasta(str(p), cfg)
    assert total == exact.total
    sigma = 1.04 / np.sqrt(1 << 10)
    assert abs(est - exact.num_distinct) / exact.num_distinct < 5 * sigma
