"""Spaced-seed counting (PatternHunter-style 0/1 match masks).

Differential contracts: the slice-sum extractor and the grouped spaced
count step must equal the string oracle, across key widths, canonical
(palindromic masks), skip-invalid, packed transfer, and split-read
seams."""

import numpy as np
import pytest

import jax.numpy as jnp

from kmer_tpu import KmerConfig, count_fasta
from kmer_tpu.ops.extract import (parse_seed_mask, seed_mask_palindromic,
                                  spaced_lanes)
from kmer_tpu.pipeline.table import KmerTable
from kmer_tpu.utils import oracle


def test_parse_seed_mask():
    assert parse_seed_mask("1101011") == (0, 1, 3, 5, 6)
    assert seed_mask_palindromic("1101011")
    assert not seed_mask_palindromic("1101")
    for bad in ("", "102", "011", "110", "0"):
        with pytest.raises(ValueError):
            parse_seed_mask(bad)


@pytest.mark.parametrize("mask,canon,amb", [
    ("1101011", False, False),
    ("1101011", True, False),         # palindromic -> canonical ok
    ("11011", True, True),
    ("1" * 10 + "0" * 5 + "1" * 10, False, False),   # W=2 keys
    ("110100101011", False, True),    # non-palindromic, masked
    ("1011101110111011101", True, False),  # wide-ish, palindromic
])
def test_spaced_lanes_matches_oracle(mask, canon, amb):
    import zlib
    rng = np.random.default_rng(zlib.crc32(mask.encode()))
    B, L = 14, 60
    hi = 5 if amb else 4
    codes = rng.integers(0, hi, (B, L), dtype=np.uint8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    words, valid = spaced_lanes(jnp.asarray(codes), jnp.asarray(lengths),
                                mask, mask_ambiguous=amb, canonical=canon)
    ks = np.stack([np.asarray(w).reshape(-1) for w in words], 1)
    v = np.asarray(valid).reshape(-1)
    got = KmerTable.from_pairs(len(parse_seed_mask(mask)), ks[v],
                               np.ones(int(v.sum()), np.int64))
    seqs = ["".join("ACGTN"[c] for c in row[:ln])
            for row, ln in zip(codes, lengths)]
    want = oracle.oracle_spaced_count(seqs, mask, canonical=canon,
                                      skip_invalid=True)
    assert got.to_dict() == dict(want)


@pytest.mark.parametrize("mask,canon,amb", [
    ("1101011", True, False),
    ("11011", False, True),
    ("1" * 10 + "0" * 5 + "1" * 10, False, False),
    ("1011101110111011101", True, True),
])
def test_spaced_step_grouped_matches_lanes(mask, canon, amb):
    """The grouped spaced count step (spaced_step_sort, packed 2-bit
    transfer off) == spaced_lanes as aggregated tables, with short
    reads and ownership limits."""
    from kmer_tpu.pipeline.count import spaced_step_sort
    positions = parse_seed_mask(mask)
    kk = len(positions)
    rng = np.random.default_rng(len(mask) * 7 + canon + amb)
    B, L = 48, 64
    hi = 8 if amb else 4
    codes = rng.integers(0, hi, (B, L), dtype=np.uint8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    limits = rng.integers(0, L + 1, B).astype(np.int32)
    std, is_start, counts = spaced_step_sort(
        jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(limits),
        positions=positions, canonical=canon, mask_ambiguous=amb,
        group_keys=64)
    ks = np.stack([np.asarray(w).reshape(-1) for w in std], 1)
    cc = np.asarray(counts).reshape(-1)
    sel = np.asarray(is_start).reshape(-1) & (cc > 0)
    got = KmerTable.from_pairs(kk, ks[sel], cc[sel].astype(np.int64))
    words, valid = spaced_lanes(jnp.asarray(codes),
                                jnp.asarray(lengths), mask,
                                limits=jnp.asarray(limits),
                                mask_ambiguous=amb, canonical=canon)
    kw = np.stack([np.asarray(w).reshape(-1) for w in words], 1)
    v = np.asarray(valid).reshape(-1)
    want = KmerTable.from_pairs(kk, kw[v], np.ones(int(v.sum()), np.int64))
    assert got == want


def test_spaced_count_end_to_end(tmp_path):
    """count_fasta with seed_mask (split reads + packed transfer) ==
    oracle, and the grouped pipeline == the flat-sort pipeline."""
    from kmer_tpu.io.generator import genome_reads_fasta
    p = tmp_path / "sp.fasta"
    p.write_text(genome_reads_fasta(60, 200, genome_len=3000, seed=21))
    mask = "110101011"                       # palindromic
    cfg = KmerConfig(seed_mask=mask, canonical=True, batch_reads=16,
                     max_read_len=96, sort_group_keys=64)
    got = count_fasta(str(p), cfg)
    want = oracle.oracle_spaced_count(oracle.read_fasta_py(str(p)),
                                      mask, canonical=True)
    assert got.to_dict() == dict(want)
    assert count_fasta(str(p), cfg.replace(sort_group_keys=0)) == got


def test_spaced_cli(tmp_path, capsys):
    from kmer_tpu.cli import main
    from kmer_tpu.io.generator import random_reads_fasta
    p = tmp_path / "c.fasta"
    p.write_text(random_reads_fasta(10, 40, seed=3))
    assert main(["count", str(p), "--seed-mask", "110011",
                 "--batch-reads", "8", "--max-read-len", "64"]) == 0
    out = capsys.readouterr().out.splitlines()
    total = sum(int(ln.split("\t")[1]) for ln in out)
    assert total == 10 * (40 - 6 + 1)
    assert all(len(ln.split("\t")[0]) == 4 for ln in out)
    # config errors are clean
    assert main(["count", str(p), "--seed-mask", "1101",
                 "--canonical"]) == 1


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_spaced_mesh_streaming(tmp_path, shape):
    """seed_mask through the mesh-attached StreamingCounter (the last
    feature x execution-path combo, VERDICT r3 #3): bit-identical to
    single-device spaced streaming across mesh shapes."""
    import jax
    from kmer_tpu.io.generator import genome_reads_fasta
    from kmer_tpu.parallel import mesh as mesh_lib
    from kmer_tpu.pipeline.streaming import StreamingCounter, \
        stream_count_fasta
    if len(jax.devices()) < shape[0] * shape[1]:
        pytest.skip("needs the multi-device CPU mesh")
    p = tmp_path / "sp.fasta"
    p.write_text(genome_reads_fasta(48, 120, genome_len=2000, seed=33))
    cfg = KmerConfig(seed_mask="110101011", canonical=True,
                     batch_reads=16, max_read_len=64, partitions=4)
    want = stream_count_fasta(str(p), cfg, spill_dir=str(tmp_path / "s1"))
    sc = StreamingCounter(str(p), cfg,
                          str(tmp_path / f"sm{shape[0]}x{shape[1]}"),
                          mesh=mesh_lib.make_mesh(*shape))
    sc.run()
    assert sc.final_table() == want
    # and the table is the oracle's
    want_o = oracle.oracle_spaced_count(oracle.read_fasta_py(str(p)),
                                        "110101011", canonical=True)
    assert sc.final_table().to_dict() == dict(want_o)


@pytest.mark.parametrize("n_data,n_seq", [(1, 1), (4, 1), (2, 2), (4, 2)])
def test_spaced_distributed_pairs(n_data, n_seq):
    """Spaced seeds through the local-count pair-routing path: table
    bit-identical to the oracle across mesh shapes (incl. sequence
    sharding with the span-1 halo)."""
    from kmer_tpu.ops.encode import BASE_ORDER, encode_seq
    from kmer_tpu.parallel import distributed, mesh as mesh_lib
    mask = "110101011"                 # palindromic, span 9, k=6
    rng = np.random.default_rng(n_data * 10 + n_seq)
    B, L = 4 * n_data, 32 * n_seq
    seqs = ["".join(BASE_ORDER[c] for c in rng.integers(0, 4, L))
            for _ in range(B)]
    codes = np.stack([encode_seq(s) for s in seqs])
    lengths = np.full((B,), L, np.int32)
    limits = np.full((B,), L, np.int32)
    m = mesh_lib.make_mesh(n_data, n_seq)
    fn = distributed.make_distributed_count_pairs(
        m, k=6, canonical=True, seed_mask=mask)   # k overridden by mask
    pw, pc, over = fn(jnp.asarray(codes), jnp.asarray(lengths),
                      jnp.asarray(limits))
    assert not bool(over)
    got = KmerTable.from_routed_pairs(6, pw, pc)
    want = oracle.oracle_spaced_count(seqs, mask, canonical=True)
    assert got.to_dict() == dict(want)


def test_spaced_two_pass_streaming(tmp_path):
    """seed_mask through the two-pass spill driver == in-memory, with
    an interruption-resume in the middle."""
    from kmer_tpu.io.generator import genome_reads_fasta
    from kmer_tpu.pipeline.streaming import StreamingCounter
    p = tmp_path / "s2p.fasta"
    p.write_text(genome_reads_fasta(50, 120, genome_len=2500, seed=31))
    mask = "1101011"
    cfg = KmerConfig(seed_mask=mask, canonical=True, batch_reads=8,
                     max_read_len=64, sort_group_keys=64, partitions=4,
                     ingest_chunk_bases=1 << 12)
    want = count_fasta(str(p), cfg)
    sc = StreamingCounter(str(p), cfg, str(tmp_path / "sp"))
    sc.run_pass1(max_batches=2)        # interrupt + resume
    sc = StreamingCounter(str(p), cfg, str(tmp_path / "sp"))
    sc.run()
    assert sc.final_table() == want
    assert want.to_dict() == dict(oracle.oracle_spaced_count(
        oracle.read_fasta_py(str(p)), mask, canonical=True))


def test_spaced_multihost_single_process(tmp_path):
    """count_fasta_multihost with seed_mask (1-process degenerate form
    over the 8-device mesh) == the single-host pipeline."""
    import jax
    from kmer_tpu.io.generator import genome_reads_fasta
    from kmer_tpu.parallel.multihost import count_fasta_multihost
    if len(jax.devices()) < 2:
        pytest.skip("needs the multi-device CPU mesh")
    p = tmp_path / "smh.fasta"
    p.write_text(genome_reads_fasta(40, 90, genome_len=2000, seed=33))
    mask = "110101011"
    cfg = KmerConfig(seed_mask=mask, canonical=True, batch_reads=8,
                     max_read_len=96)
    got = count_fasta_multihost(str(p), cfg)
    assert got == count_fasta(str(p), cfg)
