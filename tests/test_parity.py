"""Reference-parity contract: byte-exact reproduction of the reference's
sorted gapped-chunk dump (main.rs:87-90), including the measured md5 of
sample.fasta output (BASELINE.md)."""

import hashlib
import os
import tempfile

import pytest

from kmer_tpu import KmerConfig, parity_dump, parity_md5, SAMPLE_FASTA_MD5
from kmer_tpu.io.generator import reference_style_fasta, random_reads_fasta
from kmer_tpu.utils import oracle


@pytest.fixture(scope="module")
def tmpdir():
    with tempfile.TemporaryDirectory() as d:
        yield d


def _write(tmpdir, text, name):
    p = os.path.join(tmpdir, name)
    with open(p, "w") as f:
        f.write(text)
    return p


def test_parity_dump_matches_oracle_small(tmpdir):
    text = reference_style_fasta(n_records=6, seed=2)
    p = _write(tmpdir, text, "small.fasta")
    got = parity_dump(p)
    want = oracle.oracle_gapped_sorted_dump(oracle.read_fasta_py(p))
    assert got == want


def test_parity_dump_multibatch_merge(tmpdir):
    # force multiple device batches; global merge must still be sorted
    text = reference_style_fasta(n_records=10, seed=4)
    p = _write(tmpdir, text, "multi.fasta")
    cfg = KmerConfig(gapped=True, batch_reads=3, max_read_len=512)
    got = parity_dump(p, cfg)
    want = oracle.oracle_gapped_sorted_dump(oracle.read_fasta_py(p))
    assert got == want


def test_parity_long_reads_segmented(tmpdir):
    # reads longer than max_read_len exercise gapped-mode seam ownership
    text = random_reads_fasta(3, 700, seed=6)
    p = _write(tmpdir, text, "long.fasta")
    cfg = KmerConfig(gapped=True, batch_reads=4, max_read_len=256)
    got = parity_dump(p, cfg)
    want = oracle.oracle_gapped_sorted_dump(oracle.read_fasta_py(p))
    assert got == want


def test_parity_variable_length_reads(tmpdir):
    texts = [">a\n" + "ACGT" * 30 + "\n",      # 120 bp
             ">b\n" + "TTGCA" * 16 + "\n",     # 80 bp, exactly c_min
             ">c\nACG\n",                       # shorter than everything
             ">d\n" + "GATTACA" * 20 + "\n"]   # 140 bp, exactly c_max
    p = _write(tmpdir, "".join(texts), "var.fasta")
    got = parity_dump(p)
    want = oracle.oracle_gapped_sorted_dump(oracle.read_fasta_py(p))
    assert got == want


def test_sample_fasta_md5(sample_fasta_path):
    """THE exactness contract (BASELINE.md): md5 of the sorted dump."""
    assert parity_md5(sample_fasta_path) == SAMPLE_FASTA_MD5


def test_sample_fasta_invariants(sample_fasta_path):
    dump = parity_dump(sample_fasta_path)
    lines = dump.split(b"\n")
    assert lines[-1] == b""          # single trailing newline
    lines = lines[:-1]
    assert len(lines) == 3_550_200   # BASELINE.md total chunks
    assert all(len(l) == 54 for l in lines[:100])
    assert len(set(lines)) == 1_079_497  # distinct chunks
    assert hashlib.md5(dump).hexdigest() == SAMPLE_FASTA_MD5


def test_parity_dump_stream_bounded(tmp_path):
    """Bounded-memory streaming parity (spill-partitioned line runs,
    one-partition-at-a-time sort) is byte-identical to the in-memory
    dump — md5-pinned on the reference corpus, with multi-chunk ingest
    and a partition count that forces many spill files."""
    import hashlib
    import io
    from kmer_tpu.config import KmerConfig
    from kmer_tpu.pipeline.parity import (SAMPLE_FASTA_MD5, parity_dump,
                                          parity_dump_stream)
    p = "tests/data/sample.fasta"
    cfg = KmerConfig(gapped=True, batch_reads=256, max_read_len=512,
                     ingest_chunk_bases=20000)
    buf = io.BytesIO()
    parity_dump_stream(p, buf, cfg, spill_dir=str(tmp_path / "sp"),
                       partitions=7)
    got = buf.getvalue()
    assert hashlib.md5(got).hexdigest() == SAMPLE_FASTA_MD5
    assert got == parity_dump(p, KmerConfig(gapped=True, batch_reads=256,
                                            max_read_len=512))


def test_parity_cli_bounded(tmp_path, capsysbinary):
    from kmer_tpu.cli import main
    from kmer_tpu.io.generator import reference_style_fasta
    fa = tmp_path / "r.fasta"
    fa.write_text(reference_style_fasta(n_records=3, seed=2))
    assert main(["parity", str(fa), "--batch-reads", "8"]) == 0
    want = capsysbinary.readouterr().out
    assert main(["parity", str(fa), "--bounded", "--partitions", "5",
                 "--batch-reads", "8"]) == 0
    assert capsysbinary.readouterr().out == want


def test_parity_multiset_path_identical(tmpdir, monkeypatch):
    """The pre-r4 direct device multiset sort (KMER_TPU_PARITY=multiset)
    stays byte-identical to the default count+expand path."""
    text = reference_style_fasta(n_records=8, seed=9)
    p = _write(tmpdir, text, "ms.fasta")
    cfg = KmerConfig(gapped=True, batch_reads=3, max_read_len=512)
    default = parity_dump(p, cfg)
    monkeypatch.setenv("KMER_TPU_PARITY", "multiset")
    multiset = parity_dump(p, cfg)
    assert default == multiset
    want = oracle.oracle_gapped_sorted_dump(oracle.read_fasta_py(p))
    assert default == want


def test_parity_compact_cfg_identical(tmpdir):
    """parity via the compacted gapped count ==
    non-compact == oracle."""
    text = reference_style_fasta(n_records=6, seed=11)
    p = _write(tmpdir, text, "pc.fasta")
    a = parity_dump(p, KmerConfig(gapped=True, batch_reads=4,
                                  max_read_len=512, compact=True))
    b = parity_dump(p, KmerConfig(gapped=True, batch_reads=4,
                                  max_read_len=512))
    want = oracle.oracle_gapped_sorted_dump(oracle.read_fasta_py(p))
    assert a == b == want


def test_parity_empty_input(tmpdir):
    p = _write(tmpdir, ">only_short\nACG\n", "empty.fasta")
    assert parity_dump(p) == b""
