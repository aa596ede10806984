import os
import subprocess
import sys
import tempfile

ENV = dict(os.environ, JAX_PLATFORMS="cpu")


def _run(*args, **kw):
    return subprocess.run([sys.executable, "-m", "kmer_tpu", *args],
                          capture_output=True, env=ENV, cwd=os.path.dirname(
                              os.path.dirname(os.path.abspath(__file__))), **kw)


def test_cli_generate_deterministic():
    a = _run("generate", "--seed", "7", "--n-records", "3")
    b = _run("generate", "--seed", "7", "--n-records", "3")
    assert a.returncode == 0
    assert a.stdout == b.stdout
    assert a.stdout.startswith(b">dummy_sequence_001 1th record\n")


def test_cli_count_and_parity_roundtrip():
    with tempfile.TemporaryDirectory() as d:
        fa = os.path.join(d, "g.fasta")
        gen = _run("generate", "--seed", "1", "--n-records", "4")
        with open(fa, "wb") as f:
            f.write(gen.stdout)

        r = _run("count", fa, "-k", "5", "--batch-reads", "8",
                 "--max-read-len", "512")
        assert r.returncode == 0, r.stderr.decode()
        lines = r.stdout.decode().strip().split("\n")
        assert all("\t" in l for l in lines)
        from kmer_tpu.utils.oracle import oracle_count, read_fasta_py
        want = oracle_count(read_fasta_py(fa), 5)
        got = {l.split("\t")[0]: int(l.split("\t")[1]) for l in lines}
        assert got == dict(want)

        p = _run("parity", fa, "--batch-reads", "8")
        assert p.returncode == 0, p.stderr.decode()
        from kmer_tpu.utils.oracle import oracle_gapped_sorted_dump
        assert p.stdout == oracle_gapped_sorted_dump(read_fasta_py(fa))


def test_count_multiple_files(tmp_path, capsys):
    from kmer_tpu.io.generator import random_reads_fasta, random_reads_fastq
    from kmer_tpu import cli
    p1 = tmp_path / "a.fasta"
    p1.write_text(random_reads_fasta(10, 40, seed=1))
    p2 = tmp_path / "b.fastq"
    p2.write_text(random_reads_fastq(10, 40, seed=2))
    rc = cli.main(["count", str(p1), str(p2), "-k", "7",
                   "--batch-reads", "8", "--max-read-len", "64"])
    assert rc == 0
    out = capsys.readouterr().out
    total = sum(int(line.split("\t")[1]) for line in out.splitlines())
    assert total == 20 * (40 - 7 + 1)


def test_two_pass_min_count_and_npz(tmp_path, capsys):
    from kmer_tpu.io.generator import reference_style_fasta
    from kmer_tpu import cli, KmerTable
    p = tmp_path / "a.fasta"
    p.write_text(reference_style_fasta(n_records=4, seed=3))
    npz = tmp_path / "t.npz"
    rc = cli.main(["count", str(p), "-k", "9", "--batch-reads", "8",
                   "--max-read-len", "512", "--two-pass",
                   "--spill-dir", str(tmp_path / "sp"),
                   "--min-count", "3", "--out-npz", str(npz)])
    assert rc == 0
    out = capsys.readouterr().out
    assert all(int(l.split("\t")[1]) >= 3 for l in out.splitlines())
    assert npz.exists()
    t = KmerTable.load(str(npz))
    assert all(c >= 3 for c in t.counts)


def test_max_count_filter(tmp_path, capsys):
    """--max-count (KMC -cx analog) drops repeat-saturated k-mers; the
    retained set equals the unfiltered table restricted to the range."""
    from kmer_tpu import cli
    from kmer_tpu.io.generator import reference_style_fasta
    p = tmp_path / "a.fasta"
    p.write_text(reference_style_fasta(n_records=4, seed=3))
    rc = cli.main(["count", str(p), "-k", "9", "--batch-reads", "8",
                   "--max-read-len", "512"])
    assert rc == 0
    full = {l.split("\t")[0]: int(l.split("\t")[1])
            for l in capsys.readouterr().out.splitlines()}
    rc = cli.main(["count", str(p), "-k", "9", "--batch-reads", "8",
                   "--max-read-len", "512", "--min-count", "2",
                   "--max-count", "5"])
    assert rc == 0
    got = {l.split("\t")[0]: int(l.split("\t")[1])
           for l in capsys.readouterr().out.splitlines()}
    want = {km: c for km, c in full.items() if 2 <= c <= 5}
    assert got == want and got  # non-degenerate


def test_get_canonical(tmp_path):
    from kmer_tpu import count_fasta, KmerConfig
    from kmer_tpu.io.generator import random_reads_fasta
    from kmer_tpu.ops.encode import revcomp_str
    p = tmp_path / "c.fasta"
    p.write_text(random_reads_fasta(10, 50, seed=4))
    t = count_fasta(str(p), KmerConfig(k=11, canonical=True, batch_reads=8,
                                       max_read_len=64))
    km = t.kmers()[0]
    rc = revcomp_str(km)
    assert t.get(km, canonical=True) == t.counts[0]
    assert t.get(rc, canonical=True) == t.counts[0]


def test_cli_query(tmp_path, capsys):
    from kmer_tpu.cli import main
    fa = tmp_path / "q.fasta"
    fa.write_text(">a\nAAACAAAC\n")
    npz = str(tmp_path / "t.npz")
    rc = main(["count", str(fa), "-k", "4", "--batch-reads", "2",
               "--max-read-len", "16", "--out-npz", npz])
    assert rc == 0
    capsys.readouterr()
    rc = main(["query", npz, "AAAC", "GGGG"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out == "AAAC\t2\nGGGG\t0\n"


def test_cli_gapped_count(tmp_path, capsys):
    from collections import Counter

    from kmer_tpu.cli import main
    from kmer_tpu.io.generator import reference_style_fasta
    from kmer_tpu.utils.oracle import oracle_gapped_lines, read_fasta_py
    fa = tmp_path / "gp.fasta"
    fa.write_text(reference_style_fasta(n_records=3, seed=11))
    rc = main(["count", str(fa), "--gapped", "--c-min", "60", "--c-max",
               "66", "--batch-reads", "8", "--max-read-len", "512"])
    out = capsys.readouterr().out
    assert rc == 0
    got = {l.split("\t")[0]: int(l.split("\t")[1])
           for l in out.strip().split("\n")}
    want = Counter(oracle_gapped_lines(read_fasta_py(str(fa)),
                                       c_min=60, c_max=66))
    assert got == dict(want)
    # --canonical contradicts gapped chunks: clean error
    rc = main(["count", str(fa), "--gapped", "--canonical"])
    assert rc == 1


def test_histo_full_config_surface(tmp_path, capsys):
    """histo shares count's config surface (VERDICT r3 #6): the
    spectrum of a quality-filtered FASTQ and of a spaced-seed key set,
    each vs the oracle."""
    from collections import Counter

    from kmer_tpu.cli import main
    from kmer_tpu.io.generator import genome_reads_fasta, random_reads_fastq
    from kmer_tpu.utils import oracle

    def spectrum(counter):
        return dict(Counter(counter.values()))

    # quality-filtered FASTQ spectrum
    fq = tmp_path / "q.fastq"
    fq.write_text(random_reads_fastq(12, 60, seed=5, qual_range=(5, 40)))
    rc = main(["histo", str(fq), "-k", "9", "--min-qual", "20",
               "--batch-reads", "8", "--max-read-len", "64"])
    assert rc == 0
    got = {int(a): int(b) for a, b in
           (ln.split("\t") for ln in capsys.readouterr().out.splitlines())}
    want = spectrum(oracle.oracle_count(
        oracle.read_fastq_py(str(fq), min_qual=20), 9, skip_invalid=True))
    assert got == want

    # spaced-seed spectrum (palindromic mask + canonical)
    fa = tmp_path / "g.fasta"
    fa.write_text(genome_reads_fasta(30, 100, genome_len=1500, seed=6))
    rc = main(["histo", str(fa), "--seed-mask", "110101011", "--canonical",
               "--batch-reads", "8", "--max-read-len", "128"])
    assert rc == 0
    got = {int(a): int(b) for a, b in
           (ln.split("\t") for ln in capsys.readouterr().out.splitlines())}
    want = spectrum(oracle.oracle_spaced_count(
        oracle.read_fasta_py(str(fa)), "110101011", canonical=True))
    assert got == want

    # gapped spectrum rides the same builder
    rc = main(["histo", str(fa), "--gapped", "--c-min", "60", "--c-max",
               "64", "--batch-reads", "8", "--max-read-len", "512"])
    assert rc == 0
    got = {int(a): int(b) for a, b in
           (ln.split("\t") for ln in capsys.readouterr().out.splitlines())}
    want = spectrum(Counter(oracle.oracle_gapped_lines(
        oracle.read_fasta_py(str(fa)), c_min=60, c_max=64)))
    assert got == want


def test_card_seed_mask_k_conflict(tmp_path):
    """card --seed-mask with explicit -k is a clean error (the spaced
    estimate would otherwise print mislabeled as k=<first>)."""
    from kmer_tpu.cli import main
    from kmer_tpu.io.generator import random_reads_fasta
    p = tmp_path / "c.fasta"
    p.write_text(random_reads_fasta(5, 40, seed=7))
    assert main(["card", str(p), "-k", "5", "-k", "7",
                 "--seed-mask", "101"]) == 1
