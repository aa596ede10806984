import os
import tempfile

import numpy as np
import pytest

from kmer_tpu import KmerConfig, KmerTable, count_fasta
from kmer_tpu.io.generator import random_reads_fasta, reference_style_fasta
from kmer_tpu.utils import oracle


def _write(tmpdir, text, name="x.fasta"):
    p = os.path.join(tmpdir, name)
    with open(p, "w") as f:
        f.write(text)
    return p


@pytest.fixture(scope="module")
def tmpdir():
    with tempfile.TemporaryDirectory() as d:
        yield d


@pytest.mark.parametrize("k,canonical,mode", [
    (4, False, "dense"), (4, True, "dense"),
    (8, False, "dense"),
    (21, False, "sort"), (21, True, "sort"),
    (31, False, "sort"),
])
def test_count_matches_oracle(tmpdir, k, canonical, mode):
    text = random_reads_fasta(40, 60, seed=k)
    path = _write(tmpdir, text, f"r{k}{canonical}.fasta")
    table = count_fasta(path, KmerConfig(k=k, canonical=canonical, mode=mode,
                                         batch_reads=16, max_read_len=64))
    want = oracle.oracle_count(oracle.read_fasta_py(path), k, canonical)
    assert table.to_dict() == dict(want)


def test_dense_and_sort_agree(tmpdir):
    path = _write(tmpdir, random_reads_fasta(30, 50, seed=5), "ds.fasta")
    t1 = count_fasta(path, KmerConfig(k=6, mode="dense", batch_reads=8, max_read_len=64))
    t2 = count_fasta(path, KmerConfig(k=6, mode="sort", batch_reads=8, max_read_len=64))
    assert t1 == t2


def test_multiplicity_reference_style(tmpdir):
    # pool-built corpus guarantees heavy duplication (generator parity)
    path = _write(tmpdir, reference_style_fasta(n_records=20, seed=1), "ref.fasta")
    table = count_fasta(path, KmerConfig(k=11, mode="sort", batch_reads=8,
                                         max_read_len=512))
    want = oracle.oracle_count(oracle.read_fasta_py(path), 11)
    assert table.to_dict() == dict(want)
    assert table.counts.max() > 1


def test_long_read_segmentation_exact(tmpdir):
    # reads much longer than max_read_len: segment overlap must not
    # duplicate or drop any window
    text = random_reads_fasta(3, 500, seed=9)
    path = _write(tmpdir, text, "long.fasta")
    table = count_fasta(path, KmerConfig(k=21, batch_reads=4, max_read_len=128))
    want = oracle.oracle_count(oracle.read_fasta_py(path), 21)
    assert table.to_dict() == dict(want)


def test_reads_shorter_than_k(tmpdir):
    path = _write(tmpdir, ">a\nACG\n>b\nACGTACGTAC\n", "short.fasta")
    table = count_fasta(path, KmerConfig(k=5, mode="sort", batch_reads=4,
                                         max_read_len=16))
    want = oracle.oracle_count(["ACG", "ACGTACGTAC"], 5)
    assert table.to_dict() == dict(want)


def test_empty_fasta(tmpdir):
    path = _write(tmpdir, "", "empty.fasta")
    table = count_fasta(path, KmerConfig(k=5, batch_reads=4, max_read_len=16))
    assert table.num_distinct == 0 and table.total == 0


def test_table_merge_associative():
    rng = np.random.default_rng(0)
    def rnd_table(n, seed):
        r = np.random.default_rng(seed)
        keys = np.sort(r.choice(1000, n, replace=False)).astype(np.uint32)[:, None]
        return KmerTable(7, keys, r.integers(1, 10, n).astype(np.int64))
    a, b, c = rnd_table(50, 1), rnd_table(60, 2), rnd_table(40, 3)
    t1 = a.merge(b).merge(c)
    t2 = a.merge(b.merge(c))
    assert t1 == t2
    # totals preserved
    assert t1.total == a.total + b.total + c.total


def test_table_tsv(tmpdir):
    import io as _io
    path = _write(tmpdir, ">a\nAAACAAAC\n", "tsv.fasta")
    table = count_fasta(path, KmerConfig(k=4, batch_reads=2, max_read_len=16))
    buf = _io.StringIO()
    table.write_tsv(buf)
    lines = buf.getvalue().strip().split("\n")
    assert lines[0].split("\t")[0] == "AAAC" and lines[0].split("\t")[1] == "2"
    # sorted lexicographically
    kmers = [l.split("\t")[0] for l in lines]
    assert kmers == sorted(kmers)


def test_sample_fasta_k21_exact(sample_fasta_path):
    """BASELINE.json config 1: k=21 (kmer, count) parity on the bundled
    corpus — the count-mode exactness contract."""
    table = count_fasta(sample_fasta_path,
                        KmerConfig(k=21, batch_reads=64, max_read_len=512))
    want = oracle.oracle_count(oracle.read_fasta_py(sample_fasta_path), 21)
    assert table.to_dict() == dict(want)
    # invariant: 200 records x 400 bp -> 200 * (400 - 21 + 1) total k-mers
    assert table.total == 200 * 380


def test_k31_canonical_reads(tmpdir):
    """BASELINE.json config 2 shape (downscaled for CI): k=31 canonical
    on 150 bp reads."""
    path = _write(tmpdir, random_reads_fasta(200, 150, seed=31), "k31.fasta")
    table = count_fasta(path, KmerConfig(k=31, canonical=True,
                                         batch_reads=64, max_read_len=150))
    want = oracle.oracle_count(oracle.read_fasta_py(path), 31, canonical=True)
    assert table.to_dict() == dict(want)


def test_multiplicity_histogram_and_top(tmpdir):
    path = _write(tmpdir, reference_style_fasta(n_records=5, seed=2),
                  "hist.fasta")
    table = count_fasta(path, KmerConfig(k=11, mode="sort", batch_reads=16,
                                         max_read_len=512))
    want = oracle.oracle_count(oracle.read_fasta_py(path), 11)
    from collections import Counter
    spect = Counter(want.values())
    assert table.multiplicity_histogram() == dict(spect)
    top = table.top(5)
    assert len(top) == 5
    counts = [c for _, c in top]
    assert counts == sorted(counts, reverse=True)
    assert all(want[km] == c for km, c in top)


def test_table_filter_get_save_load(tmpdir):
    path = _write(tmpdir, reference_style_fasta(n_records=4, seed=5),
                  "ops.fasta")
    table = count_fasta(path, KmerConfig(k=9, mode="sort", batch_reads=8,
                                         max_read_len=512))
    want = oracle.oracle_count(oracle.read_fasta_py(path), 9)
    # get
    some = next(iter(want))
    assert table.get(some) == want[some]
    assert table.get("A" * 9) == want.get("A" * 9, 0)
    with pytest.raises(ValueError):
        table.get("ACGT")
    # filter
    t2 = table.filter_min_count(3)
    assert t2.to_dict() == {k: v for k, v in want.items() if v >= 3}
    # save/load round trip
    p = os.path.join(tmpdir, "t.npz")
    table.save(p)
    assert KmerTable.load(p) == table


def test_count_fasta_gapped_mode(tmpdir):
    """cfg.gapped must flow through the flagship count path (it was
    silently ignored once): the table holds 54-base gapped chunks."""
    from collections import Counter
    path = _write(tmpdir, reference_style_fasta(n_records=3, seed=6),
                  "gap.fasta")
    cfg = KmerConfig(gapped=True, mode="sort", batch_reads=8,
                     max_read_len=512)
    table = count_fasta(path, cfg)
    want = Counter(oracle.oracle_gapped_lines(oracle.read_fasta_py(path)))
    assert table.k == 54
    assert table.to_dict() == dict(want)


def test_gapped_dense_rejected():
    with pytest.raises(ValueError, match="sort"):
        KmerConfig(gapped=True, mode="dense", k=8, max_read_len=512)


def test_dense_drain_int64_path(tmpdir):
    """Force drain_every=1 equivalent by tiny batch bound: results must
    be identical to the oracle even with multiple host drains."""
    path = _write(tmpdir, random_reads_fasta(30, 40, seed=10), "dd.fasta")
    cfg = KmerConfig(k=4, mode="dense", batch_reads=4, max_read_len=40)
    from kmer_tpu.pipeline import count as count_mod
    table = count_fasta(path, cfg)
    want = oracle.oracle_count(oracle.read_fasta_py(path), 4)
    assert table.to_dict() == dict(want)


@pytest.mark.parametrize("group_keys", [16, 64, 1024])
def test_grouped_sort_count_matches_oracle(tmpdir, group_keys):
    """Group-local sorting (device fast path) must yield the same table
    as the global sort after host aggregation."""
    path = _write(tmpdir, reference_style_fasta(n_records=5, seed=13),
                  f"grp{group_keys}.fasta")
    cfg = KmerConfig(k=15, mode="sort", batch_reads=16, max_read_len=512,
                     sort_group_keys=group_keys)
    table = count_fasta(path, cfg)
    want = oracle.oracle_count(oracle.read_fasta_py(path), 15)
    assert table.to_dict() == dict(want)
    # invariants of the aggregated table
    assert table.num_distinct == len(want)
    ref = count_fasta(path, cfg.replace(sort_group_keys=0))
    assert table == ref


def test_grouped_single_batch_aggregated(tmpdir):
    """One batch + grouping: duplicates across groups must still be
    merged into a sorted unique table."""
    path = _write(tmpdir, reference_style_fasta(n_records=2, seed=14),
                  "grp1b.fasta")
    cfg = KmerConfig(k=9, mode="sort", batch_reads=64, max_read_len=512,
                     sort_group_keys=8)
    table = count_fasta(path, cfg)
    want = oracle.oracle_count(oracle.read_fasta_py(path), 9)
    assert table.to_dict() == dict(want)
    import numpy as np
    v = table.keys.astype(np.uint64)
    flat = (v[:, 0] << np.uint64(32)) | v[:, 1] if v.shape[1] == 2 else v[:, 0]
    assert (np.diff(flat.astype(np.int64)) > 0).all()  # strictly sorted unique


@pytest.mark.parametrize("k", [33, 41, 63])
def test_large_k_multiword(tmpdir, k):
    """W=3..4-word keys (k > 32) through the full pipeline."""
    path = _write(tmpdir, random_reads_fasta(20, 80, seed=k), f"lk{k}.fasta")
    table = count_fasta(path, KmerConfig(k=k, canonical=(k == 41),
                                         batch_reads=8, max_read_len=80))
    want = oracle.oracle_count(oracle.read_fasta_py(path), k,
                               canonical=(k == 41))
    assert table.to_dict() == dict(want)


def test_gapped_grouped_sort(tmpdir):
    """Grouped sorting through the gapped counting path."""
    from collections import Counter
    path = _write(tmpdir, reference_style_fasta(n_records=3, seed=15),
                  "gg.fasta")
    for gk in (0, 64):
        cfg = KmerConfig(gapped=True, mode="sort", batch_reads=8,
                         max_read_len=512, sort_group_keys=gk)
        table = count_fasta(path, cfg)
        want = Counter(oracle.oracle_gapped_lines(oracle.read_fasta_py(path)))
        assert table.to_dict() == dict(want)


# ---------------------------------------------------------------------------
# Round 2: repacked 1-key grouped counting (ops/count.grouped_count)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [16, 21, 31, 32, 33, 54, 63])
def test_repack_unpack_roundtrip(k):
    """repack_words/unpack_words are exact inverses on valid lanes and
    map invalid lanes to all-SENTINEL."""
    import jax.numpy as jnp
    from kmer_tpu.ops.count import repack_words, unpack_words
    from kmer_tpu.ops.encode import words_per_key
    from kmer_tpu.ops.extract import SENTINEL
    W = words_per_key(k)
    s = 2 * k - 32 * (W - 1)
    rng = np.random.default_rng(k)
    n = 64
    valid = rng.random(n) < 0.8
    words = []
    for i in range(W):
        used = s if i == 0 else 32
        w = rng.integers(0, 1 << used, n, dtype=np.uint64).astype(np.uint32)
        words.append(np.where(valid, w, 0xFFFFFFFF).astype(np.uint32))
    jw = [jnp.asarray(w) for w in words]
    rw, nk = repack_words(jw, jnp.asarray(valid), k)
    assert nk == (W - 1 if W > 1 else 1)
    if nk == W:
        return  # identity layout (W == 1)
    # repacked words hold the same 2k bits, re-chunked
    big = np.zeros(n, dtype=object)
    for w in words:
        big = (big << 32) | w.astype(object)
    big_r = np.zeros(n, dtype=object)
    for i, w in enumerate(rw[:-1]):
        big_r = (big_r << 32) | np.asarray(w).astype(object)
    big_r = (big_r << s) | (np.asarray(rw[-1]).astype(object)
                            & ((1 << s) - 1))
    mask = (1 << (2 * k)) - 1
    assert all((bg & mask) == (br & mask)
               for bg, br, v in zip(big, big_r, valid) if v)
    # last repacked word is the validity channel
    assert (np.asarray(rw[-1])[~valid] == 0xFFFFFFFF).all()
    assert (np.asarray(rw[-1])[valid] < (1 << s)).all()
    back = unpack_words(rw, k)
    for orig, b in zip(words, back):
        assert (np.asarray(b) == orig).all()


@pytest.mark.parametrize("k", [16, 32])
def test_all_t_key_not_lost(tmpdir, k):
    """k with 2k % 32 == 0: the all-T key is bit-identical to the
    sentinel; the tail-run correction must still count it exactly
    (round-1 code silently dropped it)."""
    reads = ["T" * 40, "T" * 20 + "ACGT" * 10]
    text = "".join(f">r{i}\n{s}\n" for i, s in enumerate(reads))
    path = _write(tmpdir, text, f"polyt{k}.fasta")
    want = oracle.oracle_count(oracle.read_fasta_py(path), k)
    for gk in (0, 8, 512):
        table = count_fasta(path, KmerConfig(k=k, mode="sort",
                                             batch_reads=4, max_read_len=64,
                                             sort_group_keys=gk))
        assert table.to_dict() == dict(want), (k, gk)
        assert table.to_dict()["T" * k] == (41 - k) + max(21 - k, 0)


def test_grouped_padding_any_group_size(tmpdir):
    """group_keys that does not divide the key-stream size: the stream
    is sentinel-padded (grouped_count), results unchanged."""
    path = _write(tmpdir, random_reads_fasta(7, 53, seed=77), "pad.fasta")
    want = oracle.oracle_count(oracle.read_fasta_py(path), 21)
    for gk in (13, 100, 512, 4096):
        table = count_fasta(path, KmerConfig(k=21, batch_reads=8,
                                             max_read_len=64,
                                             sort_group_keys=gk))
        assert table.to_dict() == dict(want), gk


def test_tie_heavy_top_word(tmpdir):
    """Keys sharing their 32-bit sort prefix (poly-A runs): the 1-key
    comparator leaves ties unordered within a group — aggregation must
    still produce exact counts."""
    reads = ["A" * 60 + "C", "A" * 45 + "G" * 30, "A" * 64]
    text = "".join(f">r{i}\n{s}\n" for i, s in enumerate(reads))
    path = _write(tmpdir, text, "ties.fasta")
    for k in (21, 31):
        want = oracle.oracle_count(oracle.read_fasta_py(path), k)
        table = count_fasta(path, KmerConfig(k=k, batch_reads=4,
                                             max_read_len=80,
                                             sort_group_keys=16))
        assert table.to_dict() == dict(want), k


def test_packed_transfer_roundtrip():
    """Host packer (native + numpy fallback) and device unpack are
    inverses."""
    import jax.numpy as jnp
    from kmer_tpu.io.fasta import pack_batch_codes, iter_batches
    from kmer_tpu.ops.encode import unpack_codes_u32
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, (8, 50), dtype=np.uint8)
    packed = pack_batch_codes(codes)
    assert packed.shape == (8, 4) and packed.dtype == np.uint32
    back = np.asarray(unpack_codes_u32(jnp.asarray(packed), 50))
    assert (back == codes).all()
    # batcher parity: packed and unpacked batches describe the same rows
    flat = codes.reshape(-1)
    offsets = np.arange(0, flat.size + 1, 50, dtype=np.int64)
    b_u8 = list(iter_batches(flat, offsets, batch_reads=8, max_len=64,
                             overlap=20))[0]
    b_pk = list(iter_batches(flat, offsets, batch_reads=8, max_len=64,
                             overlap=20, packed=True))[0]
    assert b_pk.packed_width == 64
    unp = np.asarray(unpack_codes_u32(jnp.asarray(b_pk.codes), 64))
    assert (unp == b_u8.codes).all()
    assert (b_pk.lengths == b_u8.lengths).all()


def test_packed_vs_unpacked_table(tmpdir):
    """End-to-end: packed_transfer on/off produce identical tables."""
    path = _write(tmpdir, reference_style_fasta(n_records=4, seed=21),
                  "pk.fasta")
    a = count_fasta(path, KmerConfig(k=21, canonical=True, batch_reads=8,
                                     max_read_len=100, packed_transfer=True))
    b = count_fasta(path, KmerConfig(k=21, canonical=True, batch_reads=8,
                                     max_read_len=100, packed_transfer=False))
    assert a == b
    want = oracle.oracle_count(oracle.read_fasta_py(path), 21, canonical=True)
    assert a.to_dict() == dict(want)


@pytest.mark.parametrize("k", [9, 12])
def test_dense_hybrid_k9_12(tmpdir, k):
    """Explicit dense mode for k = 9..12 (hybrid: device sort-count +
    host dense accumulation) must equal sort mode and the oracle."""
    path = _write(tmpdir, random_reads_fasta(25, 48, seed=k), f"dh{k}.fasta")
    td = count_fasta(path, KmerConfig(k=k, mode="dense", batch_reads=8,
                                      max_read_len=48))
    ts = count_fasta(path, KmerConfig(k=k, mode="sort", batch_reads=8,
                                      max_read_len=48))
    want = oracle.oracle_count(oracle.read_fasta_py(path), k)
    assert td == ts
    assert td.to_dict() == dict(want)


@pytest.mark.parametrize("k", [9, 12])
def test_dense_scatter_k9_12(tmpdir, monkeypatch, k):
    """Dense k=9..12 on a SLOW link accumulates the 4^k table on
    device (scatter-add, zero per-batch D2H) — must equal the hybrid,
    sort mode, and the oracle."""
    path = _write(tmpdir, random_reads_fasta(25, 48, seed=k), f"ds{k}.fasta")
    cfg = KmerConfig(k=k, mode="dense", batch_reads=8, max_read_len=48)
    monkeypatch.setenv("KMER_TPU_DENSE_SCATTER", "1")
    t_scat = count_fasta(path, cfg)
    monkeypatch.setenv("KMER_TPU_DENSE_SCATTER", "0")
    t_hyb = count_fasta(path, cfg)
    want = oracle.oracle_count(oracle.read_fasta_py(path), k)
    assert t_scat == t_hyb
    assert t_scat.to_dict() == dict(want)
    # canonical through the scatter path too
    monkeypatch.setenv("KMER_TPU_DENSE_SCATTER", "1")
    c_scat = count_fasta(path, cfg.replace(canonical=True))
    cw = oracle.oracle_count(oracle.read_fasta_py(path), k, canonical=True)
    assert c_scat.to_dict() == dict(cw)


@pytest.mark.parametrize("k", [11, 16, 21, 31])
def test_compact_mode_matches(tmpdir, k):
    """On-device compaction (device returns only distinct records) must
    yield the identical table on a duplicate-heavy corpus."""
    path = _write(tmpdir, reference_style_fasta(n_records=6, seed=k),
                  f"cp{k}.fasta")
    base = KmerConfig(k=k, mode="sort", batch_reads=8, max_read_len=512,
                      canonical=(k == 21))
    want = count_fasta(path, base)
    got = count_fasta(path, base.replace(compact=True))
    assert got == want
    assert got.counts.max() > 1            # the corpus really has dups


@pytest.mark.parametrize("k", [11, 21])
def test_compact_mode_small_groups(tmpdir, k):
    """Compaction over 16-key sort groups (many partial runs per
    partition) must yield the table of the uncompacted default."""
    path = _write(tmpdir, reference_style_fasta(n_records=6, seed=k + 1),
                  f"cpf{k}.fasta")
    base = KmerConfig(k=k, mode="sort", batch_reads=8, max_read_len=512,
                      canonical=(k == 21))
    want = count_fasta(path, base)
    got = count_fasta(path, base.replace(compact=True, sort_group_keys=16))
    assert got == want
    assert got.counts.max() > 1


@pytest.mark.parametrize("k", [33, 47])
def test_compact_mode_large_k(tmpdir, k):
    """Compaction with W=3 keys (k > 31): same 4-field records, count in
    the fourth slot."""
    path = _write(tmpdir, reference_style_fasta(n_records=6, seed=k),
                  f"cpl{k}.fasta")
    base = KmerConfig(k=k, mode="sort", batch_reads=8, max_read_len=512)
    want = count_fasta(path, base)
    got = count_fasta(path, base.replace(compact=True))
    assert got == want
    assert got.counts.max() > 1


def test_compact_mode_gapped(tmpdir):
    """Gapped compaction (W=4 chunk keys -> 8-field records) must equal
    the uncompacted gapped table and the reference-semantics oracle."""
    path = _write(tmpdir, reference_style_fasta(n_records=4, seed=7),
                  "cpg.fasta")
    base = KmerConfig(gapped=True, c_min=56, c_max=64, batch_reads=8,
                      max_read_len=512)
    want = count_fasta(path, base)
    got = count_fasta(path, base.replace(compact=True))
    assert got == want
    assert got.counts.max() > 1
    from collections import Counter
    from kmer_tpu.utils import oracle
    wo = Counter(oracle.oracle_gapped_lines(
        oracle.read_fasta_py(path), c_min=56, c_max=64))
    assert got.to_dict() == dict(wo)


def test_compact_config_validation():
    # large-k and gapped compact are supported (8-field records)
    KmerConfig(k=33, compact=True)
    KmerConfig(gapped=True, compact=True, max_read_len=512)
    with pytest.raises(ValueError, match="key words"):
        KmerConfig(k=120, compact=True)
    with pytest.raises(ValueError, match="sort"):
        KmerConfig(k=8, mode="dense", compact=True)


def test_very_wide_keys_k101(tmp_path):
    """k=101 (W=7 words): the general XLA path has no key-width cap —
    exact vs the string oracle, canonical, with a compact variant
    (records cap at 7 key words = 111 bases)."""
    from kmer_tpu import KmerConfig, count_fasta
    from kmer_tpu.io.generator import genome_reads_fasta
    from kmer_tpu.utils import oracle
    p = tmp_path / "wide.fasta"
    p.write_text(genome_reads_fasta(20, 150, genome_len=2000, seed=41))
    cfg = KmerConfig(k=101, canonical=True, batch_reads=8,
                     max_read_len=128, sort_group_keys=64)
    got = count_fasta(str(p), cfg)
    want = oracle.oracle_count(oracle.read_fasta_py(str(p)), 101,
                               canonical=True)
    assert got.to_dict() == dict(want)
    assert count_fasta(str(p), cfg.replace(compact=True)) == got


def test_auto_mode_link_aware(monkeypatch):
    """auto routes k<=8 to dense only when the D2H link is slower than
    the breakeven: dense's device-resident table trades per-key device
    time for O(4^k)-once readback, which only pays on slow links."""
    cfg = KmerConfig(k=8)
    monkeypatch.setenv("KMER_TPU_D2H_GBPS", "0.15")   # slow link
    assert cfg.effective_mode == "dense"
    monkeypatch.setenv("KMER_TPU_D2H_GBPS", "50")     # PCIe host
    assert cfg.effective_mode == "sort"
    assert KmerConfig(k=9).effective_mode == "sort"   # never dense
    monkeypatch.delenv("KMER_TPU_D2H_GBPS")
    # CPU backend (this suite): "D2H" is a host memcpy -> never slow
    assert cfg.effective_mode == "sort"
    # explicit modes are untouched by the probe
    assert KmerConfig(k=8, mode="dense").effective_mode == "dense"


def test_gapped_device_len_keeps_wide_rows():
    """Without an override, gapped batches keep the user's row width at
    any size (the XLA gapped step needs no re-tiling)."""
    from kmer_tpu.pipeline.count import gapped_device_len
    for w in (140, 300, 512, 4096):
        assert gapped_device_len(KmerConfig(gapped=True,
                                            max_read_len=w)) == w


def test_gapped_mesh_device_len_default():
    """The mesh width is cfg.max_read_len for every seq-axis size
    without an override (the drivers then check n_seq divisibility)."""
    from kmer_tpu.pipeline.count import (gapped_device_len,
                                         gapped_mesh_device_len)
    cfg = KmerConfig(gapped=True, max_read_len=512)
    for n_seq in (1, 2, 4):
        assert gapped_mesh_device_len(cfg, n_seq) == 512
    assert gapped_mesh_device_len(cfg, 1) == gapped_device_len(cfg)


def test_gapped_device_len_policy(monkeypatch):
    """gapped_device_len keeps the user's width;
    KMER_TPU_GAPPED_MAXLEN overrides and is floored at the window
    span."""
    from kmer_tpu.pipeline.count import gapped_device_len
    cfg = KmerConfig(gapped=True, max_read_len=512)
    assert gapped_device_len(cfg) == 512          # as-is
    monkeypatch.setenv("KMER_TPU_GAPPED_MAXLEN", "200")
    assert gapped_device_len(cfg) == 200
    monkeypatch.setenv("KMER_TPU_GAPPED_MAXLEN", "50")
    assert gapped_device_len(cfg) == cfg.window_span   # floored


def test_gapped_retile_width_bit_identity(tmpdir, monkeypatch):
    """Forcing a narrower gapped device width (KMER_TPU_GAPPED_MAXLEN)
    must be bit-identical
    to the full-width run — across count_fasta, the streaming counter,
    and the single-process multihost driver (the overlap seams make
    extraction exact at any tiling)."""
    from collections import Counter
    from kmer_tpu.pipeline.streaming import StreamingCounter
    from kmer_tpu.parallel.multihost import count_fasta_multihost
    path = _write(tmpdir, random_reads_fasta(6, 300, seed=77), "rt.fasta")
    cfg = KmerConfig(gapped=True, c_min=60, c_max=80, l_len=13, r_len=11,
                     batch_reads=8, max_read_len=300, partitions=3)
    want = Counter(oracle.oracle_gapped_lines(
        oracle.read_fasta_py(path), l_len=13, r_len=11, c_min=60, c_max=80))
    full = count_fasta(path, cfg)
    assert full.to_dict() == dict(want)
    monkeypatch.setenv("KMER_TPU_GAPPED_MAXLEN", "120")
    assert count_fasta(path, cfg) == full
    sc = StreamingCounter(path, cfg, os.path.join(tmpdir, "rt_sp"))
    sc.run()
    assert sc.final_table() == full
    assert count_fasta_multihost(path, cfg) == full


def test_gapped_mesh_device_len_rounding(monkeypatch):
    """KMER_TPU_GAPPED_MAXLEN with n_seq > 1 must round UP to a
    multiple of n_seq at or above the window span — rounding down
    yields max_len <= overlap and a segmenter assertion (review r4
    repro: env=142, c_max=140, n_seq=8 returned 136 < span 140)."""
    from kmer_tpu.pipeline.count import gapped_mesh_device_len
    cfg = KmerConfig(gapped=True, max_read_len=512)     # span 140
    monkeypatch.setenv("KMER_TPU_GAPPED_MAXLEN", "142")
    w = gapped_mesh_device_len(cfg, 8)
    assert w % 8 == 0 and w >= cfg.window_span
    assert w == 144
    # n_seq=1 keeps the exact override
    assert gapped_mesh_device_len(cfg, 1) == 142


def test_gapped_mesh_streaming_retile_bit_identity(tmpdir, monkeypatch):
    """Mesh-attached StreamingCounter (seq > 1) with a forced narrower
    device width == the full-width run (n_seq>1 branch of
    gapped_mesh_device_len; the halo'd per-shard extraction must stay
    exact at any tiling)."""
    from kmer_tpu.parallel import mesh as mesh_lib
    from kmer_tpu.pipeline.streaming import StreamingCounter
    path = _write(tmpdir, random_reads_fasta(8, 280, seed=21), "ms.fasta")
    cfg = KmerConfig(gapped=True, c_min=40, c_max=48, l_len=9, r_len=9,
                     batch_reads=8, max_read_len=280, partitions=3)
    m = mesh_lib.make_mesh(4, 2)
    sc = StreamingCounter(path, cfg, os.path.join(tmpdir, "msp_full"),
                          mesh=m)
    sc.run()
    full = sc.final_table()
    from collections import Counter
    want = Counter(oracle.oracle_gapped_lines(
        oracle.read_fasta_py(path), l_len=9, r_len=9, c_min=40, c_max=48))
    assert full.to_dict() == dict(want)
    monkeypatch.setenv("KMER_TPU_GAPPED_MAXLEN", "100")
    sc2 = StreamingCounter(path, cfg, os.path.join(tmpdir, "msp_narrow"),
                           mesh=m)
    sc2.run()
    assert sc2.final_table() == full


def test_tight_width_bit_identity(tmpdir, monkeypatch):
    """Tight device row width (r5: rows narrow to the chunk's longest
    record) is bit-identical to fixed cfg.max_read_len rows — contiguous,
    gapped, spaced, and reads longer than the narrow width still split
    exactly at the overlap seams."""
    reads = random_reads_fasta(9, 100, seed=21) + random_reads_fasta(
        4, 37, seed=22) + random_reads_fasta(2, 300, seed=23)
    path = _write(tmpdir, reads, "tw.fasta")
    for cfg in (
        KmerConfig(k=21, canonical=True, batch_reads=8, max_read_len=512),
        KmerConfig(gapped=True, c_min=30, c_max=40, l_len=9, r_len=7,
                   batch_reads=8, max_read_len=512),
        KmerConfig(seed_mask="1101011", batch_reads=8, max_read_len=512),
    ):
        monkeypatch.setenv("KMER_TPU_TIGHT_WIDTH", "0")
        ref = count_fasta(path, cfg)
        monkeypatch.setenv("KMER_TPU_TIGHT_WIDTH", "1")
        got = count_fasta(path, cfg)
        assert got == ref
        assert (got.keys == ref.keys).all()
        assert (got.counts == ref.counts).all()
