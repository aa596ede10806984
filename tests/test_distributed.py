"""Multi-device tests on the 8-device virtual CPU mesh (conftest).

Determinism contract (SURVEY.md §5.2): the distributed merge must be
bit-identical to the single-device table for every mesh shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kmer_tpu import KmerTable
from kmer_tpu.ops.encode import encode_seq, BASE_ORDER
from kmer_tpu.parallel import distributed, halo, mesh as mesh_lib
from kmer_tpu.utils import oracle


def _corpus(rng, n, L):
    seqs = ["".join(BASE_ORDER[c] for c in rng.integers(0, 4, L)) for _ in range(n)]
    codes = np.zeros((n, L), np.uint8)
    for i, s in enumerate(seqs):
        codes[i] = encode_seq(s)
    lens = np.full((n,), L, np.int32)
    lims = np.full((n,), L, np.int32)
    return seqs, codes, lens, lims


def _table_from(k, out):
    s, is_start, counts, overflow = out
    assert not bool(overflow)
    return KmerTable.from_device_runs(k, s, is_start, counts)


@pytest.mark.parametrize("shape,canonical,k", [
    ((8, 1), False, 21),
    ((8, 1), True, 21),
    ((4, 2), False, 21),
    ((2, 4), True, 13),
    ((8, 1), False, 16),   # k=16: route bits straddle words
    ((1, 8), False, 9),    # pure sequence parallelism
])
def test_distributed_matches_oracle(shape, canonical, k):
    rng = np.random.default_rng(k * 10 + shape[0])
    B, L = 16, 64
    seqs, codes, lens, lims = _corpus(rng, B, L)
    m = mesh_lib.make_mesh(shape[0], shape[1])
    fn = distributed.make_distributed_count(m, k=k, canonical=canonical)
    out = fn(jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(lims))
    table = _table_from(k, out)
    want = oracle.oracle_count(seqs, k, canonical)
    assert table.to_dict() == dict(want)


def test_distributed_identical_across_mesh_shapes():
    """bit-identical tables for 1, 2, 4, 8 devices (determinism)."""
    rng = np.random.default_rng(0)
    B, L, k = 8, 96, 21
    seqs, codes, lens, lims = _corpus(rng, B, L)
    tables = []
    for n in (1, 2, 4, 8):
        m = mesh_lib.make_mesh(n, 1)
        fn = distributed.make_distributed_count(m, k=k)
        out = fn(jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(lims))
        tables.append(_table_from(k, out))
    for t in tables[1:]:
        assert t == tables[0]


def _table_from_pairs(k, out):
    words, counts, overflow = out
    assert not bool(overflow)
    return KmerTable.from_routed_pairs(k, words, counts)


@pytest.mark.parametrize("shape,canonical,k", [
    ((8, 1), False, 21),
    ((8, 1), True, 21),
    ((4, 2), True, 21),    # halo'd local extraction across seq shards
    ((2, 4), False, 13),
    ((1, 8), True, 11),    # pure sequence parallelism
])
def test_distributed_pairs_matches_oracle(shape, canonical, k):
    """Local-count pair routing (count_step_distributed_pairs): same
    tables as the oracle, incl. sequence-parallel halo'd extraction."""
    rng = np.random.default_rng(k * 7 + shape[0])
    B, L = 16, 64
    seqs, codes, lens, lims = _corpus(rng, B, L)
    m = mesh_lib.make_mesh(shape[0], shape[1])
    fn = distributed.make_distributed_count_pairs(m, k=k,
                                                  canonical=canonical)
    out = fn(jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(lims))
    table = _table_from_pairs(k, out)
    want = oracle.oracle_count(seqs, k, canonical)
    assert table.to_dict() == dict(want)


def test_distributed_pairs_identical_across_mesh_shapes():
    """The pairs path keeps the §5.2 determinism contract: integer
    aggregation is order-independent, so tables are bit-identical for
    every device count."""
    rng = np.random.default_rng(1)
    B, L, k = 8, 96, 21
    seqs, codes, lens, lims = _corpus(rng, B, L)
    tables = []
    for n in (1, 2, 4, 8):
        m = mesh_lib.make_mesh(n, 1)
        fn = distributed.make_distributed_count_pairs(m, k=k)
        out = fn(jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(lims))
        tables.append(_table_from_pairs(k, out))
    for t in tables[1:]:
        assert t == tables[0]
    fn1 = distributed.make_distributed_count(mesh_lib.make_mesh(8, 1), k=k)
    sorted_path = _table_from(k, fn1(jnp.asarray(codes), jnp.asarray(lens),
                                     jnp.asarray(lims)))
    assert tables[0] == sorted_path


def test_distributed_pairs_wide_key_fallback():
    """Wide keys (W = 3) through the pairs step: same table as the
    oracle and as the sorted-stream step, with and without sequence
    sharding."""
    rng = np.random.default_rng(2)
    B, L, k = 8, 80, 33
    seqs, codes, lens, lims = _corpus(rng, B, L)
    want = dict(oracle.oracle_count(seqs, k, True))
    args = (jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(lims))
    for shape in ((8, 1), (2, 2)):
        m = mesh_lib.make_mesh(*shape)
        fn = distributed.make_distributed_count_pairs(m, k=k, canonical=True)
        table = _table_from_pairs(k, fn(*args))
        assert table.to_dict() == want, shape
    sfn = distributed.make_distributed_count(mesh_lib.make_mesh(8, 1), k=k,
                                             canonical=True)
    assert _table_from(k, sfn(*args)) == table


def test_pairs_step_collapses_duplicates_locally():
    """The pairs step's local grouped count routes each distinct key of
    a sort slice once: on all-identical reads every device ships ~one
    pair per slice, far fewer than its lanes, with the exact counts."""
    reads = ["ACGTTGCA" * 8] * 16
    codes = np.stack([encode_seq(s) for s in reads])
    lens = np.full((16,), 64, np.int32)
    m = mesh_lib.make_mesh(8, 1)
    fn = distributed.make_distributed_count_pairs(m, k=5)
    words, counts, overflow = fn(jnp.asarray(codes), jnp.asarray(lens),
                                 jnp.asarray(lens))
    assert not bool(overflow)
    live = int((np.asarray(words[0]) != 0xFFFFFFFF).sum())
    n_lanes = 16 * (64 - 5 + 1)
    assert live < n_lanes // 10
    table = KmerTable.from_routed_pairs(5, words, counts)
    assert table.to_dict() == dict(oracle.oracle_count(reads, 5))


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_distributed_gapped_pairs_matches_oracle(shape):
    """Local-count gapped pair routing == gapped oracle, incl. the
    halo'd sequence-parallel case."""
    from collections import Counter
    rng = np.random.default_rng(shape[0])
    B, L = 16, 64
    gl, gr, c0, c1 = 4, 4, 10, 16
    seqs, codes, lens, lims = _corpus(rng, B, L)
    m = mesh_lib.make_mesh(shape[0], shape[1])
    fn = distributed.make_distributed_gapped_pairs(
        m, l_len=gl, r_len=gr, c_min=c0, c_max=c1)
    out = fn(jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(lims))
    table = _table_from_pairs(gl + gr, out)
    want = Counter(oracle.oracle_gapped_lines(seqs, l_len=gl, r_len=gr,
                                              c_min=c0, c_max=c1))
    assert table.to_dict() == dict(want)
    # bit-identity with the sorted-stream gapped path
    sfn = distributed.make_distributed_gapped(m, l_len=gl, r_len=gr,
                                              c_min=c0, c_max=c1)
    stab = _table_from(gl + gr, sfn(jnp.asarray(codes), jnp.asarray(lens),
                                    jnp.asarray(lims)))
    assert table == stab


def test_distributed_output_globally_sorted():
    rng = np.random.default_rng(3)
    B, L, k = 16, 64, 15
    seqs, codes, lens, lims = _corpus(rng, B, L)
    m = mesh_lib.make_mesh(8, 1)
    fn = distributed.make_distributed_count(m, k=k)
    s, is_start, counts, _ = fn(jnp.asarray(codes), jnp.asarray(lens),
                                jnp.asarray(lims))
    keys = np.asarray(s[0])
    real = keys[np.asarray(is_start) & (np.asarray(counts) > 0)]
    assert (np.diff(real.astype(np.int64)) > 0).all()  # strictly increasing


def test_distributed_overflow_flag():
    # capacity 1 with equal keys everywhere must overflow
    codes = np.zeros((8, 32), np.uint8)  # all-A reads -> one unique k-mer
    lens = np.full((8,), 32, np.int32)
    lims = np.full((8,), 32, np.int32)
    m = mesh_lib.make_mesh(8, 1)
    fn = distributed.make_distributed_count(m, k=5, capacity=1)
    *_, overflow = fn(jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(lims))
    assert bool(overflow)
    # the pairs step collapses equal keys locally before routing, so it
    # needs several DISTINCT keys per destination to overflow
    rng = np.random.default_rng(4)
    _, rcodes, _, _ = _corpus(rng, 8, 32)
    pfn = distributed.make_distributed_count_pairs(m, k=5, capacity=1)
    *_, poverflow = pfn(jnp.asarray(rcodes), jnp.asarray(lens),
                        jnp.asarray(lims))
    assert bool(poverflow)


def test_dense_distributed_psum_and_scatter():
    rng = np.random.default_rng(5)
    B, L, k = 16, 48, 6
    seqs, codes, lens, lims = _corpus(rng, B, L)
    want = oracle.oracle_count(seqs, k)
    m = mesh_lib.make_mesh(8, 1)

    fn = distributed.make_distributed_dense(m, k=k)
    hist = np.asarray(fn(jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(lims)))
    table = KmerTable.from_dense(hist, k)
    assert table.to_dict() == dict(want)

    fn2 = distributed.make_distributed_dense(m, k=k, scatter=True)
    hist2 = np.asarray(fn2(jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(lims)))
    np.testing.assert_array_equal(hist2, hist)


def test_halo_extend_ring():
    m = mesh_lib.make_mesh(1, 8)
    codes = np.arange(32, dtype=np.uint8).reshape(1, 32) % 4
    from jax.sharding import PartitionSpec as P

    def body(x):
        return halo.halo_extend(x, mesh_lib.SEQ_AXIS, 2)

    out = jax.jit(jax.shard_map(body, mesh=m,
                                in_specs=P(None, mesh_lib.SEQ_AXIS),
                                out_specs=P(None, mesh_lib.SEQ_AXIS)))(
        jnp.asarray(codes))
    out = np.asarray(out).reshape(8, 6)  # each shard: 4 own + 2 halo
    flat = codes.reshape(8, 4) % 4
    for s in range(7):
        np.testing.assert_array_equal(out[s, :4], flat[s])
        np.testing.assert_array_equal(out[s, 4:], flat[s + 1][:2])


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_distributed_gapped_matches_oracle(shape):
    """The reference's gapped L+R extraction scaled over the mesh
    (DP, and SP with a (c_max-1)-base halo)."""
    from collections import Counter
    rng = np.random.default_rng(7)
    B = 8
    # small gapped geometry so the test corpus stays tiny
    l_len = r_len = 5
    c_min, c_max = 12, 20
    L = 80 * shape[1]   # per-shard width >= c_max - 1
    seqs, codes, lens, lims = _corpus(rng, B, L)
    m = mesh_lib.make_mesh(shape[0], shape[1])
    fn = distributed.make_distributed_gapped(
        m, l_len=l_len, r_len=r_len, c_min=c_min, c_max=c_max)
    out = fn(jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(lims))
    table = _table_from(l_len + r_len, out)
    want = Counter(oracle.oracle_gapped_lines(
        seqs, l_len=l_len, r_len=r_len, c_min=c_min, c_max=c_max))
    assert table.to_dict() == dict(want)


def test_distributed_gapped_identical_across_meshes():
    from collections import Counter
    rng = np.random.default_rng(8)
    B, L = 8, 160
    seqs, codes, lens, lims = _corpus(rng, B, L)
    tables = []
    for shape in ((1, 1), (8, 1), (2, 2)):
        m = mesh_lib.make_mesh(shape[0], shape[1])
        fn = distributed.make_distributed_gapped(
            m, l_len=4, r_len=4, c_min=10, c_max=16)
        out = fn(jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(lims))
        tables.append(_table_from(8, out))
    for t in tables[1:]:
        assert t == tables[0]


def test_use_seq_false_on_seq_mesh_rejected():
    m = mesh_lib.make_mesh(4, 2)
    with pytest.raises(ValueError, match="use_seq"):
        distributed.make_distributed_count(m, k=5, use_seq=False)
    with pytest.raises(ValueError, match="use_seq"):
        distributed.make_distributed_gapped(m, l_len=4, r_len=4,
                                            c_min=10, c_max=12,
                                            use_seq=False)


def test_multi_hop_halo_narrow_shards():
    """halo > shard width: k-1 = 20 across 16-wide seq shards needs two
    ring hops; gapped c_max-1 = 19 across 8-wide shards needs three."""
    from collections import Counter
    rng = np.random.default_rng(9)
    B, L, k = 8, 128, 21
    seqs, codes, lens, lims = _corpus(rng, B, L)
    m = mesh_lib.make_mesh(1, 8)          # L_loc = 16 < k-1
    fn = distributed.make_distributed_count(m, k=k)
    out = fn(jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(lims))
    table = _table_from(k, out)
    assert table.to_dict() == dict(oracle.oracle_count(seqs, k))

    B2, L2 = 8, 64                         # L_loc = 8 < c_max-1 = 19
    seqs2, codes2, lens2, lims2 = _corpus(rng, B2, L2)
    gfn = distributed.make_distributed_gapped(m, l_len=4, r_len=4,
                                              c_min=10, c_max=20)
    out2 = gfn(jnp.asarray(codes2), jnp.asarray(lens2), jnp.asarray(lims2))
    t2 = _table_from(8, out2)
    want = Counter(oracle.oracle_gapped_lines(seqs2, l_len=4, r_len=4,
                                              c_min=10, c_max=20))
    assert t2.to_dict() == dict(want)


def test_default_capacity_even_share_not_ndev_inflated():
    """VERDICT r1 #3: the send buffer must be ~N_loc (even share x
    slack), not n_dev x N_loc.  The global output length exposes the
    per-device capacity: n_dev * (n_dev * cap)."""
    import jax
    B, L, k, n = 64, 128, 21, 8
    m = mesh_lib.make_mesh(n, 1)
    fn = distributed.make_distributed_count(m, k=k)
    codes = jnp.zeros((B, L), jnp.uint8)
    lens = jnp.full((B,), L, jnp.int32)
    shapes = jax.eval_shape(fn, codes, lens, lens)
    n_local = (B // n) * (L - k + 1)
    cap = distributed.route_capacity(n_local, n)
    assert shapes[0][0].shape[0] == n * n * cap
    # the old default would have been n * n * n_local — n_dev x larger
    assert n * n * cap < n * n * n_local


def test_skewed_corpus_streaming_overflow_retry(tmp_path, monkeypatch):
    """All-identical reads route every key to one destination — the
    even-share default capacity overflows and the streaming driver must
    retry with doubled capacity and still produce the exact table."""
    # pin the sorted-stream path: the retry machinery under test is
    # shared, but the pairs path's local dedup collapses this corpus's
    # skew below capacity (by design), so it would never overflow here
    monkeypatch.setenv("KMER_TPU_MULTIHOST_STEP", "legacy")
    from kmer_tpu import KmerConfig
    from kmer_tpu.pipeline.streaming import StreamingCounter
    reads = ["A" * 500] * 16              # every 9-mer routes to dest 0
    text = "".join(f">r{i}\n{s}\n" for i, s in enumerate(reads))
    p = tmp_path / "skew.fasta"
    p.write_text(text)
    cfg = KmerConfig(k=9, mode="sort", batch_reads=16, max_read_len=512,
                     partitions=4)
    m = mesh_lib.make_mesh(8, 1)
    # the skew MUST overflow the even-share default so the retry path
    # is really exercised
    n_local = (16 // 8) * (512 - 9 + 1)
    assert distributed.route_capacity(n_local, 8) < n_local
    sc = StreamingCounter(str(p), cfg, str(tmp_path / "sp"), mesh=m)
    sc.run()
    assert sc._dist_capacity is not None   # retry happened
    want = oracle.oracle_count(reads, 9)
    assert sc.final_table().to_dict() == dict(want)


def test_pairs_eligible_policy(monkeypatch, tmp_path):
    """Every key kind has a pairs body, so the drivers use it by
    default — here a k=101 (W=7) streaming run over the mesh, which
    the pairs step's first-accelerator kernel could not take;
    KMER_TPU_MULTIHOST_STEP=legacy selects the sorted-stream step."""
    from kmer_tpu import KmerConfig
    from kmer_tpu.pipeline.streaming import StreamingCounter
    monkeypatch.delenv("KMER_TPU_MULTIHOST_STEP", raising=False)
    assert distributed.pairs_eligible()
    rng = np.random.default_rng(6)
    seqs, _, _, _ = _corpus(rng, 8, 120)
    p = tmp_path / "w.fasta"
    p.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
    cfg = KmerConfig(k=101, canonical=True, batch_reads=8,
                     max_read_len=128, partitions=2)
    sc = StreamingCounter(str(p), cfg, str(tmp_path / "sp"),
                          mesh=mesh_lib.make_mesh(8, 1))
    assert sc._dist_pairs
    sc.run()
    assert sc.final_table().to_dict() == dict(
        oracle.oracle_count(seqs, 101, True))
    monkeypatch.setenv("KMER_TPU_MULTIHOST_STEP", "legacy")
    assert not distributed.pairs_eligible()
