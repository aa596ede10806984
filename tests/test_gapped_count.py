"""The gapped L+R chunk steps (pipeline.count.gapped_step_sort /
gapped_step_compact) against the reference-semantics oracle: short
reads, ownership limits, ambiguity masks, chunk ranges partly wider
than the rows, and W = 2 and W = 4 keys."""

from collections import Counter

import numpy as np
import pytest

import jax.numpy as jnp

from kmer_tpu import KmerConfig, count_fasta
from kmer_tpu.ops.encode import BASE_ORDER
from kmer_tpu.pipeline.count import (fetch_compact_rows, gapped_step_compact,
                                     gapped_step_sort)
from kmer_tpu.pipeline.table import KmerTable
from kmer_tpu.utils import oracle

_GEOMS = [
    (5, 5, 12, 20, 40, False),      # W=2 keys, c range partly > L
    (5, 3, 10, 14, 32, True),       # asymmetric windows + ambiguity
    (27, 27, 54, 60, 80, False),    # reference window shape, W=4 keys
]


def _batch(llen, rlen, cmin, L, amb):
    rng = np.random.default_rng(llen * 100 + cmin + amb)
    B = 10
    codes = rng.integers(0, 5 if amb else 4, (B, L), dtype=np.uint8)
    lengths = rng.integers(0, L + 1, B, dtype=np.int32)
    limits = rng.integers(1, L + 1, B, dtype=np.int32)
    return codes, lengths, limits


def _oracle_table(codes, lengths, limits, llen, rlen, cmin, cmax):
    """Gapped oracle over each row's owned window starts (o < limit)."""
    want: Counter = Counter()
    for row, n, lim in zip(codes, lengths, limits):
        seq = "".join((BASE_ORDER + "N")[c] for c in row[:n])
        for c in range(cmin, cmax + 1):
            for o in range(min(int(lim), n - c + 1)):
                chunk = seq[o:o + llen] + seq[o + c - rlen:o + c]
                if "N" not in chunk:
                    want[chunk] += 1
    return dict(want)


@pytest.mark.parametrize("step", ["sort", "compact"])
@pytest.mark.parametrize("llen,rlen,cmin,cmax,L,amb", _GEOMS)
def test_gapped_steps_match_oracle(llen, rlen, cmin, cmax, L, amb, step):
    codes, lengths, limits = _batch(llen, rlen, cmin, L, amb)
    nb = llen + rlen
    kw = dict(l_len=llen, r_len=rlen, c_min=cmin, c_max=cmax,
              mask_ambiguous=amb)
    args = (jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(limits))
    if step == "sort":
        s, is_start, counts = gapped_step_sort(*args, group_keys=64, **kw)
        ks = np.stack([np.asarray(w) for w in s], 1)
        c = np.asarray(counts)
        sel = np.asarray(is_start) & (c > 0)
        got = KmerTable.from_pairs(nb, ks[sel], c[sel])
    else:
        rows, total = gapped_step_compact(*args, group_keys=64,
                                          part_keys=256, **kw)
        got = KmerTable.from_compact(nb, fetch_compact_rows(rows, total))
    assert got.to_dict() == _oracle_table(codes, lengths, limits, llen,
                                          rlen, cmin, cmax)


@pytest.mark.parametrize("llen,rlen,cmin,cmax,L,amb", _GEOMS)
def test_gapped_grouped_bit_equals_flat(llen, rlen, cmin, cmax, L, amb):
    """The grouped gapped step == the exact flat multiset sort
    (group_keys=0), whose runs are globally sorted."""
    codes, lengths, limits = _batch(llen, rlen, cmin, L, amb)
    nb = llen + rlen
    kw = dict(l_len=llen, r_len=rlen, c_min=cmin, c_max=cmax,
              mask_ambiguous=amb)
    args = (jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(limits))
    s, is_start, counts = gapped_step_sort(*args, group_keys=32, **kw)
    ks = np.stack([np.asarray(w) for w in s], 1)
    c = np.asarray(counts)
    sel = np.asarray(is_start) & (c > 0)
    grouped = KmerTable.from_pairs(nb, ks[sel], c[sel])
    flat = KmerTable.from_device_runs(nb, *gapped_step_sort(
        *args, group_keys=0, **kw))
    assert grouped == flat


def test_gapped_count_fasta_end_to_end(tmp_path):
    """count_fasta in gapped mode (reference windows, 64-key groups)
    == the gapped oracle."""
    from kmer_tpu.io.generator import reference_style_fasta
    p = tmp_path / "gf.fasta"
    p.write_text(reference_style_fasta(n_records=3, seed=77))
    t = count_fasta(str(p), KmerConfig(gapped=True, mode="sort",
                                       batch_reads=8, max_read_len=512,
                                       sort_group_keys=64))
    want = Counter(oracle.oracle_gapped_lines(oracle.read_fasta_py(str(p))))
    assert t.to_dict() == dict(want)


def test_gapped_compact_end_to_end(tmp_path):
    """Gapped on-device compaction through count_fasta == the
    uncompacted table."""
    from kmer_tpu.io.generator import reference_style_fasta
    p = tmp_path / "gfc.fasta"
    p.write_text(reference_style_fasta(n_records=3, seed=78))
    base = KmerConfig(gapped=True, c_min=56, c_max=64, batch_reads=8,
                      max_read_len=512)
    want = count_fasta(str(p), base)
    assert count_fasta(str(p), base.replace(compact=True)) == want
    assert count_fasta(str(p), base.replace(sort_group_keys=0)) == want
