"""Host-side k-mer count table: sorted multi-word keys + counts.

Device steps emit static-shape (sorted keys, run starts, run counts);
this module compacts and merges them.  Multi-word lexicographic order on
the host uses a big-endian byte view (np.void compare == bytewise ==
word-tuple lexicographic), so merging N sorted batch tables is a
vectorized searchsorted merge, not a Python loop.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..ops.encode import decode_key_words, words_per_key


def _void_view(keys: np.ndarray) -> np.ndarray:
    """(M, W) uint32 -> (M,) void{4W} big-endian — lexicographic-safe."""
    be = np.ascontiguousarray(keys.astype(">u4"))
    return be.view(np.dtype((np.void, be.shape[1] * 4))).reshape(-1)


def _unfuse_ms(cols_ms: list[np.ndarray], W: int) -> np.ndarray:
    """Split 1-2 fused uint64 columns (MOST-significant first, the
    native aggregator's output layout) back into (M, W) uint32 std key
    words — the inverse of from_pairs' fusing."""
    M = len(cols_ms[0])
    if W == 1:
        return cols_ms[0].astype(np.uint32).reshape(-1, 1)
    if W == 2:
        if sys.byteorder == "little":
            # same rotate + reinterpret as the numpy path: one
            # contiguous pass instead of two strided column stores
            rot = ((cols_ms[0] >> np.uint64(32))
                   | (cols_ms[0] << np.uint64(32)))
            return np.ascontiguousarray(rot.view(np.uint32).reshape(-1, 2))
        kb = np.empty((M, 2), np.uint32)
        kb[:, 0] = cols_ms[0] >> np.uint64(32)
        kb[:, 1] = cols_ms[0].astype(np.uint32)
        return kb
    kb = np.empty((M, W), np.uint32)
    if W == 3:           # cols = [w0, w1:w2]
        kb[:, 0] = cols_ms[0].astype(np.uint32)
        kb[:, 1] = cols_ms[1] >> np.uint64(32)
        kb[:, 2] = cols_ms[1].astype(np.uint32)
    else:                # W == 4: cols = [w0:w1, w2:w3]
        kb[:, 0] = cols_ms[0] >> np.uint64(32)
        kb[:, 1] = cols_ms[0].astype(np.uint32)
        kb[:, 2] = cols_ms[1] >> np.uint64(32)
        kb[:, 3] = cols_ms[1].astype(np.uint32)
    return kb


def _unpack_repacked_np(rw: list[np.ndarray], n_bases: int) -> list[np.ndarray]:
    """Host mirror of ops.count.unpack_words for LIVE lanes only:
    repacked sort-layout words (32 key bits per word 0..W-2, the s
    residual bits in the last word) back to std MS-first layout."""
    W = len(rw)
    if W == 1:
        return rw
    s = 2 * n_bases - 32 * (W - 1)
    if s == 0:
        # last word is the 0-flag on live lanes; std w0 holds only it
        return [rw[-1]] + list(rw[:-1])
    t = np.uint32(32 - s)
    s = np.uint32(s)
    out = [rw[0] >> t]
    for j in range(1, W - 1):
        out.append((rw[j - 1] << s) | (rw[j] >> t))
    out.append((rw[W - 2] << s) | rw[W - 1])
    return out


@dataclass
class KmerTable:
    k: int                 # bases per key
    keys: np.ndarray       # (M, W) uint32, lexicographically sorted, unique
    counts: np.ndarray     # (M,) int64

    @property
    def num_distinct(self) -> int:
        return int(self.keys.shape[0])

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    def kmers(self) -> list[str]:
        return decode_key_words(self.keys, self.k)

    def items(self):
        return zip(self.kmers(), self.counts.tolist())

    def to_dict(self) -> dict[str, int]:
        return dict(self.items())

    def write_tsv(self, stream, chunk: int = 1 << 20) -> None:
        """Vectorized TSV dump (a per-row Python loop costs minutes on
        100M-distinct tables); works on text or binary streams.  Large
        chunks render natively (one MT pass, pipeline/nativeagg
        format_tsv_rows) — numpy's per-row %d printf is the fallback."""
        from ..ops.encode import decode_key_words_to_bytes
        from .nativeagg import format_tsv_rows
        binary = not hasattr(stream, "encoding")
        for lo in range(0, self.num_distinct, chunk):
            hi = min(lo + chunk, self.num_distinct)
            lines = format_tsv_rows(self.keys[lo:hi], self.counts[lo:hi],
                                    self.k)
            if lines is None:
                kmers = decode_key_words_to_bytes(self.keys[lo:hi], self.k)
                counts = np.char.mod(b"%d", self.counts[lo:hi])
                lines = (np.char.add(np.char.add(kmers, b"\t"),
                                     np.char.add(counts, b"\n"))
                         .tobytes())
                # |S columns are padded with NULs; strip them
                lines = lines.replace(b"\x00", b"")
            stream.write(lines if binary else lines.decode())

    @staticmethod
    def empty(k: int) -> "KmerTable":
        return KmerTable(k, np.zeros((0, words_per_key(k)), np.uint32),
                         np.zeros((0,), np.int64))

    @staticmethod
    def from_dense(hist: np.ndarray, k: int) -> "KmerTable":
        """Dense 4^k histogram -> sparse sorted table."""
        nz = np.flatnonzero(hist)
        W = words_per_key(k)
        keys = np.zeros((nz.size, W), np.uint32)
        keys[:, W - 1] = nz.astype(np.uint32)
        return KmerTable(k, keys, hist[nz].astype(np.int64))

    @staticmethod
    def from_device_runs(k: int, sorted_words, is_start, counts) -> "KmerTable":
        """Compact one device count step's static-shape outputs.

        sorted_words: tuple/list of W (N,) uint32 (host numpy or jax);
        is_start/counts per ops.count.run_lengths.  Sentinel runs
        (count 0) are dropped here.
        """
        is_start = np.asarray(is_start)
        counts = np.asarray(counts)
        starts = np.flatnonzero(is_start & (counts > 0))
        keys = np.stack([np.asarray(w)[starts] for w in sorted_words], axis=1)
        return KmerTable(k, keys.astype(np.uint32),
                         counts[starts].astype(np.int64))

    @staticmethod
    def from_compact(n_bases: int, row_blocks: np.ndarray) -> "KmerTable":
        """Decode one batch's ON-DEVICE-COMPACTED row blocks
        (ops/count.grouped_count_compact): (R, 128) uint32 rows of
        fixed-width records (repacked key words, count, zero padding —
        ops/count.record_width fields each); dead padding
        records carry count == 0 and are dropped; converts back to std
        key words and aggregates."""
        from ..ops.count import record_width
        W = words_per_key(n_bases)
        rec_w = record_width(W + 1)
        rows = np.asarray(row_blocks).reshape(-1, rec_w)
        rows = rows[rows[:, W] > 0]
        counts = rows[:, W].astype(np.int64)
        rw = [rows[:, j] for j in range(W)]
        keys = np.stack(_unpack_repacked_np(rw, n_bases), axis=1)
        return KmerTable.from_pairs(n_bases, keys, counts)

    @staticmethod
    def from_pairs(k: int, keys: np.ndarray, counts: np.ndarray) -> "KmerTable":
        """Aggregate unsorted (key, count) pairs into a sorted unique
        table — one vectorized sort + run-sum (no Python loop).

        Word columns are FUSED into uint64 halves first: np.argsort on
        one u64 column is ~10x np.lexsort over two u32 columns at 12 M
        rows (lexsort makes one stable mergesort pass per column;
        aggregation doesn't need stability — equal keys are identical
        rows), and W > 2 keys lexsort ceil(W/2) fused columns instead
        of W."""
        W = words_per_key(k)
        keys = np.asarray(keys, dtype=np.uint32)
        if keys.ndim == 2 and keys.shape[0] and keys.shape[1] != W:
            # a silent reshape would merge/split adjacent keys — this is
            # always a caller passing the wrong n_bases
            raise ValueError(f"key width {keys.shape[1]} != {W} words "
                             f"for {k} bases")
        keys = keys.reshape(-1, W)
        counts = np.asarray(counts, dtype=np.int64)
        if len(counts) == 0:
            return KmerTable.empty(k)
        fused = []
        if W == 2 and sys.byteorder == "little":
            # contiguous u64 view + 32-bit rotate beats two strided
            # column reads + shift + or (one pass over one buffer);
            # LE only: the view reads (w0 | w1<<32), the rotate makes
            # it (w0<<32 | w1)
            v = np.ascontiguousarray(keys).view(np.uint64).reshape(-1)
            fused.append((v >> np.uint64(32)) | (v << np.uint64(32)))
        else:
            for j in range(W - 2, -1, -2):       # pairs, LS first
                fused.append((keys[:, j].astype(np.uint64)
                              << np.uint64(32)) | keys[:, j + 1])
        if W % 2:
            fused.append(keys[:, 0].astype(np.uint64))
        if len(fused) <= 2:
            # large batches: bucket-parallel native sort-reduce
            # (pipeline/nativeagg.py); None -> numpy below.  Covers
            # every supported k (<= 63 -> <= 2 fused columns).
            from .nativeagg import aggregate_fused
            nat = aggregate_fused(fused, counts)
            if nat is not None:
                cols_ms, merged_counts = nat
                return KmerTable(k, _unfuse_ms(cols_ms, W), merged_counts)
        if len(fused) == 1:
            order = np.argsort(fused[0])         # unstable is fine
            fs = fused[0][order]
            # run boundaries and unique keys straight from the sorted
            # fused column: one u64 != pass + a starts-only gather
            # instead of gathering all W columns and comparing rows
            new_run = np.empty(len(fs), bool)
            new_run[0] = True
            np.not_equal(fs[1:], fs[:-1], out=new_run[1:])
            if int(np.count_nonzero(new_run)) == len(fs):
                # ALL DISTINCT (the unique-heavy hot case): no runs to
                # collapse — skip the starts gather and reduceat
                # entirely (they were ~half the merge wall time)
                fu = fs
                merged_counts = counts[order]
            else:
                starts = np.flatnonzero(new_run)
                fu = fs[starts]
                merged_counts = np.add.reduceat(counts[order], starts)
            if W == 2 and sys.byteorder == "little":
                # split via a 32-bit rotate + reinterpret: one
                # contiguous pass instead of two strided column stores
                rot = (fu >> np.uint64(32)) | (fu << np.uint64(32))
                kb = np.ascontiguousarray(rot.view(np.uint32)
                                          .reshape(-1, 2))
            elif W == 2:
                kb = np.empty((len(fu), 2), np.uint32)
                kb[:, 0] = fu >> np.uint64(32)
                kb[:, 1] = fu.astype(np.uint32)
            else:
                kb = fu.astype(np.uint32).reshape(-1, 1)
            return KmerTable(k, kb, merged_counts)
        order = np.lexsort(tuple(fused))
        counts = counts[order]
        kb = keys[order]  # (M, W) uint32 in sorted order
        new_run = np.empty(len(kb), bool)
        new_run[0] = True
        np.any(kb[1:] != kb[:-1], axis=1, out=new_run[1:])
        starts = np.flatnonzero(new_run)
        merged_counts = np.add.reduceat(counts, starts)
        return KmerTable(k, kb[starts], merged_counts)

    def merge(self, other: "KmerTable") -> "KmerTable":
        """Merge two sorted tables (sum counts of equal keys)."""
        assert self.k == other.k
        if other.num_distinct == 0:
            return self
        if self.num_distinct == 0:
            return other
        return KmerTable.from_pairs(
            self.k, np.concatenate([self.keys, other.keys], axis=0),
            np.concatenate([self.counts, other.counts]))

    def _probe(self, other: "KmerTable"):
        """For each of self's keys: (hit, idx) into other's sorted keys
        — one searchsorted over the big-endian void views (the shared
        kernel of intersect/subtract/get_many)."""
        va, vb = _void_view(self.keys), _void_view(other.keys)
        idx = np.minimum(np.searchsorted(vb, va), len(vb) - 1)
        return vb[idx] == va, idx

    def union(self, other: "KmerTable") -> "KmerTable":
        """Sum-union (KMC-tools `simple ... union`): all keys, counts
        added where a key is in both.  Alias of merge()."""
        return self.merge(other)

    def intersect(self, other: "KmerTable") -> "KmerTable":
        """Keys present in BOTH tables, count = min(self, other) —
        KMC-tools `simple ... intersect` with min counters.  Vectorized:
        one searchsorted over the big-endian void views."""
        assert self.k == other.k
        if self.num_distinct == 0 or other.num_distinct == 0:
            return KmerTable.empty(self.k)
        hit, idx = self._probe(other)
        keep = np.flatnonzero(hit)
        return KmerTable(self.k, self.keys[keep],
                         np.minimum(self.counts[keep],
                                    other.counts[idx[keep]]))

    def subtract(self, other: "KmerTable",
                 counters: bool = True) -> "KmerTable":
        """counters=True (KMC `counters_subtract`): per-key count
        difference self - other, keys dropped when the result <= 0.
        counters=False (KMC `kmers_subtract`): drop every key present
        in `other` regardless of counts."""
        assert self.k == other.k
        if self.num_distinct == 0 or other.num_distinct == 0:
            return self
        hit, idx = self._probe(other)
        if not counters:
            keep = ~hit
            return KmerTable(self.k, self.keys[keep], self.counts[keep])
        new = self.counts - np.where(hit, other.counts[idx], 0)
        keep = new > 0
        return KmerTable(self.k, self.keys[keep], new[keep])

    def compare(self, other: "KmerTable") -> dict:
        """Similarity summary of two tables (Mash/sourmash-style, but
        exact): Jaccard index and per-side containment over DISTINCT
        keys, plus shared/total tallies.  One _probe pass."""
        assert self.k == other.k
        na, nb = self.num_distinct, other.num_distinct
        if na == 0 or nb == 0:
            inter = 0
        else:
            hit, _ = self._probe(other)
            inter = int(hit.sum())
        union = na + nb - inter
        return {
            "k": self.k,
            "distinct_a": na, "distinct_b": nb, "distinct_shared": inter,
            "jaccard": inter / union if union else 1.0,
            "containment_a_in_b": inter / na if na else 1.0,
            "containment_b_in_a": inter / nb if nb else 1.0,
        }

    def filter_min_count(self, min_count: int) -> "KmerTable":
        """Drop k-mers with count < min_count (error-kmer cutoff)."""
        return self.filter_count_range(min_count)

    def filter_count_range(self, min_count: int = 1,
                           max_count: int | None = None) -> "KmerTable":
        """Keep k-mers with min_count <= count (<= max_count): the
        standard counter cutoffs (KMC's -ci/-cx) — min drops sequencing
        errors, max drops repeat-saturated k-mers."""
        keep = self.counts >= min_count
        if max_count is not None:
            keep &= self.counts <= max_count
        return KmerTable(self.k, self.keys[keep], self.counts[keep])

    @staticmethod
    def from_routed_pairs(n_bases: int, words, counts) -> "KmerTable":
        """Aggregate a routed-pairs device output (the
        make_distributed_*_pairs contract): stack the std key words,
        drop SENTINEL (padding) lanes, and from_pairs the rest."""
        from ..ops.extract import SENTINEL
        ks = np.stack([np.asarray(w).reshape(-1) for w in words], 1)
        c = np.asarray(counts).reshape(-1)
        live = ks[:, 0] != SENTINEL
        return KmerTable.from_pairs(n_bases, ks[live],
                                    c[live].astype(np.int64))

    def get(self, kmer: str, canonical: bool = False) -> int:
        """Count of one k-mer (0 if absent) — binary search.

        Pass canonical=True when the table was built with canonical
        counting: the query is then mapped to min(kmer, revcomp) first
        (the table itself stores only canonical forms)."""
        from ..ops.encode import encode_seq, key_words_from_codes, revcomp_str
        if len(kmer) != self.k:
            raise ValueError(f"expected a {self.k}-mer, got {len(kmer)} bases")
        if canonical:
            kmer = min(kmer, revcomp_str(kmer))
        key = key_words_from_codes(encode_seq(kmer))
        v = _void_view(self.keys)
        target = _void_view(key.reshape(1, -1))[0]
        i = int(np.searchsorted(v, target))
        if i < len(v) and v[i] == target:
            return int(self.counts[i])
        return 0

    def get_many(self, kmers: list[str],
                 canonical: bool = False) -> np.ndarray:
        """Vectorized count lookup for a list of k-mers (0 where
        absent): one searchsorted over the void views instead of a
        Python loop of get() binary searches."""
        from ..ops.encode import encode_seq, key_words_from_codes, revcomp_str
        if not kmers:
            return np.zeros((0,), np.int64)
        for km in kmers:
            if len(km) != self.k:
                raise ValueError(
                    f"expected a {self.k}-mer, got {len(km)} bases")
        if canonical:
            kmers = [min(km, revcomp_str(km)) for km in kmers]
        q = np.stack([key_words_from_codes(encode_seq(km)) for km in kmers])
        if self.num_distinct == 0:
            return np.zeros((len(kmers),), np.int64)
        hit, idx = KmerTable(self.k, q, np.zeros(len(q)))._probe(self)
        return np.where(hit, self.counts[idx], 0).astype(np.int64)

    def save(self, path: str) -> None:
        """Persist as .npz (keys/counts/k)."""
        np.savez_compressed(path, k=np.int64(self.k), keys=self.keys,
                            counts=self.counts)

    @staticmethod
    def load(path: str) -> "KmerTable":
        with np.load(path) as z:
            return KmerTable(int(z["k"]), z["keys"], z["counts"])

    def multiplicity_histogram(self) -> dict[int, int]:
        """{multiplicity -> number of distinct k-mers with that count}
        (the standard k-mer spectrum, cf. KMC's histogram output)."""
        if self.num_distinct == 0:
            return {}
        vals, freq = np.unique(self.counts, return_counts=True)
        return {int(v): int(f) for v, f in zip(vals, freq)}

    def top(self, n: int) -> list[tuple[str, int]]:
        """The n most frequent k-mers, count-descending then key order."""
        if self.num_distinct == 0:
            return []
        order = np.argsort(-self.counts, kind="stable")[:n]
        from ..ops.encode import decode_key_words
        kmers = decode_key_words(self.keys[order], self.k)
        return list(zip(kmers, self.counts[order].tolist()))

    def __eq__(self, other) -> bool:
        return (isinstance(other, KmerTable) and self.k == other.k
                and self.keys.shape == other.keys.shape
                and bool(np.all(self.keys == other.keys))
                and bool(np.all(self.counts == other.counts)))


class TableAccumulator:
    """Logarithmic buffered-flush aggregation of a stream of per-batch
    tables (the pipeline/count.py merge schedule in synchronous form):
    parts are buffered and bulk-merged in ONE vectorized from_pairs once
    the buffered pair count crosses `flush_pairs`; a merge that fails to
    compact (unique-heavy streams) backs the threshold off x4.  Total
    merge work stays O(n log n) — re-merging the growing table every
    batch is O(n^2) (the VERDICT r3 #2 multihost flaw).  Aggregation is
    order-independent (integer counts), so the result is bit-identical
    to any other schedule."""

    def __init__(self, n_bases: int, flush_pairs: int = 8 << 20):
        self.n_bases = n_bases
        self.flush_pairs = flush_pairs
        self._parts: list[KmerTable] = []
        self._buffered = 0

    def add(self, t: KmerTable) -> None:
        if t.num_distinct == 0:
            return
        self._parts.append(t)
        self._buffered += t.num_distinct
        if self._buffered >= self.flush_pairs and len(self._parts) > 1:
            self._merge()

    def _merge(self) -> None:
        n_in = self._buffered
        merged = KmerTable.from_pairs(
            self.n_bases,
            np.concatenate([p.keys for p in self._parts], axis=0),
            np.concatenate([p.counts for p in self._parts]))
        if merged.num_distinct > 0.75 * n_in:
            # barely compacted: a bigger threshold keeps the merge count
            # logarithmic (same backoff as pipeline/count.py)
            self.flush_pairs *= 4
        self._parts = [merged]
        self._buffered = merged.num_distinct

    def result(self) -> KmerTable:
        """Final merged table (empty tables carry the right key width)."""
        if not self._parts:
            return KmerTable.empty(self.n_bases)
        if len(self._parts) > 1:
            self._merge()
        return self._parts[0]
