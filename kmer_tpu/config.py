"""Configuration for the counting engine.

The reference hard-codes everything — input path (main.rs:44), L/R window
lengths (main.rs:48-49), the chunk-size sweep (main.rs:63); test.py has a
single positional arg (test.py:15-18).  This dataclass is the real flag
system SURVEY.md §5.6 calls for.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class KmerConfig:
    k: int = 21
    canonical: bool = False
    # counting mode: "auto" picks dense for k <= 8 on a slow D2H link,
    # else sort — see effective_mode.
    mode: str = "auto"                      # auto | dense | sort
    batch_reads: int = 8192                 # reads (segments) per device batch
                                            # (bigger batches amortize the
                                            # per-dispatch cost; tests pass
                                            # small explicit values)
    max_read_len: int = 256                 # batch width L; longer reads split
    # gapped reference-parity extraction (main.rs:48-49,63)
    gapped: bool = False
    l_len: int = 27
    r_len: int = 27
    c_min: int = 80
    c_max: int = 140
    # sort-mode grouping: keys per independent device sort slice (many
    # small sorts are cheaper than one big one; the size is not yet
    # tuned on the current card, ROADMAP 1.2).  Equal keys may then
    # span groups, which the host aggregation absorbs —
    # smaller groups trade device speed against on-device dedup for
    # repetitive corpora; 0 = one global sort per batch (globally
    # sorted device output).
    sort_group_keys: int = 256
    # streaming / two-pass
    partitions: int = 16                    # hash-prefix spill partitions
    # bounded-memory ingest: parse inputs in record-aligned windows of
    # at most this many bases (native chunked parser, io.fasta.
    # iter_parse_chunks) so peak host memory is independent of corpus
    # size; 0 = whole-file parse.  Chunk boundaries are deterministic —
    # they are part of the streaming-resume fingerprint.
    ingest_chunk_bases: int = 1 << 28
    # on-device compaction (sort mode, contiguous or gapped): the device
    # step returns only distinct (key, count) records, so device->host
    # transfer scales with DISTINCT k-mers instead of total — a large
    # win on repetitive corpora / slow host links at the cost of an
    # extra partition pass on device (ops/count.grouped_count_compact).
    compact: bool = False
    # device-resident table accumulation (ops/devmerge): sort-mode
    # batches merge (grouped, ~one state sort per C/2 lanes) into an
    # on-device sorted unique (keys, counts) table that GROWS within
    # an HBM budget (KMER_TPU_DEVMERGE_MAX_MB), and the host reads
    # back only distinct rows (tiered u24/u32 delta wire) at drains —
    # D2H scales with DISTINCT keys once per corpus, not per batch.
    # "auto" (default) turns it on when the probed D2H link is below
    # ~0.5 GB/s (utils.linkspeed); "on"/"off" force.
    # KMER_TPU_DEVMERGE=1/0 overrides either way (operational escape
    # hatch); KMER_TPU_DEVMERGE_ROWS pins a FIXED capacity.
    device_merge: str = "auto"              # auto | on | off
    # host->device transfer: ship batches 2-bit-packed in uint32 words
    # (4x smaller H2D; device unpacks in 16 shift-ands).  Automatically
    # disabled in skip_invalid mode (ambiguity code needs 3 bits).
    packed_transfer: bool = True
    # input tolerance: accept N/IUPAC ambiguity codes in the input and
    # drop every window containing one (the reference panics on any
    # non-ACGT byte, main.rs:23; strict mode keeps that contract as a
    # clean error).
    skip_invalid: bool = False
    # FASTQ quality cutoff: mask bases whose Phred+33 quality is below
    # this to the ambiguous code at ingest, so every window containing
    # one is dropped (the standard counter cutoff, cf. KMC -cs quality
    # mode / jellyfish --min-qual-char).  Requires skip_invalid (the
    # masked code rides the same path as N); ignored for FASTA input.
    min_qual: int = 0
    # spaced seed: a 0/1 match mask (e.g. "1101011"); the key per
    # window of span len(mask) is the bases at the '1' offsets
    # (PatternHunter-style).  Sort mode, contiguous reads.
    # canonical requires a palindromic mask (strand-min is otherwise
    # undefined for spaced keys).
    seed_mask: str | None = None
    # observability
    stats: bool = False                     # per-batch JSONL stats to stderr

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.device_merge not in ("auto", "on", "off"):
            raise ValueError(
                f"device_merge={self.device_merge!r} not in auto/on/off")
        if self.mode not in ("auto", "dense", "sort"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.mode == "dense" and self.k > 12:
            raise ValueError("dense mode requires k <= 12")
        if self.gapped and self.mode == "dense":
            raise ValueError("gapped mode requires sort mode")
        if self.gapped and (self.l_len < 1 or self.r_len < 1):
            raise ValueError("gapped mode needs l_len, r_len >= 1")
        if self.gapped and self.c_min < self.l_len + self.r_len:
            raise ValueError("gapped mode needs c_min >= l_len + r_len "
                             "(non-overlapping L/R windows)")
        if self.max_read_len < self.window_span:
            raise ValueError(
                f"max_read_len={self.max_read_len} < window span {self.window_span}")
        if self.compact:
            from .ops.encode import words_per_key
            n_bases = (self.l_len + self.r_len) if self.gapped else self.k
            if words_per_key(n_bases) > 7:
                raise ValueError("compact mode caps at 7 key words "
                                 f"(<= 111 bases; got {n_bases})")
        if self.compact and self.mode == "dense":
            raise ValueError("compact applies to sort mode")
        if not 0 <= self.min_qual <= 93:
            raise ValueError("min_qual must be in [0, 93] (Phred+33 "
                             f"range), got {self.min_qual}")
        if self.min_qual > 0 and not self.skip_invalid:
            raise ValueError("min_qual masks bases to the ambiguous "
                             "code; set skip_invalid=True (CLI: "
                             "--min-qual implies --skip-invalid)")
        if self.seed_mask is not None:
            from .ops.extract import (parse_seed_mask,
                                      seed_mask_palindromic)
            pos = parse_seed_mask(self.seed_mask)   # raises on bad mask
            if len(pos) > 63:
                raise ValueError("seed mask selects more than 63 bases")
            if self.canonical and not seed_mask_palindromic(self.seed_mask):
                raise ValueError("canonical spaced seeds need a "
                                 f"palindromic mask, got {self.seed_mask!r}")
            if self.gapped:
                raise ValueError("seed_mask and gapped are exclusive")
            if self.effective_mode != "sort":
                raise ValueError("seed_mask requires sort mode")
            if self.compact:
                raise ValueError("seed_mask does not support compact "
                                 "(yet)")
            if self.max_read_len < len(self.seed_mask):
                raise ValueError(
                    f"max_read_len={self.max_read_len} < seed span "
                    f"{len(self.seed_mask)}")

    @property
    def n_bases(self) -> int:
        """Bases per key (= key width): seed-mask popcount, gapped
        l+r, or k.  THE single source — every driver derives its table
        width from here (a drifting local copy once silently merged
        adjacent keys through a from_pairs reshape)."""
        if self.seed_mask is not None:
            return self.seed_mask.count("1")
        return (self.l_len + self.r_len) if self.gapped else self.k

    @property
    def window_span(self) -> int:
        """Longest window the extractor needs in one batch row."""
        if self.seed_mask is not None:
            return len(self.seed_mask)
        return self.c_max if self.gapped else self.k

    @property
    def overlap(self) -> int:
        """Host-side segment overlap so split reads lose no windows."""
        return self.window_span - 1

    @property
    def effective_mode(self) -> str:
        """auto: dense for k <= 8 when the D2H link is slow enough that
        its device-resident table pays for the scatter-add's per-key
        device cost (utils.linkspeed — probe
        or KMER_TPU_D2H_GBPS env; the probe never runs at config
        construction).  Explicit dense for k = 9..12 runs the hybrid
        path (device grouped sort-count + host np.add.at dense
        accumulation, pipeline/count.py) at ~sort-mode speed; the two
        modes produce identical tables, differing only in where the
        4^k layout materializes."""
        if self.mode != "auto":
            return self.mode
        if self.compact or self.seed_mask is not None:
            return "sort"
        if self.k <= 8 and not self.gapped:
            from .utils.linkspeed import dense_auto_ok
            return "dense" if dense_auto_ok() else "sort"
        return "sort"

    def replace(self, **kw) -> "KmerConfig":
        return dataclasses.replace(self, **kw)
