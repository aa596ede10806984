"""Streaming distinct-k-mer estimation driver (ops/sketch.py).

One pass over the corpus; the (2^(b+5),) class histogram lives on
device across all batches — the host fetches it once at the end, so
peak host memory and total D2H are O(2^b) regardless of corpus size.
The reference has no estimation capability (SURVEY.md §0); this is the
ntCard-shaped capability extension.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..config import KmerConfig
from ..io.fasta import iter_batches, iter_parse_chunks
from ..ops.sketch import estimate_from_histogram, hll_step


def estimate_distinct_files(paths, cfg: KmerConfig | None = None, *,
                            b: int = 10, **cfg_kw):
    """Estimated number of DISTINCT k-mers (and the exact total) across
    FASTA/FASTQ files.

    Returns (estimate: float, total_kmers: int).  b is the HLL
    precision: 2^b buckets, relative error ~ 1.04/sqrt(2^b) (b=10:
    ~3.3%).  Ingest is chunked (bounded host memory); the sketch is
    accumulated on device."""
    cfg = cfg or KmerConfig(**cfg_kw)
    [(est, total)] = estimate_distinct_multi_k(paths, [cfg.k], cfg, b=b)
    return est, total


def estimate_distinct_multi_k(paths, ks, cfg: KmerConfig | None = None,
                              *, b: int = 10, **cfg_kw):
    """ntCard-style MULTI-K estimation in one ingest pass: each batch
    is parsed/shipped once and sketched at every k (the ingest and H2D
    work — the expensive part on a fast chip — is amortized across all
    k values).  Returns [(estimate, total_kmers)] aligned with `ks`.
    cfg.max_read_len must accommodate max(ks)."""
    cfg = cfg or KmerConfig(**cfg_kw)
    ks, hists, totals = sketch_histograms(paths, ks, cfg, b=b)
    from ..ops.sketch import HIST_CAP
    out = []
    for kk in ks:
        h = hists[kk]
        hashed = int(h.sum())     # valid windows actually sketched
        saturated = bool((h >= HIST_CAP).any())
        if not cfg.skip_invalid and not saturated:
            # no masking and no cell at the saturation cap: the sketch
            # saw every extractable window, so the sums must agree — a
            # real error (not an assert: it must survive python -O)
            if hashed != totals[kk]:
                raise RuntimeError(
                    f"HLL histogram lost windows at k={kk}: sketched "
                    f"{hashed} != extracted {totals[kk]} — please report")
        # strict mode knows the exact total host-side; skip_invalid mode
        # reports the sketched count (undercounts only past ~2^30
        # windows PER CELL, i.e. never in practice)
        total = totals[kk] if not cfg.skip_invalid else hashed
        out.append((estimate_from_histogram(h, b), total))
    return out


def sketch_histograms(paths, ks, cfg: KmerConfig, *, b: int = 10):
    """The device pass of estimate_distinct_multi_k: returns (ks,
    {k: (2^(b+5),) int32 (bucket, rho) class histogram}, {k: windows
    extracted}) with ks deduplicated (a spaced seed_mask replaces ks by
    its popcount)."""
    if cfg.gapped:
        raise ValueError("estimation applies to contiguous k-mers")
    if not 1 <= b <= 11:
        raise ValueError(f"buckets_log2 must be in [1, 11] (class width "
                         f"b+5 <= 16 bits), got {b}")
    positions = seed_span = None
    if cfg.seed_mask is not None:
        from ..ops.extract import parse_seed_mask
        positions = parse_seed_mask(cfg.seed_mask)
        seed_span = len(cfg.seed_mask)
        ks = [len(positions)]         # key width = popcount; one "k"
    ks = list(dict.fromkeys(ks))      # dedupe: a repeated k would
    # double-accumulate its shared histogram entry
    if not ks or any(kk < 1 for kk in ks):
        raise ValueError(f"bad k list {ks}")
    if cfg.max_read_len < (seed_span or max(ks)):
        raise ValueError(f"max_read_len={cfg.max_read_len} < window "
                         f"span {seed_span or max(ks)}")
    if isinstance(paths, str):
        paths = [paths]
    hists = {kk: jnp.zeros((1 << (b + 5),), jnp.int32) for kk in ks}
    totals = {kk: 0 for kk in ks}
    # windows are segmented for the LARGEST window (overlap span-1) so
    # every k's extraction is exact with one batching
    overlap = (seed_span or max(ks)) - 1
    # 2-bit packed H2D (4x smaller) exactly as the count pipeline
    packed = cfg.packed_transfer and not cfg.skip_invalid
    from ..utils.stats import prefetch_iter
    for p in paths:
        for codes, offsets, _cur in prefetch_iter(iter_parse_chunks(
                p, max_bases=cfg.ingest_chunk_bases or (256 << 20),
                allow_ambiguous=cfg.skip_invalid, min_qual=cfg.min_qual)):
            for batch in iter_batches(codes, offsets,
                                      batch_reads=cfg.batch_reads,
                                      max_len=cfg.max_read_len,
                                      overlap=overlap, packed=packed):
                jc = jnp.asarray(batch.codes)
                jl = jnp.asarray(batch.lengths)
                jlim = jnp.asarray(batch.start_limits)
                for kk in ks:
                    span = seed_span or kk
                    hists[kk] = hll_step(jc, jl, jlim, hists[kk], k=kk,
                                         canonical=cfg.canonical, b=b,
                                         mask_ambiguous=cfg.skip_invalid,
                                         packed_width=batch.packed_width,
                                         positions=positions)
                    totals[kk] += int(np.maximum(
                        np.minimum(batch.lengths, batch.start_limits
                                   + span - 1) - span + 1, 0).sum())
    return ks, {kk: np.asarray(h) for kk, h in hists.items()}, totals
