"""End-to-end counting pipeline: FASTA -> device batches -> KmerTable.

Single-host driver (SURVEY.md §7 layer 6).  The device step is one jit
compilation reused across all batches (static shapes from the batcher);
the host merges per-batch tables with vectorized numpy.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import KmerConfig
from ..io.fasta import iter_batches, parse_seqs
from ..ops import count as count_ops
from ..ops.canonical import canonical_kmer_lanes
from ..ops.extract import kmer_lanes
from ..utils.stats import StatsLogger, Timer
from ..utils import stagetime
from .table import KmerTable


def _extract(codes, lengths, limits, k, canonical, mask_ambiguous):
    """(words, valid) of contiguous k-mers, strand-canonical or not."""
    fn = canonical_kmer_lanes if canonical else kmer_lanes
    return fn(codes, lengths, k, limits=limits, mask_ambiguous=mask_ambiguous)


def _unpack(codes, packed_width: int):
    """packed_width > 0: codes arrive 2-bit-packed as (B, ceil(L/16))
    uint32 (io.fasta packed transfer, 4x smaller H2D) and are unpacked
    on device; packed_width is the row width L."""
    if packed_width:
        from ..ops.encode import unpack_codes_u32
        return unpack_codes_u32(codes, packed_width)
    return codes


@partial(jax.jit, static_argnames=("k", "canonical", "mask_ambiguous",
                                   "group_keys", "packed_width"))
def count_step_sort(codes, lengths, limits, *, k: int, canonical: bool,
                    mask_ambiguous: bool = False, group_keys: int = 0,
                    packed_width: int = 0):
    """One device batch, sort mode: (sorted words, is_start, counts).

    group_keys > 0 runs the grouped partial-aggregation path
    (ops/count.grouped_count): the key stream is counted in independent
    group_keys-sized slices with the minimum-width repacked comparator,
    and the output may contain the same key in several runs, which the
    host merge aggregates (KmerTable.from_pairs).  group_keys == 0 gives
    one exact flat sort (globally sorted output; the parity path).
    """
    codes = _unpack(codes, packed_width)
    words, valid = _extract(codes, lengths, limits, k, canonical,
                            mask_ambiguous)
    if group_keys > 0:
        return count_ops.grouped_count(words, valid, k, group_keys)
    return count_ops.sort_count(words)


@partial(jax.jit, static_argnames=("positions", "canonical",
                                   "mask_ambiguous", "group_keys",
                                   "packed_width"))
def spaced_step_sort(codes, lengths, limits, *, positions: tuple,
                     canonical: bool, mask_ambiguous: bool = False,
                     group_keys: int = 0, packed_width: int = 0):
    """One device batch of SPACED-SEED keys (ops/extract.spaced_lanes
    semantics): (sorted words, is_start, counts), same contracts as
    count_step_sort.  positions = the mask's '1' offsets (static)."""
    from ..ops.extract import mask_from_positions, spaced_lanes
    codes = _unpack(codes, packed_width)
    words, valid = spaced_lanes(codes, lengths,
                                mask_from_positions(positions),
                                limits=limits,
                                mask_ambiguous=mask_ambiguous,
                                canonical=canonical)
    if group_keys > 0:
        return count_ops.grouped_count(words, valid, len(positions),
                                       group_keys)
    return count_ops.sort_count(words)


@partial(jax.jit, static_argnames=("k", "canonical", "mask_ambiguous",
                                   "group_keys", "part_keys",
                                   "packed_width"))
def count_step_compact(codes, lengths, limits, *, k: int, canonical: bool,
                       mask_ambiguous: bool = False, group_keys: int = 256,
                       part_keys: int = 2048, packed_width: int = 0):
    """One device batch with ON-DEVICE COMPACTION: returns
    (records, total) — the host fetches only rows [0, total), so D2H
    scales with distinct k-mers (ops/count.grouped_count_compact)."""
    codes = _unpack(codes, packed_width)
    words, valid = _extract(codes, lengths, limits, k, canonical,
                            mask_ambiguous)
    return count_ops.grouped_count_compact(words, valid, k, group_keys,
                                           part_keys=part_keys)


def _fetch_host(tree):
    """Materialize a (possibly nested) device output on host — the
    blocking readback, separated so stagetime can attribute it."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fetch_host(x) for x in tree)
    return np.asarray(tree)


# devmerge trades per-batch D2H (~10 B/lane) for two device sorts per
# batch; on fast links the readback is already cheap and the sorts are
# pure overhead.  Breakeven ~ (bytes/lane) / (sort seconds/lane); the
# value is not yet derived on the current card (ROADMAP 3.3).
DEVMERGE_BREAKEVEN_GBPS = 0.5


def _devmerge_ok(cfg=None) -> bool:
    """Device-resident table accumulation policy (ops/devmerge):
    KMER_TPU_DEVMERGE=1/0 forces (operational escape hatch), then
    cfg.device_merge "on"/"off"; "auto" = a measured D2H link below the
    breakeven (utils.linkspeed; the CPU backend reports an infinite
    link, so auto stays off there)."""
    import os
    env = os.environ.get("KMER_TPU_DEVMERGE")
    if env in ("0", "1"):
        return env == "1"
    mode = getattr(cfg, "device_merge", "auto") if cfg is not None \
        else "auto"
    if mode in ("on", "off"):
        return mode == "on"
    thr = float(os.environ.get("KMER_TPU_DEVMERGE_LINK_GBPS",
                               str(DEVMERGE_BREAKEVEN_GBPS)))
    from ..utils.linkspeed import d2h_gbps
    return d2h_gbps() < thr


def fetch_compact_rows(row_blocks, total_rows) -> np.ndarray:
    """Host fetch of a compacted batch: transfers only ~total_rows
    128-lane rows (rounded up to a power-of-two bucket so at most ~log2
    distinct transfer shapes ever compile)."""
    t = int(total_rows)
    if t == 0:
        return np.zeros((0, 128), np.uint32)
    cap = min(row_blocks.shape[0], 1 << max(7, (t - 1).bit_length()))
    return np.asarray(row_blocks[:cap])[:t]



def gapped_device_len(cfg: KmerConfig) -> int:
    """Device row length for GAPPED batching, shared by every gapped
    driver (single-host, streaming, multihost): cfg.max_read_len.  The
    XLA gapped step's compile time stays well under a second up to the
    parity width of 512 on the GPU (PERF.md), so no width cap is needed.
    KMER_TPU_GAPPED_MAXLEN forces a narrower row (floored at the window
    span); reads then split at the batcher's c_max-1 overlap seams,
    which keeps extraction exact at any width."""
    import os
    env_ml = os.environ.get("KMER_TPU_GAPPED_MAXLEN")
    if env_ml:
        return max(int(env_ml), cfg.window_span)
    return cfg.max_read_len


def gapped_mesh_device_len(cfg: KmerConfig, n_seq: int = 1) -> int:
    """Mesh variant of gapped_device_len: KMER_TPU_GAPPED_MAXLEN is
    rounded up to a multiple of n_seq at or above the window span
    (rounding down could yield max_len <= overlap (c_max-1) and an
    assertion in the segmenter); otherwise cfg.max_read_len."""
    import os
    env_ml = os.environ.get("KMER_TPU_GAPPED_MAXLEN")
    if env_ml and n_seq > 1:
        w = max(int(env_ml), cfg.window_span)
        return -(-w // n_seq) * n_seq
    return gapped_device_len(cfg)


@partial(jax.jit, static_argnames=("l_len", "r_len", "c_min", "c_max",
                                   "mask_ambiguous", "group_keys",
                                   "packed_width"))
def gapped_step_sort(codes, lengths, limits, *, c_min: int, c_max: int,
                     l_len: int = 27, r_len: int = 27,
                     mask_ambiguous: bool = False, group_keys: int = 0,
                     packed_width: int = 0):
    """One device batch of gapped L+R chunks (reference semantics,
    main.rs:63-79), counted: (sorted words, is_start, counts).

    group_keys/packed_width as in count_step_sort — callers must
    aggregate with KmerTable.from_pairs when group_keys > 0."""
    from ..ops.extract import gapped_lanes
    codes = _unpack(codes, packed_width)
    words, valid = gapped_lanes(codes, lengths, l_len, r_len,
                                c_min=c_min, c_max=c_max, limits=limits,
                                mask_ambiguous=mask_ambiguous)
    if group_keys > 0:
        return count_ops.grouped_count(words, valid, l_len + r_len,
                                       group_keys)
    return count_ops.sort_count(words)


@partial(jax.jit, static_argnames=("l_len", "r_len", "c_min", "c_max",
                                   "mask_ambiguous", "group_keys",
                                   "part_keys", "packed_width"))
def gapped_step_compact(codes, lengths, limits, *, c_min: int, c_max: int,
                        l_len: int = 27, r_len: int = 27,
                        mask_ambiguous: bool = False, group_keys: int = 256,
                        part_keys: int = 2048, packed_width: int = 0):
    """Gapped batch with ON-DEVICE COMPACTION: (records, total) as
    count_step_compact, with 8-field records for the W=4 chunk keys
    (ops/count.record_width)."""
    from ..ops.extract import gapped_lanes
    codes = _unpack(codes, packed_width)
    words, valid = gapped_lanes(codes, lengths, l_len, r_len,
                                c_min=c_min, c_max=c_max, limits=limits,
                                mask_ambiguous=mask_ambiguous)
    return count_ops.grouped_count_compact(words, valid, l_len + r_len,
                                           group_keys, part_keys=part_keys)


@partial(jax.jit, static_argnames=("k", "canonical", "mask_ambiguous",
                                   "packed_width"),
         donate_argnames=("hist",))
def count_step_dense(codes, lengths, limits, hist, *, k: int, canonical: bool,
                     mask_ambiguous: bool = False, packed_width: int = 0):
    """One device batch, dense mode: accumulate into donated 4^k hist."""
    codes = _unpack(codes, packed_width)
    words, valid = _extract(codes, lengths, limits, k, canonical,
                            mask_ambiguous)
    return count_ops.dense_histogram(words[-1], valid, k, hist)


def count_codes(codes: np.ndarray, offsets: np.ndarray, cfg: KmerConfig,
                stats: StatsLogger | None = None) -> KmerTable:
    """Count k-mers of pre-parsed records (codes/offsets contract of
    io.fasta.parse_fasta).

    The device step is dispatched asynchronously and host compaction
    runs one batch behind (double buffering, SURVEY.md §7 "host<->device
    overlap"): while the chip sorts batch i, the host merges batch i-1's
    table, so neither side stalls on the other.
    """
    log = stats or StatsLogger(enabled=cfg.stats)
    mode = cfg.effective_mode
    seed_positions = None
    if cfg.seed_mask is not None:
        from ..ops.extract import parse_seed_mask
        seed_positions = parse_seed_mask(cfg.seed_mask)
    n_bases = cfg.n_bases
    # dense mode, split by k (the 4^k output layout is the same either
    # way):
    #   k <= 8   — device-resident table, one scatter-add per batch
    #              (count_step_dense);
    #   k = 9..12 — link-aware split (utils.linkspeed.dense_scatter_ok):
    #     fast link ("hybrid"): the device runs the grouped sort-count
    #              step (single-word keys) and the HOST accumulates the
    #              dense table with one vectorized np.add.at per batch,
    #              overlapped with the device pipeline;
    #     slow link: the per-batch readback of (key, count) pairs costs
    #              more than a device scatter-add into a 4^k table —
    #              accumulate ON DEVICE (count_step_dense, zero
    #              per-batch D2H).
    dense_scatter = mode == "dense" and cfg.k > 8
    if dense_scatter:
        from ..utils.linkspeed import dense_scatter_ok
        dense_scatter = dense_scatter_ok()
    dense_hybrid = mode == "dense" and cfg.k > 8 and not dense_scatter
    hist = (jnp.zeros((4 ** cfg.k,), jnp.int32)
            if mode == "dense" and not dense_hybrid else None)
    # the device histogram is int32; drain it to a host int64 table
    # before any bin could reach 2^31 (worst case: every key in a batch
    # lands in one bin)
    host_hist = None
    hybrid_hist = (np.zeros(4 ** cfg.k, np.int64) if dense_hybrid else None)

    def hybrid_accumulate(dev_out):
        s, is_start, counts = dev_out
        with stagetime.stage("readback"):
            counts = np.asarray(counts)
            sel = np.asarray(is_start) & (counts > 0)
            idx = np.asarray(s[-1])[sel]
        with stagetime.stage("host_merge"):
            np.add.at(hybrid_hist, idx, counts[sel])

    drain_every = max(1, (2 ** 31 - 1) //
                      max(cfg.batch_reads * cfg.max_read_len, 1))
    n_batches = 0
    total_reads = len(offsets) - 1
    pending = None          # sort mode: device outputs one batch behind
    # per-batch tables are buffered and bulk-merged (one vectorized
    # argsort over many batches) instead of re-merged every batch —
    # re-sorting the growing table per batch is O(total^2 log) overall.
    parts: list[KmerTable] = []
    buffered = 0
    flush_pairs = 8 << 20

    # grouped sorting leaves per-batch tables group-locally sorted with
    # possible duplicate keys, so even a single part must be aggregated
    grouped = mode == "sort" and cfg.sort_group_keys > 0

    # flush merges run on a single background thread so the multi-second
    # from_pairs (numpy releases the GIL for sort/gather) overlaps the
    # device pipeline and per-batch D2H instead of stalling it; at most
    # one merge is in flight, harvested before the next flush (and at
    # the end), so memory stays bounded at ~one merged table + the
    # accumulating parts.  Tables are aggregation-order-independent, so
    # the result is bit-identical to the synchronous schedule.
    import concurrent.futures as _cf
    merge_pool = _cf.ThreadPoolExecutor(max_workers=1)
    merge_inflight: list = []       # [] or [Future[(table, n_in)]]

    def _do_merge(snapshot):
        n_in = sum(len(p.counts) for p in snapshot)
        merged = KmerTable.from_pairs(
            n_bases,
            np.concatenate([p.keys for p in snapshot], axis=0),
            np.concatenate([p.counts for p in snapshot]))
        return merged, n_in

    aggregated_ids: set = set()     # parts that are already sorted-unique

    # DEVICE-RESIDENT sorted-table accumulation (ops/devmerge):
    # keys+counts stay on device across batches; the host reads back
    # only distinct rows (once, at drain) instead of ~10 B/lane every
    # batch — the sparse analog of dense mode for slow links.
    devmerge_on = (mode == "sort" and grouped and not cfg.compact
                   and _devmerge_ok(cfg))
    dm_words = dm_counts = None     # lazy device state (first flush)
    dm_distinct = 0                 # host mirror of live rows (synced)
    dm_bound = 0                    # upper bound: distinct <= bound
    dm_total = 0                    # kmers merged since last drain
    dm_d = None                     # device scalar from the last merge
    dm_fixed = False                # env capacity pins C (no growth)
    dm_pend: list = []              # buffered step outputs (not merged)
    dm_pend_lanes = 0

    def dm_flush_pending() -> None:
        """Merge the buffered step outputs into the device state in ONE
        sort, sizing/growing/draining the state first so the capacity
        contract (C >= distinct + N) holds."""
        nonlocal dm_words, dm_counts, dm_distinct, dm_bound, dm_total, \
            dm_d, dm_fixed, dm_pend, dm_pend_lanes
        if not dm_pend:
            return
        from ..ops import devmerge
        N = dm_pend_lanes
        W = len(dm_pend[0][0])
        if dm_words is None:
            import os as _os2
            rows = 1 << max(16, (2 * N - 1).bit_length())
            # an explicit env capacity is FIXED (initial and max — the
            # forced-drain escape hatch); otherwise the state starts
            # small and GROWS within the HBM budget
            dm_fixed = "KMER_TPU_DEVMERGE_ROWS" in _os2.environ
            rows = int(_os2.environ.get(
                "KMER_TPU_DEVMERGE_ROWS", str(rows)))
            # capacity contract floor: after a drain the state is
            # empty, so any C >= N is safe — but an env override below
            # one flush's lane count would make merge_batch truncate
            # live rows (silent key loss).  Clamp, never break.
            rows = max(rows, 1 << (N - 1).bit_length())
            dm_words, dm_counts = devmerge.empty_state(rows, W)
        elif dm_bound + N > dm_counts.shape[0]:
            # the cheap bound (distinct can only have grown by the
            # lanes merged since the last sync) says we MIGHT not fit:
            # sync the true distinct — one ~25 ms blocked round trip,
            # only near capacity — then GROW (sentinel append, no
            # sort) while the HBM budget allows; drain-and-reset only
            # past it.  A reset forgets the table, so recurring keys
            # re-drain once per cycle — growth keeps D2H at
            # distinct-rows-once for any corpus that fits.
            with stagetime.stage("device_sync"):
                dm_distinct = int(dm_d)
            dm_d = None
            dm_bound = dm_distinct
            need = dm_distinct + N
            if need > dm_counts.shape[0]:
                cap = devmerge.max_rows(W)
                if not dm_fixed and need <= cap:
                    new_rows = min(cap, max(
                        2 * dm_counts.shape[0],
                        1 << (need - 1).bit_length()))
                    with stagetime.stage("dispatch"):
                        dm_words, dm_counts = devmerge.grow_state(
                            dm_words, dm_counts, new_rows)
                else:
                    dm_drain()
        if dm_total + N > 2 ** 31 - 1:
            dm_drain()
        with stagetime.stage("dispatch"):
            if len(dm_pend) == 1:
                bw = [w.reshape(-1) for w in dm_pend[0][0]]
                bc = dm_pend[0][1].reshape(-1)
            else:
                bw = [jnp.concatenate(
                    [p[0][i].reshape(-1) for p in dm_pend])
                    for i in range(W)]
                bc = jnp.concatenate(
                    [p[1].reshape(-1) for p in dm_pend])
            dm_words, dm_counts, dm_d = devmerge.merge_batch(
                dm_words, dm_counts, bw, bc)
        dm_bound += N
        dm_total += N
        dm_pend = []
        dm_pend_lanes = 0

    def dm_drain() -> None:
        nonlocal dm_words, dm_counts, dm_distinct, dm_bound, dm_total, \
            dm_d, buffered
        if dm_words is None:
            return
        from ..ops import devmerge
        if dm_d is not None:
            with stagetime.stage("device_sync"):
                dm_distinct = int(dm_d)
            dm_d = None
        with stagetime.stage("readback"):
            # wire-compressed drain: tiered u24/u32 deltas (~4-5 B/row)
            # for W <= 2, raw planes + u8 counts for wide keys; the
            # raw fetch is the fallback on patch overflow
            got = devmerge.fetch_state_wire(dm_words, dm_counts,
                                            dm_distinct)
            if got is None:
                got = devmerge.fetch_state(dm_words, dm_counts,
                                           dm_distinct)
            keys, cts = got
        if len(cts):
            t = KmerTable(n_bases, keys, cts)
            aggregated_ids.add(id(t))   # already sorted-unique
            parts.append(t)
            buffered += t.num_distinct
        dm_words, dm_counts = devmerge.empty_state(dm_counts.shape[0],
                                                   len(dm_words))
        dm_distinct = 0
        dm_bound = 0
        dm_total = 0

    def _harvest() -> None:
        nonlocal parts, buffered, flush_pairs
        if merge_inflight:
            with stagetime.stage("host_merge"):
                merged, n_in = merge_inflight.pop().result()
            aggregated_ids.add(id(merged))
            if merged.num_distinct > 0.75 * n_in:
                # unique-heavy stream: merging barely compacted, and the
                # merged table would be RE-sorted by every later flush
                # (O(total^2) across the run).  A non-compacting flush
                # also saves no memory, so back off HARD — x4 keeps the
                # merge count logarithmic with a smaller constant than
                # x2
                flush_pairs *= 4
            parts.insert(0, merged)
            buffered += merged.num_distinct

    def flush(final: bool = False) -> None:
        nonlocal parts, buffered
        _harvest()
        if final:
            need = (len(parts) > 1
                    or (grouped and parts
                        and id(parts[0]) not in aggregated_ids))
            if need:
                with stagetime.stage("host_merge"):
                    merged, _ = _do_merge(parts)
                parts = [merged]
            buffered = parts[0].num_distinct if parts else 0
            merge_pool.shutdown(wait=False)
            return
        if len(parts) > 1:
            merge_inflight.append(merge_pool.submit(_do_merge, parts))
            parts = []
            buffered = 0

    # 2-bit packed H2D transfer: 4x smaller batches (the ambiguity code
    # needs 3 bits, so skip-invalid mode falls back to u8 rows)
    packed = cfg.packed_transfer and not cfg.skip_invalid
    # gapped: the shared gapped row width (gapped_device_len)
    dev_max_len = gapped_device_len(cfg) if cfg.gapped else cfg.max_read_len
    # TIGHT batch width: narrow the device row width to this
    # chunk's longest record (rounded up to a multiple of 32, floored
    # at the window span) instead of always padding to
    # cfg.max_read_len.  Exactness is free — reads longer than any
    # width already split with overlap seams — and padded lanes cost
    # device work and readback for nothing (150 bp reads padded to 256
    # would carry 1.8x the bytes).  At most
    # a handful of bucketed widths ever compile; the persistent cache
    # holds them.  KMER_TPU_TIGHT_WIDTH=0 restores fixed-width rows.
    import os as _os
    if (_os.environ.get("KMER_TPU_TIGHT_WIDTH", "1") != "0"
            and len(offsets) > 1):
        longest = int(np.max(np.diff(offsets)))
        tight = -(-max(longest, cfg.window_span) // 32) * 32
        dev_max_len = min(dev_max_len, tight)
    for batch in stagetime.stage_iter("batch_prep", iter_batches(
            codes, offsets, batch_reads=cfg.batch_reads,
            max_len=dev_max_len, overlap=cfg.overlap, packed=packed)):
        with Timer() as t:
            pw = batch.packed_width
            if mode == "dense" and not dense_hybrid:
                # hist is donated: accumulation stays on-device between
                # drains; the host syncs only every `drain_every` batches.
                hist = count_step_dense(jnp.asarray(batch.codes),
                                        jnp.asarray(batch.lengths),
                                        jnp.asarray(batch.start_limits), hist,
                                        k=cfg.k, canonical=cfg.canonical,
                                        mask_ambiguous=cfg.skip_invalid,
                                        packed_width=pw)
                if (n_batches + 1) % drain_every == 0:
                    with stagetime.stage("readback"):
                        part = np.asarray(hist).astype(np.int64)
                    host_hist = part if host_hist is None else host_hist + part
                    hist = jnp.zeros((4 ** cfg.k,), jnp.int32)
            else:
                with stagetime.stage("dispatch"):
                    if cfg.gapped and cfg.compact:
                        out = gapped_step_compact(
                            jnp.asarray(batch.codes), jnp.asarray(batch.lengths),
                            jnp.asarray(batch.start_limits),
                            c_min=cfg.c_min, c_max=cfg.c_max,
                            l_len=cfg.l_len, r_len=cfg.r_len,
                            mask_ambiguous=cfg.skip_invalid,
                            group_keys=cfg.sort_group_keys or 256,
                            packed_width=pw)
                    elif cfg.gapped:
                        out = gapped_step_sort(
                            jnp.asarray(batch.codes), jnp.asarray(batch.lengths),
                            jnp.asarray(batch.start_limits),
                            c_min=cfg.c_min, c_max=cfg.c_max,
                            l_len=cfg.l_len, r_len=cfg.r_len,
                            mask_ambiguous=cfg.skip_invalid,
                            group_keys=cfg.sort_group_keys, packed_width=pw)
                    elif cfg.compact:
                        out = count_step_compact(
                            jnp.asarray(batch.codes), jnp.asarray(batch.lengths),
                            jnp.asarray(batch.start_limits),
                            k=cfg.k, canonical=cfg.canonical,
                            mask_ambiguous=cfg.skip_invalid,
                            group_keys=cfg.sort_group_keys, packed_width=pw)
                    elif seed_positions is not None:
                        out = spaced_step_sort(
                            jnp.asarray(batch.codes), jnp.asarray(batch.lengths),
                            jnp.asarray(batch.start_limits),
                            positions=seed_positions, canonical=cfg.canonical,
                            mask_ambiguous=cfg.skip_invalid,
                            group_keys=cfg.sort_group_keys, packed_width=pw)
                    else:
                        out = count_step_sort(
                            jnp.asarray(batch.codes), jnp.asarray(batch.lengths),
                            jnp.asarray(batch.start_limits),
                            k=cfg.k, canonical=cfg.canonical,
                            mask_ambiguous=cfg.skip_invalid,
                            group_keys=cfg.sort_group_keys, packed_width=pw)
                if devmerge_on:
                    words_out, _is_start, counts_out = out
                    dm_pend.append((list(words_out), counts_out))
                    dm_pend_lanes += int(np.prod(counts_out.shape))
                    # GROUPED merges: one state sort per ~C/2
                    # buffered lanes instead of per batch.  The merge
                    # re-sorts the whole C-row state, so per-batch
                    # merging costs ~C/N state passes per lane —
                    # grouping caps it at ~3 sort passes per lane
                    # regardless of C.
                    target = (dm_counts.shape[0] // 2
                              if dm_counts is not None else 0)
                    if dm_pend_lanes >= target:
                        dm_flush_pending()
                elif pending is not None:
                    if dense_hybrid:
                        hybrid_accumulate(pending)
                    else:
                        if cfg.compact:
                            with stagetime.stage("readback"):
                                rows = fetch_compact_rows(*pending)
                            with stagetime.stage("table_build"):
                                btab = KmerTable.from_compact(n_bases, rows)
                        else:
                            with stagetime.stage("readback"):
                                pend_h = _fetch_host(pending)
                            with stagetime.stage("table_build"):
                                btab = KmerTable.from_device_runs(n_bases,
                                                                  *pend_h)
                        parts.append(btab)
                        buffered += btab.num_distinct
                        if buffered >= flush_pairs:
                            flush()
                if not devmerge_on:
                    pending = out
        n_batches += 1
        log.log("batch", i=n_batches, reads=int((batch.lengths > 0).sum()),
                secs=round(t.elapsed, 4))
    if pending is not None:
        if dense_hybrid:
            hybrid_accumulate(pending)
        elif cfg.compact:
            with stagetime.stage("readback"):
                rows = fetch_compact_rows(*pending)
            with stagetime.stage("table_build"):
                parts.append(KmerTable.from_compact(n_bases, rows))
        else:
            with stagetime.stage("readback"):
                pend_h = _fetch_host(pending)
            with stagetime.stage("table_build"):
                parts.append(KmerTable.from_device_runs(n_bases, *pend_h))
    dm_flush_pending()  # devmerge: merge any tail group, then the
    dm_drain()          # one distinct-rows readback
    flush(final=True)
    table = parts[0] if parts else KmerTable.empty(n_bases)
    if dense_hybrid:
        table = KmerTable.from_dense(hybrid_hist, cfg.k)
    elif mode == "dense":
        with stagetime.stage("readback"):
            final = np.asarray(hist).astype(np.int64)
        if host_hist is not None:
            final = final + host_hist
        table = KmerTable.from_dense(final, cfg.k)
    log.log("done", batches=n_batches, reads=total_reads,
            distinct=table.num_distinct, total=table.total)
    return table


def count_fasta(path: str, cfg: KmerConfig | None = None, **cfg_kw) -> KmerTable:
    """Count k-mers of a FASTA or FASTQ file (auto-detected, plain or
    gzip).  `count_fasta(p, k=21)` just works.

    Ingest is chunked (cfg.ingest_chunk_bases): peak host memory is
    bounded regardless of corpus size; per-chunk tables are merged.
    """
    cfg = (cfg or KmerConfig()).replace(**cfg_kw) if cfg_kw else (cfg or KmerConfig())
    return count_files([path], cfg)


def count_files(paths, cfg: KmerConfig | None = None, **cfg_kw) -> KmerTable:
    """Count k-mers across several FASTA/FASTQ files (one merged table;
    formats may be mixed — each file is auto-detected)."""
    from ..io.fasta import iter_parse_chunks
    cfg = (cfg or KmerConfig()).replace(**cfg_kw) if cfg_kw else (cfg or KmerConfig())
    n_bases = cfg.n_bases
    seen_any = False
    # per-chunk tables ride the shared buffered-flush schedule
    # (pipeline.table.TableAccumulator: bulk from_pairs merges with x4
    # backoff) — pairwise-merging the growing table per chunk is
    # O(chunks^2) overall
    from .table import TableAccumulator
    acc = TableAccumulator(n_bases)

    from ..utils.stats import prefetch_iter
    for p in paths:
        if cfg.ingest_chunk_bases > 0:
            # parse chunk i+1 (native, GIL-released) while chunk i counts
            chunks = stagetime.stage_iter("ingest", prefetch_iter(
                iter_parse_chunks(p, max_bases=cfg.ingest_chunk_bases,
                                  allow_ambiguous=cfg.skip_invalid,
                                  min_qual=cfg.min_qual)))
        else:
            with stagetime.stage("ingest"):
                codes, offsets = parse_seqs(p,
                                            allow_ambiguous=cfg.skip_invalid,
                                            min_qual=cfg.min_qual)
            chunks = [(codes, offsets, -1)]
        for codes, offsets, _cur in chunks:
            seen_any = True
            acc.add(count_codes(codes, offsets, cfg))
    if not seen_any:
        # empty input: run one empty pass so dense mode still yields a
        # (possibly empty) table of the right shape
        return count_codes(np.empty(0, np.uint8),
                           np.zeros(1, np.int64), cfg)
    with stagetime.stage("host_merge"):
        return acc.result()
