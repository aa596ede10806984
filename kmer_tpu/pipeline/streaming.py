"""Streaming two-pass counting with checkpoint/resume (SURVEY.md §7.8,
§5.3-5.4).

The reference is one-shot and fully in-memory (main.rs:50-90): a crash
loses everything and a corpus must fit in RAM.  Here counting is split
into two checkpointable passes over an on-disk spill directory:

  pass 1  device-count each fixed-shape batch (one jit step), compact the
          per-batch table host-side, partition its (key, count) pairs by
          the ORDER-PRESERVING top bits of the key value (the same
          monotone routing the distributed path uses,
          parallel/distributed.py:_route_dest), and append each
          partition's pairs to its spill file.  Checkpoint unit: batch.
  pass 2  per partition, merge the spilled pairs into a sorted unique
          table and write it out.  Checkpoint unit: partition.

Because routing is monotone in the key, concatenating the per-partition
tables in partition order IS the globally sorted table — no final merge.

Crash model: the manifest (manifest.json) is written atomically
(tmp+rename) after every completed unit and records the exact byte
length of every spill file; on resume, files are truncated back to their
manifested lengths, so a crash mid-append never corrupts state.  Output
is bit-identical whether the run was interrupted 0 or N times.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from ..config import KmerConfig
from ..io.fasta import iter_batches, iter_parse_chunks, segment_records
from ..ops.encode import words_per_key
from ..utils.stats import StatsLogger, Timer
from .table import KmerTable

MANIFEST = "manifest.json"
_FORMAT_VERSION = 3        # v3: dev_max_len (gapped row width) in
                           # the fingerprint — batch indexing depends
                           # on it, so a resume must use the same width


def route_partition(keys: np.ndarray, n_bases: int, n_parts: int,
                    route_bits: int = 16) -> np.ndarray:
    """Order-preserving partition id of each key (host mirror of
    parallel.distributed._route_dest, generalized to any word count).

    keys: (M, W) uint32, MSW first, no sentinels.  Returns (M,) int64
    with part = top_bits * n_parts // 2^tb — monotone in the key, so
    sorted input keys yield non-decreasing partition ids.
    """
    keys = np.asarray(keys, dtype=np.uint32)
    W = keys.shape[1]
    assert W == words_per_key(n_bases), (W, n_bases)
    tb = min(route_bits, 2 * n_bases)
    avail0 = 2 * n_bases - 32 * (W - 1)      # value bits held in word 0
    if avail0 >= tb:
        h = (keys[:, 0] >> np.uint32(avail0 - tb)) & np.uint32((1 << tb) - 1)
    else:
        need = tb - avail0
        hi = (keys[:, 0].astype(np.uint64) & np.uint64((1 << avail0) - 1)) << np.uint64(need)
        lo = keys[:, 1].astype(np.uint64) >> np.uint64(32 - need)
        h = hi | lo
    return (h.astype(np.int64) * n_parts) >> tb


def _atomic_write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


@dataclass
class _PairBlock:
    """One spilled block: keys (n, W) uint32 + counts (n,) uint32."""
    keys: np.ndarray
    counts: np.ndarray

    def tobytes(self) -> bytes:
        n = len(self.counts)
        rec = np.empty((n, self.keys.shape[1] + 1), dtype=np.uint32)
        rec[:, :-1] = self.keys
        rec[:, -1] = self.counts
        return rec.tobytes()


def _read_pairs(path: str, nbytes: int, W: int) -> tuple[np.ndarray, np.ndarray]:
    if nbytes == 0 or not os.path.exists(path):
        return (np.zeros((0, W), np.uint32), np.zeros((0,), np.int64))
    with open(path, "rb") as f:
        raw = f.read(nbytes)
    rec = np.frombuffer(raw, dtype=np.uint32).reshape(-1, W + 1)
    return rec[:, :-1].copy(), rec[:, -1].astype(np.int64)


class StreamingCounter:
    """Two-pass spill counter over one FASTA file.

    Usage:
        sc = StreamingCounter(fasta, cfg, spill_dir)
        sc.run()                     # both passes, resumable
        for p, table in sc.partition_tables(): ...
        table = sc.final_table()     # concatenated global table
    """

    def __init__(self, fasta: str, cfg: KmerConfig, spill_dir: str,
                 stats: StatsLogger | None = None, mesh=None):
        """`mesh`: optional jax Mesh — pass 1 batches are then counted
        with the multi-chip distributed step (data/seq sharding + the
        order-preserving all_to_all merge) before spilling; the spill
        format and resume semantics are unchanged, so a run can even be
        resumed on a different mesh shape (gapped runs: the new mesh's
        seq axis must divide the stored device row width — the manifest
        carries it, so resumes keep the original batch indexing)."""
        self.fasta = fasta
        self.cfg = cfg
        self.dir = spill_dir
        self.log = stats or StatsLogger(enabled=cfg.stats)
        self.P = cfg.partitions
        self.W = words_per_key(self._n_bases)
        self.mesh = mesh
        # gapped: the shared gapped row width (pipeline.count.
        # gapped_device_len / gapped_mesh_device_len).
        if cfg.gapped and mesh is None:
            from .count import gapped_device_len
            self._dev_max_len = gapped_device_len(cfg)
        elif cfg.gapped:
            from ..parallel.mesh import SEQ_AXIS as _SEQ
            from .count import gapped_mesh_device_len
            self._dev_max_len = gapped_mesh_device_len(
                cfg, mesh.shape.get(_SEQ, 1))
        else:
            self._dev_max_len = cfg.max_read_len
        self._dist_fn = None
        if mesh is not None:
            from ..parallel import distributed
            from ..parallel.mesh import DATA_AXIS
            from ..parallel.mesh import SEQ_AXIS
            n_data = mesh.shape[DATA_AXIS]
            n_seq = mesh.shape.get(SEQ_AXIS, 1)
            if cfg.batch_reads % max(n_data, 1):
                raise ValueError(
                    f"batch_reads={cfg.batch_reads} not divisible by mesh "
                    f"data axis {n_data}")
            if n_seq > 1 and self._dev_max_len % n_seq:
                raise ValueError(
                    f"device row width {self._dev_max_len} not divisible "
                    f"by mesh seq axis {n_seq}")
            # local-count pair routing when eligible (policy shared
            # with the multihost driver, distributed.pairs_eligible)
            use_pairs = distributed.pairs_eligible()
            self._dist_pairs = use_pairs
            if cfg.seed_mask is not None and not use_pairs:
                # the sorted-stream step has no spaced extraction; same
                # guard as the multihost driver
                raise ValueError("spaced seeds need the pairs step; "
                                 "unset KMER_TPU_MULTIHOST_STEP=legacy")

            def _build_dist(capacity=None):
                if cfg.gapped and use_pairs:
                    return distributed.make_distributed_gapped_pairs(
                        mesh, l_len=cfg.l_len, r_len=cfg.r_len,
                        c_min=cfg.c_min, c_max=cfg.c_max,
                        capacity=capacity,
                        mask_ambiguous=cfg.skip_invalid)
                if cfg.gapped:
                    return distributed.make_distributed_gapped(
                        mesh, l_len=cfg.l_len, r_len=cfg.r_len,
                        c_min=cfg.c_min, c_max=cfg.c_max,
                        capacity=capacity,
                        mask_ambiguous=cfg.skip_invalid)
                if use_pairs:
                    return distributed.make_distributed_count_pairs(
                        mesh, k=cfg.k, canonical=cfg.canonical,
                        capacity=capacity,
                        mask_ambiguous=cfg.skip_invalid,
                        seed_mask=cfg.seed_mask)
                return distributed.make_distributed_count(
                    mesh, k=cfg.k, canonical=cfg.canonical,
                    capacity=capacity,
                    mask_ambiguous=cfg.skip_invalid)

            self._build_dist = _build_dist
            self._dist_capacity = None      # None = route_capacity default
            self._dist_fn = _build_dist()
        os.makedirs(spill_dir, exist_ok=True)
        self.manifest_path = os.path.join(spill_dir, MANIFEST)
        self.state = self._load_or_init_state()

    @property
    def _n_bases(self) -> int:
        return self.cfg.n_bases

    def _fingerprint(self) -> dict:
        c = self.cfg
        st = os.stat(self.fasta)
        return {
            "version": _FORMAT_VERSION, "fasta": os.path.abspath(self.fasta),
            "fasta_size": st.st_size, "fasta_mtime_ns": st.st_mtime_ns,
            "k": c.k, "canonical": c.canonical,
            "gapped": c.gapped, "partitions": c.partitions,
            "batch_reads": c.batch_reads, "max_read_len": c.max_read_len,
            "skip_invalid": c.skip_invalid, "min_qual": c.min_qual,
            "seed_mask": c.seed_mask,
            "l_len": c.l_len, "r_len": c.r_len,
            "c_min": c.c_min, "c_max": c.c_max,
            # chunk boundaries are deterministic given this; a changed
            # value would shift batch indices mid-resume
            "ingest_chunk_bases": c.ingest_chunk_bases,
        }

    def _load_or_init_state(self) -> dict:
        fp = self._fingerprint()
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path) as f:
                state = json.load(f)
            if state["fingerprint"] == fp:
                # batch indexing depends on the device row width the
                # run STARTED with (the gapped width varies with the
                # mesh and KMER_TPU_GAPPED_MAXLEN) — adopt the stored
                # width so a run resumes correctly on a different mesh
                # shape or env, as long as the current mesh can shard it
                stored = int(state.get("dev_max_len",
                                       self._dev_max_len))
                if self.mesh is not None:
                    from ..parallel.mesh import SEQ_AXIS as _SEQ
                    n_seq = self.mesh.shape.get(_SEQ, 1)
                    if n_seq > 1 and stored % n_seq:
                        raise ValueError(
                            f"resuming a run batched at row width "
                            f"{stored}, which the current mesh seq "
                            f"axis {n_seq} cannot shard; resume on a "
                            f"mesh whose seq axis divides it")
                self._dev_max_len = stored
                return state
            raise ValueError(
                f"spill dir {self.dir} holds a different run "
                f"(config/input changed); use a fresh directory")
        state = {
            "fingerprint": fp,
            "dev_max_len": self._dev_max_len,
            "pass1_next_batch": 0,
            # ingest cursor of the chunk containing pass1_next_batch
            # (uncompressed byte offset; 0 = start, -1 = fallback parser
            # without cursor support) and the global batch index at that
            # chunk's start — resume seeks here instead of re-parsing
            # completed bytes.
            "pass1_cursor": 0,
            "pass1_cursor_batch": 0,
            "pass1_done": False,
            "part_bytes": [0] * self.P,
            "pass2_done": [False] * self.P,
        }
        _atomic_write_json(self.manifest_path, state)
        return state

    def _part_path(self, p: int) -> str:
        return os.path.join(self.dir, f"part_{p:05d}.bin")

    def _table_path(self, p: int) -> str:
        return os.path.join(self.dir, f"table_{p:05d}.npz")

    def _checkpoint(self) -> None:
        _atomic_write_json(self.manifest_path, self.state)

    def _truncate_to_manifest(self) -> None:
        """Undo any partial appends from a crashed pass-1 batch."""
        for p in range(self.P):
            path = self._part_path(p)
            want = self.state["part_bytes"][p]
            if os.path.exists(path) and os.path.getsize(path) > want:
                with open(path, "r+b") as f:
                    f.truncate(want)
            elif not os.path.exists(path) and want:
                raise ValueError(f"spill file {path} missing "
                                 f"({want} bytes expected)")

    # ---------------------------------------------------------- pass 1

    def _batch_table(self, batch) -> KmerTable:
        import jax.numpy as jnp
        cfg = self.cfg
        pw = getattr(batch, "packed_width", 0)
        if self._dist_fn is not None:
            args = (jnp.asarray(batch.codes), jnp.asarray(batch.lengths),
                    jnp.asarray(batch.start_limits))
            # a single destination can receive at most all of one
            # device's keys, so capacity == local lane count can never
            # overflow — the doubling retry terminates there
            cap_max = batch.codes.size
            while True:
                out = self._dist_fn(*args)
                overflow = out[-1]
                if not bool(overflow):
                    break
                if (self._dist_capacity or 0) >= cap_max:
                    raise RuntimeError(
                        "distributed routing capacity overflow at full "
                        "local capacity — this should be impossible; "
                        "please report")
                # routing skew beat the slack: double the send capacity
                # and retry this batch (one-off recompile, then cached)
                prev = self._dist_capacity or max(cap_max // 8, 128)
                self._dist_capacity = min(prev * 2, cap_max)
                self.log.log("route_overflow_retry",
                             capacity=self._dist_capacity)
                self._dist_fn = self._build_dist(self._dist_capacity)
            if self._dist_pairs:
                words, counts, _ = out
                return KmerTable.from_routed_pairs(self._n_bases, words,
                                                   counts)
            s, is_start, counts, _ = out
            return KmerTable.from_device_runs(self._n_bases, s, is_start,
                                              counts)
        s, is_start, counts = self._batch_step_raw(batch)
        table = KmerTable.from_device_runs(self._n_bases, s, is_start, counts)
        if cfg.sort_group_keys > 0:
            # grouped output is only group-locally sorted; _spill_table
            # needs globally sorted keys (searchsorted partition cuts)
            table = KmerTable.from_pairs(self._n_bases, table.keys,
                                         table.counts)
        return table

    def _batch_step_raw(self, batch):
        """Non-distributed device step: (std words, is_start, counts) —
        shared by the per-batch table path and the devmerge path."""
        import jax.numpy as jnp
        cfg = self.cfg
        pw = getattr(batch, "packed_width", 0)
        if cfg.gapped:
            from .count import gapped_step_sort
            return gapped_step_sort(
                jnp.asarray(batch.codes), jnp.asarray(batch.lengths),
                jnp.asarray(batch.start_limits),
                c_min=cfg.c_min, c_max=cfg.c_max,
                l_len=cfg.l_len, r_len=cfg.r_len,
                mask_ambiguous=cfg.skip_invalid,
                group_keys=cfg.sort_group_keys, packed_width=pw)
        if cfg.seed_mask is not None:
            from ..ops.extract import parse_seed_mask
            from .count import spaced_step_sort
            return spaced_step_sort(
                jnp.asarray(batch.codes), jnp.asarray(batch.lengths),
                jnp.asarray(batch.start_limits),
                positions=parse_seed_mask(cfg.seed_mask),
                canonical=cfg.canonical,
                mask_ambiguous=cfg.skip_invalid,
                group_keys=cfg.sort_group_keys, packed_width=pw)
        from .count import count_step_sort
        return count_step_sort(
            jnp.asarray(batch.codes), jnp.asarray(batch.lengths),
            jnp.asarray(batch.start_limits),
            k=cfg.k, canonical=cfg.canonical,
            mask_ambiguous=cfg.skip_invalid,
            group_keys=cfg.sort_group_keys, packed_width=pw)

    def run_pass1(self, max_batches: int | None = None) -> None:
        """Pass 1; `max_batches` limits work this call (for tests and
        cooperative preemption) — call again to continue.

        Ingest is chunked (cfg.ingest_chunk_bases): host memory stays
        bounded for any corpus size, and resume seeks straight to the
        checkpointed chunk cursor — completed batches' bytes are never
        re-parsed (with the native parser; the NumPy fallback re-streams
        from the top but still skips completed batches).
        """
        if self.state["pass1_done"]:
            return
        self._truncate_to_manifest()
        cfg = self.cfg
        start = self.state["pass1_next_batch"]
        cursor = self.state.get("pass1_cursor", 0)
        global_i = self.state.get("pass1_cursor_batch", 0)
        if cursor <= 0:
            cursor, global_i = 0, 0
        n_done = 0
        packed = (cfg.packed_transfer and not cfg.skip_invalid
                  and self._dist_fn is None)
        # devmerge (r5): device-resident accumulation with drain-commit
        # checkpoints (policy shared with count_codes)
        from .count import _devmerge_ok
        use_dm = (self._dist_fn is None and cfg.effective_mode == "sort"
                  and cfg.sort_group_keys > 0 and not cfg.compact
                  and _devmerge_ok(cfg))
        dm = {"words": None, "counts": None, "distinct": 0,
              "bound": 0, "total": 0, "d_dev": None}
        if cfg.ingest_chunk_bases > 0:
            chunks = iter_parse_chunks(
                self.fasta, max_bases=cfg.ingest_chunk_bases,
                allow_ambiguous=cfg.skip_invalid, start_cursor=cursor,
                min_qual=cfg.min_qual)
        else:
            # 0 = whole-file parse (one chunk, no resume cursor)
            from ..io.fasta import parse_seqs
            codes0, offsets0 = parse_seqs(self.fasta,
                                          allow_ambiguous=cfg.skip_invalid,
                                          min_qual=cfg.min_qual)
            chunks = iter([(codes0, offsets0, -1)])
        for codes, offsets, next_cur in chunks:
            spans_n = len(segment_records(offsets, self._dev_max_len,
                                          cfg.overlap))
            n_in_chunk = max(-(-spans_n // cfg.batch_reads), 1)
            skip = start - global_i
            if skip >= n_in_chunk:
                # fallback-parser resume path (no cursor): whole chunk
                # already counted
                global_i += n_in_chunk
                continue
            for i, batch in enumerate(iter_batches(
                    codes, offsets, batch_reads=cfg.batch_reads,
                    max_len=self._dev_max_len, overlap=cfg.overlap,
                    start_batch=max(skip, 0), packed=packed),
                    start=global_i + max(skip, 0)):
                if max_batches is not None and n_done >= max_batches:
                    if use_dm:
                        # cooperative pause: keep the work
                        self._dm_commit(dm, next_batch=start)
                    return
                if use_dm:
                    with Timer() as t:
                        self._dm_merge(dm, batch, i)
                    start = i + 1
                    n_done += 1
                    self.log.log("pass1_batch", i=i,
                                 distinct_bound=dm["bound"],
                                 secs=round(t.elapsed, 4))
                    continue
                with Timer() as t:
                    table = self._batch_table(batch)
                    self._spill_table(table)
                self.state["pass1_next_batch"] = i + 1
                start = i + 1
                self._checkpoint()
                n_done += 1
                self.log.log("pass1_batch", i=i, pairs=table.num_distinct,
                             secs=round(t.elapsed, 4))
            global_i += n_in_chunk
            if next_cur > 0:
                if use_dm:
                    # the cursor skips this chunk's bytes on resume, so
                    # everything before it must be durably spilled
                    self._dm_commit(dm, next_batch=start)
                self.state["pass1_cursor"] = next_cur
                self.state["pass1_cursor_batch"] = global_i
                self._checkpoint()
        if use_dm:
            self._dm_commit(dm, next_batch=start)
        self.state["pass1_done"] = True
        self._checkpoint()
        self.log.log("pass1_done", batches=self.state["pass1_next_batch"])

    def _spill_table(self, table: KmerTable) -> None:
        """Append one batch table's pairs to the per-partition files.

        The table is sorted, routing is monotone -> partition ids are
        non-decreasing; boundaries come from one searchsorted.
        """
        if table.num_distinct == 0:
            return
        dest = route_partition(table.keys, self._n_bases, self.P)
        bounds = np.searchsorted(dest, np.arange(self.P + 1))
        for p in range(self.P):
            lo, hi = int(bounds[p]), int(bounds[p + 1])
            if lo == hi:
                continue
            blk = _PairBlock(table.keys[lo:hi],
                             table.counts[lo:hi].astype(np.uint32))
            data = blk.tobytes()
            with open(self._part_path(p), "ab") as f:
                f.write(data)
            self.state["part_bytes"][p] += len(data)

    # devmerge pass-1 (r5): batches accumulate in the on-device sorted
    # table (ops/devmerge) and the manifest cursor advances ONLY at
    # drains — a crash between drains re-counts the un-drained batches
    # on resume (their spills were never written, so nothing doubles).
    def _dm_merge(self, dm, batch, i: int) -> None:
        """Buffer one batch's step output; merge the group into the
        device state once ~C/2 lanes are pending (one state sort per
        group instead of per batch — the state re-sort dominates the
        device cost at large C)."""
        s_words, _is_start, cts = self._batch_step_raw(batch)
        dm.setdefault("pend", []).append((list(s_words), cts))
        dm["pend_lanes"] = dm.get("pend_lanes", 0) + int(np.prod(cts.shape))
        target = (dm["counts"].shape[0] // 2
                  if dm["counts"] is not None else 0)
        if dm["pend_lanes"] >= target:
            self._dm_flush(dm)

    def _dm_flush(self, dm) -> None:
        """Merge the pending group in one sort, sizing/growing/spilling
        the state first so the capacity contract (C >= distinct + N)
        holds.  Internal spills do NOT advance the cursor — only
        _dm_commit does, after flushing — so a crash between flushes
        re-counts at most the batches since the last commit (their
        spill bytes roll back to the last checkpointed manifest)."""
        import jax.numpy as jnp

        from ..ops import devmerge
        if not dm.get("pend"):
            return
        N = dm["pend_lanes"]
        W = len(dm["pend"][0][0])
        if dm["words"] is None:
            rows = 1 << max(16, (2 * N - 1).bit_length())
            # explicit env capacity = fixed (forced-drain escape
            # hatch); otherwise start small and grow
            dm["fixed"] = "KMER_TPU_DEVMERGE_ROWS" in os.environ
            rows = int(os.environ.get("KMER_TPU_DEVMERGE_ROWS",
                                      str(rows)))
            # clamp below one group's lane count: C >= N keeps the
            # capacity contract (merge_batch truncates live rows past
            # C — an env override must not cause silent key loss)
            rows = max(rows, 1 << (N - 1).bit_length())
            dm["words"], dm["counts"] = devmerge.empty_state(rows, W)
        elif dm["bound"] + N > dm["counts"].shape[0]:
            # bound check first (distinct <= bound); sync the true
            # distinct only near capacity; then grow (sentinel append,
            # ops/devmerge.grow_state) within the HBM budget — a reset
            # re-drains recurring keys once per cycle — and spill
            # only past the budget
            dm["distinct"] = int(dm["d_dev"])
            dm["d_dev"] = None
            dm["bound"] = dm["distinct"]
            need = dm["distinct"] + N
            if need > dm["counts"].shape[0]:
                cap = devmerge.max_rows(W)
                if not dm.get("fixed") and need <= cap:
                    new_rows = min(cap, max(2 * dm["counts"].shape[0],
                                            1 << (need - 1).bit_length()))
                    dm["words"], dm["counts"] = devmerge.grow_state(
                        dm["words"], dm["counts"], new_rows)
                else:
                    self._dm_spill(dm)
        if dm["total"] + N > 2 ** 31 - 1:
            self._dm_spill(dm)
        if len(dm["pend"]) == 1:
            bw = [w.reshape(-1) for w in dm["pend"][0][0]]
            bc = dm["pend"][0][1].reshape(-1)
        else:
            bw = [jnp.concatenate([p[0][j].reshape(-1)
                                   for p in dm["pend"]])
                  for j in range(W)]
            bc = jnp.concatenate([p[1].reshape(-1) for p in dm["pend"]])
        dm["words"], dm["counts"], dm["d_dev"] = devmerge.merge_batch(
            dm["words"], dm["counts"], bw, bc)
        dm["bound"] += N
        dm["total"] += N
        dm["pend"] = []
        dm["pend_lanes"] = 0

    def _dm_spill(self, dm) -> None:
        """Drain the device state rows into the spill files and reset
        it.  No cursor advance, no checkpoint — the appended bytes
        become durable only at the next _dm_commit/_checkpoint (torn
        appends roll back to the manifest on resume)."""
        from ..ops import devmerge
        if dm["words"] is not None and dm["d_dev"] is not None:
            dm["distinct"] = int(dm["d_dev"])
            dm["d_dev"] = None
        if dm["words"] is not None and dm["distinct"]:
            got = devmerge.fetch_state_wire(dm["words"], dm["counts"],
                                            dm["distinct"])
            if got is None:
                got = devmerge.fetch_state(dm["words"], dm["counts"],
                                           dm["distinct"])
            keys, cts = got
            self._spill_table(KmerTable(self._n_bases, keys, cts))
            dm["words"], dm["counts"] = devmerge.empty_state(
                dm["counts"].shape[0], len(dm["words"]))
            dm["distinct"] = 0
            dm["bound"] = 0
            dm["total"] = 0

    def _dm_commit(self, dm, next_batch: int) -> None:
        """Flush + drain the device table into the spills and
        atomically commit the pass-1 cursor (the devmerge checkpoint
        unit)."""
        self._dm_flush(dm)
        self._dm_spill(dm)
        if next_batch > self.state["pass1_next_batch"]:
            self.state["pass1_next_batch"] = next_batch
        self._checkpoint()

    # ---------------------------------------------------------- pass 2

    def run_pass2(self) -> None:
        if not self.state["pass1_done"]:
            raise RuntimeError("pass 1 incomplete; run_pass1() first")
        for p in range(self.P):
            if self.state["pass2_done"][p]:
                continue
            with Timer() as t:
                keys, counts = _read_pairs(self._part_path(p),
                                           self.state["part_bytes"][p], self.W)
                table = KmerTable.from_pairs(self._n_bases, keys, counts)
                tmp = self._table_path(p) + ".tmp.npz"
                np.savez(tmp, keys=table.keys, counts=table.counts)
                os.replace(tmp, self._table_path(p))
            self.state["pass2_done"][p] = True
            self._checkpoint()
            self.log.log("pass2_part", p=p, distinct=table.num_distinct,
                         secs=round(t.elapsed, 4))
        self.log.log("pass2_done", partitions=self.P)

    # ---------------------------------------------------------- driver

    def run(self) -> None:
        self.run_pass1()
        self.run_pass2()

    def partition_tables(self):
        """Yield (p, KmerTable) in partition (= global key) order."""
        for p in range(self.P):
            if not self.state["pass2_done"][p]:
                raise RuntimeError(f"partition {p} not counted yet; run()")
            with np.load(self._table_path(p)) as z:
                yield p, KmerTable(self._n_bases, z["keys"], z["counts"])

    def final_table(self) -> KmerTable:
        """Concatenate partition tables -> the global sorted table."""
        keys, counts = [], []
        for _, t in self.partition_tables():
            keys.append(t.keys)
            counts.append(t.counts)
        if not keys:
            return KmerTable.empty(self._n_bases)
        return KmerTable(self._n_bases, np.concatenate(keys, axis=0),
                         np.concatenate(counts))

    def multiplicity_histogram(self) -> dict[int, int]:
        """The k-mer spectrum of the full corpus, streamed: partitions
        hold disjoint key ranges, so per-partition spectra add —
        peak host memory stays one partition table (the histo analog
        of write_tsv)."""
        out: dict[int, int] = {}
        for _, t in self.partition_tables():
            for mult, ndis in t.multiplicity_histogram().items():
                out[mult] = out.get(mult, 0) + ndis
        return out

    def write_tsv(self, stream) -> None:
        """Stream the global table as TSV without materializing it."""
        for _, t in self.partition_tables():
            t.write_tsv(stream)

    def cleanup(self, keep_tables: bool = True) -> None:
        """Delete spill files (and optionally the per-partition tables
        + manifest) after a completed run."""
        for p in range(self.P):
            path = self._part_path(p)
            if os.path.exists(path):
                os.remove(path)
        if not keep_tables:
            for p in range(self.P):
                t = self._table_path(p)
                if os.path.exists(t):
                    os.remove(t)
            if os.path.exists(self.manifest_path):
                os.remove(self.manifest_path)


def stream_count_fasta(path: str, cfg: KmerConfig | None = None,
                       spill_dir: str = None, **cfg_kw) -> KmerTable:
    """Two-pass streaming count; resumable via `spill_dir`."""
    assert spill_dir is not None, "spill_dir is required for streaming"
    cfg = (cfg or KmerConfig()).replace(**cfg_kw) if cfg_kw else (cfg or KmerConfig())
    sc = StreamingCounter(path, cfg, spill_dir)
    sc.run()
    return sc.final_table()
