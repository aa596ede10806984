"""Multi-chip counting: shard_map count step with hash-prefix
all_to_all merge (sort mode) and psum/reduce-scatter merge (dense mode).

Design (SURVEY.md §7 layer 7, BASELINE.json north star):
  * reads are data-parallel over mesh axis "data"; optionally the length
    dimension is sequence-parallel over "seq" with a (span-1)-base halo
    exchange (parallel/halo.py);
  * each device extracts + locally sorts its keys, then keys are routed
    to their OWNER device by the top bits of the key value — an
    order-preserving partition, so after one all_to_all and a local
    re-sort the concatenation of per-device tables in mesh order is the
    globally sorted count table;
  * equal keys always share an owner, so counts need no cross-device
    reduction — determinism is structural (integer counts, fixed routing),
    giving bit-identical tables for any device count;
  * dense mode (k <= 12) instead psums local 4^k histograms — one
    collective, replicated result (or reduce-scattered shards).

Everything is static-shape: routed keys travel in a (n_dev, capacity)
buffer padded with the sentinel; an overflow flag is returned so callers
can detect capacity misconfiguration (skewed corpora) instead of
silently dropping keys.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from ..ops import count as count_ops
from ..ops.canonical import canonical_kmer_lanes, lex_min
from ..ops.encode import words_per_key
from ..ops.extract import SENTINEL, kmer_lanes, rc_kmer_lanes
from .halo import halo_extend, seq_shard_lane_mask
from .mesh import DATA_AXIS, SEQ_AXIS

# top-of-key bits used for routing (order-preserving for any n_dev)
_ROUTE_BITS = 16


def _route_dest(w0: jnp.ndarray, w1: jnp.ndarray | None, n_bases: int,
                n_dev: int) -> jnp.ndarray:
    """Owner device of each key from the top tb bits of its value:
    dest = h * n // 2^tb — monotone in the key, so routing preserves
    global order for any device count.  Sentinel (all ones) lands on
    n_dev-1.  w0/w1 are the two most-significant words (w1 may be None
    when W == 1).  n_bases is the key width in bases (k, or l_len+r_len
    for gapped keys).
    """
    W = words_per_key(n_bases)
    avail0 = 2 * n_bases - 32 * (W - 1)  # value bits held in w0 (may be 0)
    tb = min(_ROUTE_BITS, 2 * n_bases)
    if avail0 >= tb:
        h = (w0 >> jnp.uint32(avail0 - tb)) & jnp.uint32((1 << tb) - 1)
    else:
        # top bits straddle w0/w1 (e.g. k=16: w0 holds only the sentinel
        # bit) — pull the remainder from the second word
        need = tb - avail0
        hi = (w0 & jnp.uint32((1 << avail0) - 1)) << jnp.uint32(need)
        lo = w1 >> jnp.uint32(32 - need)
        h = hi | lo
    # int32 math is safe: h < 2^16 and n_dev <= 2^15
    return (h.astype(jnp.int32) * n_dev) // (1 << tb)


def route_capacity(n_local_keys: int, n_dev: int, slack: float = 4.0) -> int:
    """Default per-destination send capacity: even share x slack,
    lane-aligned.  Send-buffer bytes are then ~slack * N_loc * W * 4 per
    device — NOT x n_dev as a capacity of N_loc would cost (VERDICT r1
    #3).  The slack absorbs routing skew (canonical keys bias the top
    value bits low); on overflow the drivers retry with 2x capacity
    (parallel overflow flag, rare recompile)."""
    even = -(-n_local_keys // max(n_dev, 1))
    cap = int(even * slack)
    return max(128, -(-cap // 128) * 128)


def _partition_and_route(sorted_words: list[jnp.ndarray], dest: jnp.ndarray,
                         axis_names, n_dev: int, capacity: int):
    """Scatter locally-sorted keys into (n_dev, capacity) send buffers and
    all_to_all them to their owners.  Returns (recv_words, overflow).

    Sentinel (invalid/padding) lanes carry dest == n_dev: segment_sum
    drops them, so they are never shipped — only real keys ride the
    interconnect."""
    N = dest.shape[0]
    # dest is non-decreasing (keys sorted, routing monotone): bucket b
    # occupies [starts[b], starts[b+1]).
    counts = jax.ops.segment_sum(jnp.ones_like(dest), dest, num_segments=n_dev)
    starts = jnp.cumsum(counts) - counts
    overflow = jnp.any(counts > capacity)
    slot = lax.broadcasted_iota(jnp.int32, (n_dev, capacity), 1)
    src = jnp.clip(starts[:, None] + slot, 0, N - 1)
    in_bucket = slot < counts[:, None]
    send = [jnp.where(in_bucket, w[src], SENTINEL) for w in sorted_words]
    recv = [lax.all_to_all(w, axis_names, split_axis=0, concat_axis=0,
                           tiled=True).reshape(-1)
            for w in send]
    return recv, overflow


def count_step_distributed(codes, lengths, limits, *, k: int, canonical: bool,
                           capacity: int, axis_names=(DATA_AXIS, SEQ_AXIS),
                           seq_axis: str | None = SEQ_AXIS,
                           mask_ambiguous: bool = False):
    """shard_map body: local shapes in, per-owner sorted runs out.

    codes:   (B_loc, L_loc) — rows sharded over "data", columns over "seq"
    lengths: (B_loc,) GLOBAL read lengths (replicated over "seq")
    limits:  (B_loc,) window-start ownership limits (host segmentation)

    Returns (sorted_words, is_start, counts, overflow) — concatenating
    the first three over devices in mesh order yields the global sorted
    count table.
    """
    n_dev = 1
    for a in axis_names:
        n_dev *= lax.axis_size(a)

    B, L_loc = codes.shape
    if seq_axis is not None and lax.axis_size(seq_axis) > 1:
        ext = halo_extend(codes, seq_axis, k - 1)
        fwd, fval = kmer_lanes(ext, jnp.full((B,), ext.shape[1], jnp.int32), k,
                               sentinel=False, mask_ambiguous=mask_ambiguous)
        fwd = [w[:, :L_loc] for w in fwd]
        valid = seq_shard_lane_mask(B, L_loc, lengths, seq_axis, k)
        if mask_ambiguous:
            valid = valid & fval[:, :L_loc]
        s_idx = lax.axis_index(seq_axis)
        pos = lax.broadcasted_iota(jnp.int32, (B, L_loc), 1) + s_idx * L_loc
        valid = valid & (pos < limits.astype(jnp.int32)[:, None])
        if canonical:
            rc, _ = rc_kmer_lanes(ext, jnp.full((B,), ext.shape[1], jnp.int32),
                                  k, sentinel=False)
            rc = [w[:, :L_loc] for w in rc]
            words = lex_min(fwd, rc)
        else:
            words = fwd
        words = [jnp.where(valid, w, SENTINEL) for w in words]
    else:
        if canonical:
            words, _ = canonical_kmer_lanes(codes, lengths, k, limits=limits,
                                            mask_ambiguous=mask_ambiguous)
        else:
            words, _ = kmer_lanes(codes, lengths, k, limits=limits,
                                  mask_ambiguous=mask_ambiguous)

    s = count_ops.sort_words(words)
    dest = _route_dest(s[0], s[1] if len(s) > 1 else None, k, n_dev)
    # sentinel lanes (word 0 == SENTINEL, guaranteed by the reserved
    # sentinel bit of the key layout) are routed nowhere
    dest = jnp.where(s[0] == SENTINEL, n_dev, dest)
    recv, overflow = _partition_and_route(s, dest, axis_names, n_dev, capacity)
    # overflow anywhere is overflow everywhere (replicated scalar out)
    overflow = lax.psum(overflow.astype(jnp.int32), axis_names) > 0
    s2 = count_ops.sort_words(recv)
    is_start, counts = count_ops.run_lengths(s2)
    return s2, is_start, counts, overflow


def pairs_eligible() -> bool:
    """Driver policy (multihost + streaming): route through the
    local-count pairs step?  One definition so the policy can never
    drift between drivers.  Every key kind (contiguous, spaced, gapped,
    any width) has a pairs body, so this is the default;
    KMER_TPU_MULTIHOST_STEP=legacy restores the sorted-stream merge
    (which has no spaced-seed form)."""
    import os
    return os.environ.get("KMER_TPU_MULTIHOST_STEP", "pairs") != "legacy"


# keys per independent sort slice of the pairs steps' local count (the
# single-device default, config.KmerConfig.sort_group_keys)
LOCAL_GROUP_KEYS = 256


def _route_local_pairs(words, valid, n_bases: int, axis_names, n_dev: int,
                       capacity: int):
    """Local grouped count of one device's keys, then (key, count) pairs
    to their owners.  Returns (recv_std_words, recv_counts, overflow).

    The grouped count collapses duplicates within each sort slice, so
    the routed pair volume is at most the lane count and shrinks with
    the corpus's repetition.  Runs that are not run heads (count 0) and
    sentinel lanes are routed nowhere."""
    std, _is_start, counts = count_ops.grouped_count(words, valid, n_bases,
                                                     LOCAL_GROUP_KEYS)
    cnt = counts.astype(jnp.uint32)
    dest = _route_dest(std[0], std[1] if len(std) > 1 else None, n_bases,
                       n_dev)
    dest = jnp.where((std[0] == SENTINEL) | (cnt == 0), n_dev, dest)
    # single-word partition sort; keys+counts ride as payload
    s = lax.sort((dest, *std, cnt), num_keys=1)
    recv, overflow = _partition_and_route(list(s[1:]), s[0], axis_names,
                                          n_dev, capacity)
    overflow = lax.psum(overflow.astype(jnp.int32), axis_names) > 0
    return recv[:-1], recv[-1], overflow


def count_step_distributed_pairs(codes, lengths, limits, *, k: int,
                                 canonical: bool, capacity: int,
                                 axis_names=(DATA_AXIS, SEQ_AXIS),
                                 seq_axis: str | None = SEQ_AXIS,
                                 mask_ambiguous: bool = False,
                                 positions: tuple | None = None):
    """shard_map body, LOCAL-COUNT variant: local shapes in, routed
    (std_words..., counts, overflow) PAIRS out.

    The sorted-stream step (count_step_distributed) pays two full flat
    sorts per batch because its routing and its run-length counting
    both need sorted order.  Counting TABLES need neither — only
    deterministic aggregation — so this step runs the single-device
    grouped count locally (extraction + canonical + grouped sort +
    run-length), routes (key, count) pairs with ONE single-word dest
    sort, and lets the host's order-independent integer aggregation
    (KmerTable.from_pairs) merge per owner.  Tables stay bit-identical
    across mesh shapes because integer aggregation is
    order-independent; the globally-sorted stream contract (parity
    mode) stays on the sorted-stream step.

    Output lanes with SENTINEL key words are dead (padding); counts
    ride as a uint32 word.
    """
    n_dev = 1
    for a in axis_names:
        n_dev *= lax.axis_size(a)
    B, L_loc = codes.shape
    span = (positions[-1] + 1) if positions else k   # spaced seeds
    if seq_axis is not None and lax.axis_size(seq_axis) > 1:
        # halo so every window is extracted exactly once; ownership and
        # in-read validity become per-shard effective lengths/limits
        # (the extractors' validity test is pos <= len-span & pos < lim)
        ext = halo_extend(codes, seq_axis, span - 1)
        base = lax.axis_index(seq_axis) * L_loc
        len_eff = jnp.clip(lengths.astype(jnp.int32) - base, 0,
                           ext.shape[1])
        lim_eff = jnp.clip(limits.astype(jnp.int32) - base, 0, L_loc)
        codes_l, lengths_l, limits_l = ext, len_eff, lim_eff
    else:
        codes_l, lengths_l, limits_l = codes, lengths, limits
    if positions is not None:
        from ..ops.extract import mask_from_positions, spaced_lanes
        words, valid = spaced_lanes(codes_l, lengths_l,
                                    mask_from_positions(positions),
                                    limits=limits_l,
                                    mask_ambiguous=mask_ambiguous,
                                    canonical=canonical)
    elif canonical:
        words, valid = canonical_kmer_lanes(
            codes_l, lengths_l, k, limits=limits_l,
            mask_ambiguous=mask_ambiguous)
    else:
        words, valid = kmer_lanes(codes_l, lengths_l, k, limits=limits_l,
                                  mask_ambiguous=mask_ambiguous)
    return _route_local_pairs(words, valid, k, axis_names, n_dev, capacity)


def make_distributed_count_pairs(mesh, *, k: int, canonical: bool = False,
                                 capacity: int | None = None,
                                 use_seq: bool | None = None,
                                 mask_ambiguous: bool = False,
                                 seed_mask: str | None = None):
    """jit-compiled local-count distributed count over `mesh`.

    Returns fn(codes, lengths, limits) -> (std_words, counts, overflow);
    aggregate host-side with KmerTable.from_routed_pairs.  Works for
    any k and for spaced seeds (seed_mask)."""
    n_data = mesh.shape[DATA_AXIS]
    n_seq = mesh.shape.get(SEQ_AXIS, 1)
    n_dev = n_data * n_seq
    if use_seq is None:
        use_seq = n_seq > 1
    if not use_seq and n_seq > 1:
        raise ValueError(
            f"use_seq=False on a mesh with seq={n_seq}; build the mesh "
            f"with n_seq=1 instead")
    positions = None
    if seed_mask is not None:
        from ..ops.extract import parse_seed_mask, seed_mask_palindromic
        if canonical and not seed_mask_palindromic(seed_mask):
            # the KmerConfig guard is bypassed for direct API users
            raise ValueError("canonical spaced seeds need a palindromic "
                             f"mask, got {seed_mask!r}")
        positions = parse_seed_mask(seed_mask)
        k = len(positions)            # key width = popcount
    span = (positions[-1] + 1) if positions else k

    def fn(codes, lengths, limits):
        B_loc, L_loc = codes.shape
        cap = capacity
        if cap is None:
            n_lanes = B_loc * (L_loc if use_seq else L_loc - span + 1)
            cap = route_capacity(n_lanes, n_dev)
        return count_step_distributed_pairs(
            codes, lengths, limits, k=k, canonical=canonical, capacity=cap,
            axis_names=(DATA_AXIS, SEQ_AXIS),
            seq_axis=SEQ_AXIS if use_seq else None,
            mask_ambiguous=mask_ambiguous, positions=positions)

    shard = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(DATA_AXIS, SEQ_AXIS if use_seq else None),
                  P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=([P((DATA_AXIS, SEQ_AXIS))] * words_per_key(k),
                   P((DATA_AXIS, SEQ_AXIS)), P()),
        check_vma=False)
    return jax.jit(shard)


def make_distributed_count(mesh, *, k: int, canonical: bool = False,
                           capacity: int | None = None,
                           use_seq: bool | None = None,
                           mask_ambiguous: bool = False):
    """jit-compiled distributed count step over `mesh`.

    Returns fn(codes, lengths, limits) -> (sorted_words, is_start,
    counts, overflow) with global outputs sharded over the mesh;
    compacting them host-side (KmerTable.from_device_runs) yields the
    exact global table.
    """
    n_data = mesh.shape[DATA_AXIS]
    n_seq = mesh.shape.get(SEQ_AXIS, 1)
    n_dev = n_data * n_seq
    if use_seq is None:
        use_seq = n_seq > 1
    if not use_seq and n_seq > 1:
        # replicating shards over an unused seq axis would multiply
        # every count by n_seq (each replica contributes to the merge)
        raise ValueError(
            f"use_seq=False on a mesh with seq={n_seq}; build the mesh "
            f"with n_seq=1 instead")

    def fn(codes, lengths, limits):
        # shapes here are per-device (shard_map body)
        B_loc, L_loc = codes.shape
        cap = capacity
        if cap is None:
            cap = route_capacity(
                B_loc * (L_loc if use_seq else L_loc - k + 1), n_dev)
        return count_step_distributed(
            codes, lengths, limits, k=k, canonical=canonical, capacity=cap,
            axis_names=(DATA_AXIS, SEQ_AXIS),
            seq_axis=SEQ_AXIS if use_seq else None,
            mask_ambiguous=mask_ambiguous)

    shard = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(DATA_AXIS, SEQ_AXIS if use_seq else None),
                  P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P((DATA_AXIS, SEQ_AXIS)), P((DATA_AXIS, SEQ_AXIS)),
                   P((DATA_AXIS, SEQ_AXIS)), P()),
        check_vma=False)
    return jax.jit(shard)


def make_distributed_gapped(mesh, *, l_len: int = 27, r_len: int = 27,
                            c_min: int = 80, c_max: int = 140,
                            capacity: int | None = None,
                            use_seq: bool | None = None,
                            mask_ambiguous: bool = False):
    """jit-compiled distributed GAPPED-chunk count step over `mesh`
    (the reference's L+R extraction, main.rs:63-79, scaled out).

    Same contract as make_distributed_count but with 108-bit 4-word
    keys.  Sequence parallelism uses a (c_max-1)-base halo, so each seq
    shard must be at least c_max-1 columns wide.
    """
    from ..ops.extract import gapped_lanes

    n_bases = l_len + r_len
    n_data = mesh.shape[DATA_AXIS]
    n_seq = mesh.shape.get(SEQ_AXIS, 1)
    n_dev = n_data * n_seq
    if use_seq is None:
        use_seq = n_seq > 1
    if not use_seq and n_seq > 1:
        raise ValueError(
            f"use_seq=False on a mesh with seq={n_seq}; build the mesh "
            f"with n_seq=1 instead")
    axis_names = (DATA_AXIS, SEQ_AXIS)

    def body(codes, lengths, limits):
        B, L_loc = codes.shape
        if use_seq and n_seq > 1:
            ext = halo_extend(codes, SEQ_AXIS, c_max - 1)
            s_idx = lax.axis_index(SEQ_AXIS)
            off = (s_idx * L_loc).astype(jnp.int32)
            # shifted lengths/limits turn gapped_lanes' local validity
            # (o + c <= len_shifted) into the global condition; start
            # ownership additionally caps o < L_loc.
            sh_len = lengths.astype(jnp.int32) - off
            sh_lim = jnp.minimum(limits.astype(jnp.int32) - off, L_loc)
            words, _ = gapped_lanes(ext, sh_len, l_len, r_len, c_min, c_max,
                                    limits=sh_lim,
                                    mask_ambiguous=mask_ambiguous)
        else:
            words, _ = gapped_lanes(codes, lengths, l_len, r_len,
                                    c_min, c_max, limits=limits,
                                    mask_ambiguous=mask_ambiguous)
        s = count_ops.sort_words(words)
        cap = capacity
        if cap is None:
            cap = route_capacity(words[0].size, n_dev)
        dest = _route_dest(s[0], s[1] if len(s) > 1 else None,
                           n_bases, n_dev)
        dest = jnp.where(s[0] == SENTINEL, n_dev, dest)
        recv, overflow = _partition_and_route(s, dest, axis_names, n_dev, cap)
        overflow = lax.psum(overflow.astype(jnp.int32), axis_names) > 0
        s2 = count_ops.sort_words(recv)
        is_start, counts = count_ops.run_lengths(s2)
        return s2, is_start, counts, overflow

    shard = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(DATA_AXIS, SEQ_AXIS if use_seq else None),
                  P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P((DATA_AXIS, SEQ_AXIS)), P((DATA_AXIS, SEQ_AXIS)),
                   P((DATA_AXIS, SEQ_AXIS)), P()),
        check_vma=False)
    return jax.jit(shard)


def make_distributed_gapped_pairs(mesh, *, l_len: int = 27, r_len: int = 27,
                                  c_min: int = 80, c_max: int = 140,
                                  capacity: int | None = None,
                                  use_seq: bool | None = None,
                                  mask_ambiguous: bool = False):
    """Local-count distributed GAPPED count: gapped extraction + the
    grouped count run locally, then (key, count) pairs route to owners
    — the gapped twin of make_distributed_count_pairs, replacing two
    4-word flat sorts with one grouped sort and one single-word dest
    sort.  Returns fn -> (std_words, counts, overflow)."""
    from ..ops.extract import gapped_lanes

    n_bases = l_len + r_len
    n_data = mesh.shape[DATA_AXIS]
    n_seq = mesh.shape.get(SEQ_AXIS, 1)
    n_dev = n_data * n_seq
    if use_seq is None:
        use_seq = n_seq > 1
    if not use_seq and n_seq > 1:
        raise ValueError(
            f"use_seq=False on a mesh with seq={n_seq}; build the mesh "
            f"with n_seq=1 instead")
    axis_names = (DATA_AXIS, SEQ_AXIS)

    def body(codes, lengths, limits):
        B, L_loc = codes.shape
        if use_seq and n_seq > 1:
            ext = halo_extend(codes, SEQ_AXIS, c_max - 1)
            off = (lax.axis_index(SEQ_AXIS) * L_loc).astype(jnp.int32)
            # shifted lengths/limits turn gapped_lanes' local validity
            # (o + c <= len_shifted) into the global condition; start
            # ownership additionally caps o < L_loc
            len_l = lengths.astype(jnp.int32) - off
            lim_l = jnp.minimum(limits.astype(jnp.int32) - off, L_loc)
            codes_l = ext
        else:
            codes_l, len_l, lim_l = codes, lengths, limits
        words, valid = gapped_lanes(codes_l, len_l, l_len, r_len,
                                    c_min, c_max, limits=lim_l,
                                    mask_ambiguous=mask_ambiguous)
        cap = capacity
        if cap is None:
            cap = route_capacity(words[0].size, n_dev)
        return _route_local_pairs(words, valid, n_bases, axis_names, n_dev,
                                  cap)

    shard = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(DATA_AXIS, SEQ_AXIS if use_seq else None),
                  P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=([P((DATA_AXIS, SEQ_AXIS))] * words_per_key(n_bases),
                   P((DATA_AXIS, SEQ_AXIS)), P()),
        check_vma=False)
    return jax.jit(shard)


# ---------------------------------------------------------------------------
# Dense mode: local histograms + psum (replicated) or psum_scatter (sharded).
# ---------------------------------------------------------------------------

def make_distributed_dense(mesh, *, k: int, canonical: bool = False,
                           scatter: bool = False,
                           mask_ambiguous: bool = False):
    """jit-compiled dense 4^k distributed count over `mesh` ("data" only).

    scatter=False: full histogram replicated on every device (psum).
    scatter=True:  histogram sharded over "data" (reduce_scatter) — the
    table-parallel layout for big k.
    """
    def fn(codes, lengths, limits):
        if canonical:
            words, valid = canonical_kmer_lanes(
                codes, lengths, k, limits=limits,
                mask_ambiguous=mask_ambiguous)
        else:
            words, valid = kmer_lanes(codes, lengths, k, limits=limits,
                                      mask_ambiguous=mask_ambiguous)
        hist = count_ops.dense_histogram(words[-1], valid, k)
        if scatter:
            return lax.psum_scatter(hist, DATA_AXIS, tiled=True)
        return lax.psum(hist, DATA_AXIS)

    shard = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(DATA_AXIS) if scatter else P(),
        check_vma=False)
    return jax.jit(shard)
