"""Device-resident sorted-table accumulation ("device merge").

On a slow host link the sort pipeline's bottleneck is per-batch D2H:
every batch reads back ~10 bytes/lane of keys+counts even though the
corpus' distinct table is a fraction of that.
Dense mode already solves this for k <= 12 with a device-resident 4^k
histogram; this op is the SPARSE analog for any k: the (keys, counts)
table stays ON DEVICE, each batch's key stream is merged into it with
two XLA sorts + associative scans (static shapes),
and the host reads back only the final distinct rows once — D2H scales
with DISTINCT keys, not lanes.

Merge step (all static shapes, one jit per (C, N) pair):
  concat state (C rows, sorted unique, sentinel-padded) with the
  batch's N lanes -> lexicographic sort on the W key words ->
  run totals via cumsum/backward-cummin (no scatter) -> compact the run
  starts to the front with a second sort on sentinel-masked keys.

Dead lanes (padding, in-segment duplicates) carry count == 0 and are
normalized to all-ones words, which sort past every real key: a real
key's most-significant std word can never be all-ones (the key's
sentinel bit caps it below 2^31 for W == 1, and below 2^(bits-32(W-1))
with bits = 2k+1 odd otherwise).

The capacity contract makes overflow IMPOSSIBLE rather than detected:
callers must keep C >= distinct + N before every merge — by GROWING
the state (grow_state: sentinel append, no sort) within the HBM
budget (max_rows), and draining-and-resetting only past it; in either
case merge_batch never drops a key.  Drivers also GROUP merges (one
state sort per ~C/2 buffered lanes) so total sort work stays ~3
passes per lane regardless of C.  Reference semantics replaced: the
per-batch stdout sort of main.rs:87-90, re-designed as a
device-resident accumulator.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

DEAD = jnp.uint32(0xFFFFFFFF)


def empty_state(capacity: int, n_words: int):
    """Fresh device state: all-sentinel keys, zero counts."""
    words = [jnp.full((capacity,), DEAD, jnp.uint32)
             for _ in range(n_words)]
    counts = jnp.zeros((capacity,), jnp.int32)
    return words, counts


@partial(jax.jit, donate_argnums=(0, 1))
def merge_batch(state_words, state_counts, batch_words, batch_counts):
    """Merge one batch's (duplicated, dead-padded) key stream into the
    sorted unique device table.

    state_words: list of W (C,) uint32, sorted unique keys with
    all-ones padding; state_counts: (C,) int32.
    batch_words: list of W (N,) uint32 lanes; batch_counts: (N,) any
    int dtype — lanes with count <= 0 are dead.
    Returns (words, counts, distinct): same state shapes, plus the
    number of live rows.  Requires C >= distinct_before + N.
    """
    W = len(state_words)
    bc = batch_counts.reshape(-1).astype(jnp.int32)
    dead = bc <= 0
    bw = [jnp.where(dead, DEAD, w.reshape(-1).astype(jnp.uint32))
          for w in batch_words]
    bc = jnp.where(dead, 0, bc)

    ops = ([jnp.concatenate([sw, b]) for sw, b in zip(state_words, bw)]
           + [jnp.concatenate([state_counts, bc])])
    sorted_ops = lax.sort(ops, num_keys=W)
    kw, counts = sorted_ops[:W], sorted_ops[W]

    neq = kw[0][1:] != kw[0][:-1]
    for w in kw[1:]:
        neq = neq | (w[1:] != w[:-1])
    starts = jnp.concatenate([jnp.ones((1,), bool), neq])
    ends = jnp.concatenate([neq, jnp.ones((1,), bool)])

    # run totals without scatter: csum at my run's END minus csum just
    # before my run's START.  The nearest end at-or-after every row is
    # its own run's end; csum is nondecreasing, so that end carries the
    # SMALLEST csum among ends at-or-after i — a backward cummin over
    # (csum where end, else INT_MAX) propagates it to the whole run.
    # i32 csum contract: callers drain before the total count in
    # state+batch could reach 2^31 (the drivers' drain_every schedule).
    csum = jnp.cumsum(counts)
    big = jnp.int32(2 ** 31 - 1)
    end_csum = lax.cummin(jnp.where(ends, csum, big)[::-1])[::-1]
    totals = end_csum - (csum - counts)

    live = starts & (kw[0] != DEAD)
    distinct = jnp.sum(live.astype(jnp.int32))

    masked = [jnp.where(live, w, DEAD) for w in kw]
    packed = lax.sort(masked + [jnp.where(live, totals, 0)], num_keys=W)
    C = state_counts.shape[0]
    new_words = [w[:C] for w in packed[:W]]
    new_counts = packed[W][:C].astype(jnp.int32)
    return new_words, new_counts, distinct


def grow_state(state_words, state_counts, new_rows: int):
    """Grow capacity by appending sentinel rows.

    The state invariant — sorted unique keys with all-ones (DEAD)
    padding, which sorts after every live key — is preserved by
    appending DEAD rows at the end, so growth needs no sort and no
    readback: one O(new_rows) device concat per plane.  Growing beats
    drain-and-reset whenever the corpus' distinct keys exceed the
    initial capacity: a reset forgets the merged table, so recurring
    keys re-enter as new rows and each key is drained (transferred AND
    host-merged) once per cycle instead of once per corpus.
    """
    C = state_counts.shape[0]
    if new_rows <= C:
        return state_words, state_counts
    import jax.numpy as _jnp
    pad_w = _jnp.full((new_rows - C,), DEAD, _jnp.uint32)
    words = [_jnp.concatenate([w, pad_w]) for w in state_words]
    counts = _jnp.concatenate(
        [state_counts, _jnp.zeros((new_rows - C,), _jnp.int32)])
    return words, counts


def max_rows(n_words: int) -> int:
    """Growth budget in rows (power of two): the state may occupy up to
    KMER_TPU_DEVMERGE_MAX_MB (default 1024) of HBM at 4*(W+1) bytes per
    row; past it the drivers fall back to drain-and-reset.  The
    per-batch merge sorts C+N lanes, so the budget also bounds the
    merge's device cost."""
    import os
    try:
        mb = float(os.environ.get("KMER_TPU_DEVMERGE_MAX_MB", "1024"))
    except ValueError:
        mb = 1024.0
    per_row = 4 * (n_words + 1)
    r = max(1, int(mb * 1e6) // per_row)
    return max(1 << 16, 1 << (r.bit_length() - 1))


def fetch_state(state_words, state_counts, distinct: int):
    """Host fetch of the live prefix, rounded up to a power-of-two
    bucket so at most ~log2 transfer shapes ever compile (the
    fetch_compact_rows discipline): (keys (d, W) uint32, counts (d,)
    int64)."""
    d = int(distinct)
    if d == 0:
        W = len(state_words)
        return np.zeros((0, W), np.uint32), np.zeros((0,), np.int64)
    cap = min(state_counts.shape[0], 1 << max(10, (d - 1).bit_length()))
    keys = np.stack([np.asarray(w[:cap])[:d] for w in state_words], axis=1)
    counts = np.asarray(state_counts[:cap])[:d].astype(np.int64)
    return keys, counts


# ---------------------------------------------------------------------------
# Wire-compressed drain (W <= 2): the drain readback dominates slow-link
# end-to-end once merging is device-resident, and sorted keys compress
# trivially — a table of d distinct keys over a 2^b keyspace has mean
# gap 2^b/d (2^43/15.3 M ≈ 586 k ≈ 2^19 at the 1 M-read scale run),
# and counts almost always fit 8 bits.  TIERED formats, chosen by the
# measured escape counts so every table density gets the narrowest
# wire whose escape patch fits:
#   u24 — three u8 delta planes + u8 count (4 B/row): dense tables
#         (mean gap < ~2^24, i.e. d >~ keyspace/2^24).
#   u32 — one u32 delta plane + u8 count (5 B/row): sparse tables
#         whose gaps exceed 24 bits but fit 32.
#   raw — 4(W+1) B/row fetch_state fallback: pathological tables
#         (both patches overflow).
# The fixed-size escape patch carries the FULL (delta_hi, delta_lo,
# count) for rows whose delta exceeds the plane width or whose count
# exceeds 255 (first row included: its "delta" is the key itself).
# Compression is a fast path, never a correctness dependence.

WIRE_PATCH_ROWS = 65536


def _wire_deltas(state_words, state_counts, rows: int):
    W = len(state_words)
    c = state_counts[:rows]
    if W == 1:
        hi = jnp.zeros((rows,), jnp.uint32)
        lo = state_words[0][:rows]
    else:
        hi, lo = state_words[0][:rows], state_words[1][:rows]
    zero = jnp.zeros((1,), jnp.uint32)
    prev_hi = jnp.concatenate([zero, hi[:-1]])
    prev_lo = jnp.concatenate([zero, lo[:-1]])
    borrow = (lo < prev_lo).astype(jnp.uint32)
    dl = lo - prev_lo
    dh = hi - prev_hi - borrow
    return dl, dh, c


def _wire_patch(esc, dh, dl, c, rows: int):
    idx = jnp.arange(rows, dtype=jnp.uint32)
    key = jnp.where(esc, idx, jnp.uint32(0xFFFFFFFF))
    sk, sdh, sdl, sc = lax.sort([key, dh, dl, c.astype(jnp.uint32)],
                                num_keys=1)
    P = WIRE_PATCH_ROWS
    return jnp.stack([sk[:P], sdh[:P], sdl[:P], sc[:P]], axis=1)


@partial(jax.jit, static_argnames=("rows",))
def wire_encode(state_words, state_counts, rows: int):
    """u24 encode of the first `rows` live rows: returns (d0, d1, d2
    (rows,) u8 delta bytes LE, count8 (rows,) u8, patch (P, 4) u32,
    n_escapes_u24, n_escapes_u32).  patch rows are (idx, delta_hi,
    delta_lo, count) for u24-escaped rows, compacted to the front,
    idx == 0xFFFFFFFF beyond n_escapes_u24.  The second count lets the
    host fall back to the u32 format without a second device pass of
    scalars.  Only W <= 2 states; dead rows (count 0) never escape."""
    assert len(state_words) <= 2, len(state_words)
    dl, dh, c = _wire_deltas(state_words, state_counts, rows)
    live = c > 0
    esc32 = live & ((dh != 0) | (c > 255))
    esc = esc32 | (live & (dl >= (1 << 24)))
    cnt8 = jnp.minimum(c, 255).astype(jnp.uint8)
    d0 = (dl & 0xFF).astype(jnp.uint8)
    d1 = ((dl >> 8) & 0xFF).astype(jnp.uint8)
    d2 = ((dl >> 16) & 0xFF).astype(jnp.uint8)
    patch = _wire_patch(esc, dh, dl, c, rows)
    return (d0, d1, d2, cnt8, patch,
            jnp.sum(esc.astype(jnp.int32)),
            jnp.sum(esc32.astype(jnp.int32)))


@partial(jax.jit, static_argnames=("rows",))
def wire_encode32(state_words, state_counts, rows: int):
    """u32 encode (sparse-table tier): returns (delta (rows,) u32,
    count8 (rows,) u8, patch (P, 4) u32, n_escapes) — escapes only for
    high-word deltas or counts > 255."""
    assert len(state_words) <= 2, len(state_words)
    dl, dh, c = _wire_deltas(state_words, state_counts, rows)
    live = c > 0
    esc = live & ((dh != 0) | (c > 255))
    cnt8 = jnp.minimum(c, 255).astype(jnp.uint8)
    patch = _wire_patch(esc, dh, dl, c, rows)
    return dl, cnt8, patch, jnp.sum(esc.astype(jnp.int32))


def _apply_patch(dl, counts, patch, n_esc: int, d: int):
    """Overwrite escaped rows with the full (delta, count) from the
    patch (pow2-bucketed fetch: transfer scales with the escape count
    and at most ~log2 slice shapes ever compile)."""
    cap = min(WIRE_PATCH_ROWS, 1 << max(8, (n_esc - 1).bit_length()))
    p = np.asarray(patch[:cap])[:n_esc]
    pidx = p[:, 0].astype(np.int64)
    sel = pidx < d                # escapes beyond d live in dead space
    pidx = pidx[sel]
    dl[pidx] = (p[sel, 1].astype(np.uint64) << np.uint64(32)) \
        | p[sel, 2].astype(np.uint64)
    counts[pidx] = p[sel, 3].astype(np.int64)


@partial(jax.jit, static_argnames=("rows",))
def wire_encode_c8(state_counts, rows: int):
    """Count-only encode for WIDE keys (W > 2, k >= 33): the key
    planes are ~incompressible (mean gap 2^(2k+1)/d dwarfs any delta
    width), but counts still fit u8 almost always.  Returns (count8
    (rows,) u8, patch (P, 2) u32 of (idx, count) escapes, n_esc)."""
    c = state_counts[:rows]
    esc = c > 255
    cnt8 = jnp.minimum(c, 255).astype(jnp.uint8)
    idx = jnp.arange(rows, dtype=jnp.uint32)
    key = jnp.where(esc, idx, jnp.uint32(0xFFFFFFFF))
    sk, sc = lax.sort([key, c.astype(jnp.uint32)], num_keys=1)
    P = WIRE_PATCH_ROWS
    return (jnp.stack([sk[:P], sc[:P]], axis=1), cnt8,
            jnp.sum(esc.astype(jnp.int32)))


def _fetch_wide_c8(state_words, state_counts, d: int, rows: int):
    """W > 2 fetch: raw key planes + u8 counts with an escape patch —
    4W+1 B/row instead of 4W+4 (~19% at W=3).  None on patch
    overflow."""
    patch, cnt8, n_esc = wire_encode_c8(state_counts, rows)
    n_esc = int(n_esc)
    if n_esc > WIRE_PATCH_ROWS:
        return None
    counts = np.asarray(cnt8)[:d].astype(np.int64)
    if n_esc:
        cap = min(WIRE_PATCH_ROWS, 1 << max(8, (n_esc - 1).bit_length()))
        p = np.asarray(patch[:cap])[:n_esc]
        pidx = p[:, 0].astype(np.int64)
        sel = pidx < d
        counts[pidx[sel]] = p[sel, 1].astype(np.int64)
    keys = np.stack([np.asarray(w[:rows])[:d] for w in state_words],
                    axis=1)
    return keys, counts


def fetch_state_wire(state_words, state_counts, distinct: int):
    """Wire-compressed host fetch: same result as fetch_state at
    ~4 B/row (u24 tier, W <= 2), ~5 B/row (u32 tier, W <= 2), or
    4W+1 B/row (wide keys: raw planes + u8 counts).  Returns None when
    every applicable tier's escape patch overflows (caller uses
    fetch_state)."""
    d = int(distinct)
    W = len(state_words)
    if d == 0:
        return fetch_state(state_words, state_counts, 0)
    if W > 2:
        rows = min(state_counts.shape[0],
                   1 << max(10, (d - 1).bit_length()))
        return _fetch_wide_c8(state_words, state_counts, d, rows)
    rows = min(state_counts.shape[0],
               1 << max(10, (d - 1).bit_length()))
    d0, d1, d2, cnt8, patch, n24, n32 = wire_encode(
        state_words, state_counts, rows)
    n24 = int(n24)
    if n24 <= WIRE_PATCH_ROWS:
        dl = np.asarray(d0)[:d].astype(np.uint64)
        dl |= np.asarray(d1)[:d].astype(np.uint64) << np.uint64(8)
        dl |= np.asarray(d2)[:d].astype(np.uint64) << np.uint64(16)
        counts = np.asarray(cnt8)[:d].astype(np.int64)
        if n24:
            _apply_patch(dl, counts, patch, n24, d)
    elif int(n32) <= WIRE_PATCH_ROWS:
        dl32, cnt8, patch, n_esc = wire_encode32(
            state_words, state_counts, rows)
        dl = np.asarray(dl32)[:d].astype(np.uint64)
        counts = np.asarray(cnt8)[:d].astype(np.int64)
        n_esc = int(n_esc)
        if n_esc:
            _apply_patch(dl, counts, patch, n_esc, d)
    else:
        return None
    keys64 = np.cumsum(dl, dtype=np.uint64)
    if W == 1:
        keys = keys64.astype(np.uint32).reshape(-1, 1)
    else:
        keys = np.empty((d, 2), np.uint32)
        keys[:, 0] = (keys64 >> np.uint64(32)).astype(np.uint32)
        keys[:, 1] = keys64.astype(np.uint32)
    return keys, counts
