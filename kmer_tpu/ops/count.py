"""Device-side counting: sort + segment-sum, and dense 4^k histogram.

The reference materializes 3.55M heap strings and comparison-sorts them
(main.rs:50,87).  Here keys are fixed-width uint32 word tuples; counting
is either:

  * sort mode (any k): multi-key sort (lexicographic over W words; the
    all-ones sentinel of invalid lanes sorts to the end), then run
    boundaries + segment-sum give (unique key, multiplicity) entirely on
    device with static shapes;
  * dense mode (k <= 12): a 4^k int32 scatter-add histogram — one HBM
    table, no sort at all.

Both paths are jit-compiled; host code only compacts static-shape
outputs (drop sentinel runs) after the fact.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from .encode import words_per_key
from .extract import SENTINEL

DENSE_K_MAX = 12


def sort_words(words: list[jnp.ndarray]) -> list[jnp.ndarray]:
    """Lexicographic sort of flattened W-word keys (duplicates kept)."""
    flat = tuple(w.reshape(-1) for w in words)
    return list(lax.sort(flat, num_keys=len(flat)))


def repack_words(words: list[jnp.ndarray], valid: jnp.ndarray, n_bases: int
                 ) -> tuple[list[jnp.ndarray], int]:
    """Repack std-layout key words into the sort-optimal layout.

    Std layout (ops/encode.py): W words MS-first, the top word holds
    only s = 2*n_bases - 32*(W-1) used bits.  Sort-optimal layout packs
    32 key bits into each of words 0..W-2 and the s residual bits into
    the LAST word — so a lexicographic sort needs only num_keys = W-1
    comparator words, with the residual riding along as payload.  Ties
    in the first W-1 words may leave equal keys non-adjacent, which the
    counting contract absorbs (partial aggregation; host from_pairs).

    The last word doubles as the validity channel: real lanes hold
    values < 2^s < SENTINEL, invalid lanes hold SENTINEL — so repacked
    keys never collide with the sentinel (fixing, where it applies, the
    std-layout corner where the all-T key IS the sentinel pattern).

    Returns (repacked_words, num_keys).  Identity (words, 1) when
    W == 1 (k <= 15: word 0 has <= 30 used bits, sentinel-safe as is).
    When 2*n_bases is a multiple of 32 (k = 16, 32, ...) the std top
    word carries no key bits (only the sentinel bit, words_per_key) —
    it is dropped and replaced by a trailing 0/SENTINEL flag payload.
    """
    W = len(words)
    bits = 2 * n_bases
    s = bits - 32 * (W - 1)
    assert 0 <= s < 32, (n_bases, W, s)   # words_per_key reserves a bit
    if W == 1:
        return words, 1
    if s == 0:
        flag = jnp.where(valid, jnp.uint32(0), SENTINEL)
        return list(words[1:]) + [flag], W - 1
    t = 32 - s
    out = []
    for j in range(W - 1):
        out.append((words[j] << jnp.uint32(t)) | (words[j + 1] >> jnp.uint32(s)))
    last = words[W - 1] & jnp.uint32((1 << s) - 1)
    out.append(jnp.where(valid, last, SENTINEL))
    return out, W - 1


def unpack_words(rwords: list[jnp.ndarray], n_bases: int) -> list[jnp.ndarray]:
    """Inverse of repack_words (sentinel lanes map back to all-SENTINEL)."""
    W = len(rwords)
    bits = 2 * n_bases
    s = bits - 32 * (W - 1)
    if W == 1:
        return rwords
    if s == 0:
        # rwords = key words + flag payload; std w0 is the flag itself
        # (0 for real lanes, SENTINEL for invalid — invalid key words
        # are already all-SENTINEL)
        return [rwords[-1]] + list(rwords[:-1])
    t = 32 - s
    valid = rwords[-1] != SENTINEL
    last = jnp.where(valid, rwords[-1], 0)
    out = [rwords[0] >> jnp.uint32(t)]
    for j in range(1, W - 1):
        out.append((rwords[j - 1] << jnp.uint32(s)) | (rwords[j] >> jnp.uint32(t)))
    out.append((rwords[W - 2] << jnp.uint32(s)) | last)
    return [jnp.where(valid, w, SENTINEL) for w in out]


def run_lengths_grouped(sorted_2d: list[jnp.ndarray], *,
                        valid_word: int = 0):
    """run_lengths over (G, m) group-locally sorted words: scans run
    along axis 1 (depth m instead of n), runs never span groups.
    Returns flat (G*m,) is_start / counts.

    valid_word: index of a word whose real values never reach SENTINEL
    (std layout: word 0, which holds <= 31 used bits by words_per_key's
    reserved sentinel bit; repacked layout: word -1).  Lanes whose
    valid_word == SENTINEL count 0.
    """
    G, m = sorted_2d[0].shape
    neq = jnp.zeros((G, m), bool).at[:, 0].set(True)
    for w in sorted_2d:
        neq = neq | (jnp.roll(w, 1, axis=1) != w).at[:, 0].set(True)
    is_start = neq
    idx = lax.broadcasted_iota(jnp.int32, (G, m), 1)
    start_pos = jnp.where(is_start, idx, m)
    suffix_min = lax.cummin(start_pos, axis=1, reverse=True)
    next_start = jnp.concatenate(
        [suffix_min[:, 1:], jnp.full((G, 1), m, jnp.int32)], axis=1)
    run_len = next_start - idx
    valid = sorted_2d[valid_word] != SENTINEL
    counts = jnp.where(is_start & valid, run_len, 0)
    return is_start.reshape(-1), counts.reshape(-1)


def run_lengths(sorted_words: list[jnp.ndarray]):
    """Run boundaries + multiplicities of a sorted key stream.

    Returns (is_start, counts) both shape (N,):
      is_start[i] — lane i begins a run of equal keys;
      counts[i]   — multiplicity of that run if is_start[i], else 0.
    Sentinel lanes (invalid) are excluded from counts but may still set
    is_start at the sentinel run head (count 0, dropped on compaction).

    Scan-based, scatter-free: a run's length is the distance to the next
    run start, found with one reverse cummin — runs of equal keys are
    homogeneous (all real or all sentinel), so no per-lane validity sum
    is needed.
    """
    n = sorted_words[0].shape[0]
    neq = jnp.zeros((n,), bool).at[0].set(True)
    for w in sorted_words:
        neq = neq | (jnp.roll(w, 1) != w).at[0].set(True)
    is_start = neq
    idx = jnp.arange(n, dtype=jnp.int32)
    start_pos = jnp.where(is_start, idx, n)
    suffix_min = lax.cummin(start_pos, axis=0, reverse=True)
    next_start = jnp.concatenate(
        [suffix_min[1:], jnp.full((1,), n, jnp.int32)])
    valid = sorted_words[0] != SENTINEL
    counts = jnp.where(is_start & valid, next_start - idx, 0)
    return is_start, counts


def grouped_count(words: list[jnp.ndarray], valid: jnp.ndarray,
                  n_bases: int, group_keys: int):
    """The sort-mode count step core: repacked grouped sort +
    run-length, with sentinel padding so any group size works.

    words/valid: extractor outputs (std layout, any shape).  The flat
    key stream is padded with sentinel lanes to a multiple of
    group_keys, reshaped (G, m=group_keys), sorted within groups with
    the minimum comparator width (repack_words), and run-length
    encoded.  Output keys are converted back to std layout.

    Returns (sorted_words_flat_std, is_start, counts) of padded flat
    size; equal keys may span groups/ties — callers aggregate with
    KmerTable.from_pairs (partial-aggregation contract).
    """
    rwords, _nk = repack_words([w.reshape(-1) for w in words],
                               valid.reshape(-1), n_bases)
    s_flat, counts = _sorted_grouped_runs(rwords, group_keys)
    std = unpack_words(s_flat, n_bases)
    return std, counts > 0, counts


def _sorted_grouped_runs(rwords: list[jnp.ndarray], group_keys: int):
    """Shared core: pad -> grouped sort -> run-length over repacked
    words.  Returns (flat_sorted_rwords, counts) of padded flat size.

    Sorting independent group_keys-sized slices (lax.sort over a batch
    dimension) instead of the whole stream leaves the output only
    group-locally sorted; equal keys may repeat across groups, which
    the host aggregation absorbs.  run_lengths_grouped stays correct:
    runs never span groups, and sentinel tails sort to each group's
    end."""
    flat = [w.reshape(-1) for w in rwords]
    n = flat[0].shape[0]
    m = max(min(group_keys, n), 1)
    nk = max(len(flat) - 1, 1)
    pad = (-n) % m
    if pad:
        flat = [jnp.concatenate([w, jnp.full((pad,), SENTINEL, w.dtype)])
                for w in flat]
    G = (n + pad) // m
    shaped = tuple(w.reshape(G, m) for w in flat)
    s2d = list(lax.sort(shaped, num_keys=nk, dimension=1))
    _, counts = run_lengths_grouped(s2d, valid_word=-1)
    return [w.reshape(-1) for w in s2d], counts


def grouped_count_compact(words: list[jnp.ndarray], valid: jnp.ndarray,
                          n_bases: int, group_keys: int, *,
                          part_keys: int = 2048):
    """Grouped count + ON-DEVICE COMPACTION: returns (row_blocks,
    total_rows) — 128-lane rows of packed (repacked key words..., count)
    records, all of this batch's distinct entries in rows
    [0, total_rows) (plus < one row of dead count==0 records per coarse
    group, dropped by the host filter;
    pipeline.table.KmerTable.from_compact decodes).  D2H then scales
    with DISTINCT k-mers: the host fetches only the live rows, not the
    full static key stream.

    Pipeline: repack -> grouped sort + run-length (the count core) ->
    compact_from_runs.  Record width adapts to the key size
    (record_width: 4 uint32 fields for W <= 3, 8 up to W = 7 — which
    covers the gapped 54-base chunks, W = 4).
    """
    W = words_per_key(n_bases)
    assert W <= 7, "compaction record width caps at 8 fields (W <= 7)"
    rwords, _nk = repack_words([w.reshape(-1) for w in words],
                               valid.reshape(-1), n_bases)
    s_flat, counts = _sorted_grouped_runs(rwords, group_keys)
    return compact_from_runs(s_flat, counts, part_keys=part_keys)


def record_width(n_fields: int) -> int:
    """Fields per packed compaction record: power of two >= n_fields,
    min 4 (the count rides as the LAST live field; the rest is zero
    padding), so every 128-lane row holds a whole number of records."""
    assert 1 <= n_fields <= 128, n_fields
    return max(4, 1 << (n_fields - 1).bit_length())


def pack_groups(fields: list[jnp.ndarray], d: jnp.ndarray):
    """Concatenate per-group live record prefixes into contiguous rows.

    fields: list of (G, m) uint32 record fields (key words then the
    count, live records first per group); d: (G,) int32 live counts.
    Returns (out, total_rows): out (G*m/rpr + m/rpr, 128) uint32 whose
    first total_rows rows hold all live records (plus < rpr dead
    count==0 records per group), with rpr = 128 // record_width and
    total_rows = sum(ceil(d/rpr)).  Output row j is a gather from the
    group that owns it (searchsorted over the groups' row offsets)."""
    G, m = fields[0].shape
    rec_w = record_width(len(fields))
    rpr = 128 // rec_w
    assert m % rpr == 0, (m, rpr)
    cols = list(fields) + [jnp.zeros_like(fields[0])] * (rec_w - len(fields))
    rg = m // rpr
    rows = jnp.stack(cols, axis=-1).reshape(G, rg, 128)
    dr = -(-d // rpr)
    base = (jnp.cumsum(dr) - dr).astype(jnp.int32)
    total = dr.sum().astype(jnp.int32)
    j = jnp.arange(G * rg + rg, dtype=jnp.int32)
    g = jnp.clip(jnp.searchsorted(base + dr, j, side="right"), 0, G - 1)
    r = j - base[g]
    live = j < total
    out = jnp.where(live[:, None], rows[g, jnp.clip(r, 0, rg - 1)], 0)
    return out, total


def compact_from_runs(s_flat: list[jnp.ndarray], counts: jnp.ndarray, *,
                      part_keys: int = 2048):
    """Compaction back half over an already grouped-counted repacked run
    stream (flat sorted words + run counts): a part_keys-grouped
    single-key partition sort moves live entries to each coarse group's
    front, then pack_groups concatenates the prefixes.  Returns
    (row_blocks, total_rows) as grouped_count_compact."""
    n = s_flat[0].shape[0]
    m2 = part_keys
    pad = (-n) % m2
    if pad:
        s_flat = [jnp.concatenate([w, jnp.full((pad,), SENTINEL, w.dtype)])
                  for w in s_flat]
        counts = jnp.concatenate([counts, jnp.zeros((pad,), counts.dtype)])
    G2 = (n + pad) // m2
    nw = len(s_flat)
    live = counts > 0
    inv = (~live).astype(jnp.uint32)
    operands = [inv.reshape(G2, m2)]
    operands += [w.reshape(G2, m2) for w in s_flat]
    operands.append(counts.astype(jnp.uint32).reshape(G2, m2))
    part = lax.sort(tuple(operands), num_keys=1, dimension=1)
    d = jnp.sum(live.reshape(G2, m2), axis=1, dtype=jnp.int32)
    fields = list(part[1:1 + nw]) + [part[-1]]
    return pack_groups(fields, d)


def sort_count(words: list[jnp.ndarray]):
    """sorted keys + run info; the core device count step (sort mode)."""
    s = sort_words(words)
    is_start, counts = run_lengths(s)
    return s, is_start, counts


def index_histogram(idx: jnp.ndarray, valid: jnp.ndarray, n_bins: int,
                    hist: jnp.ndarray | None = None) -> jnp.ndarray:
    """(n_bins,) int32 histogram of `idx` (any shape) over valid lanes,
    accumulated into `hist` when given — one scatter-add (atomics on a
    GPU).  Invalid lanes add 0."""
    flat = jnp.where(valid, idx, 0).astype(jnp.int32).reshape(-1)
    upd = valid.astype(jnp.int32).reshape(-1)
    if hist is None:
        hist = jnp.zeros((n_bins,), jnp.int32)
    return hist.at[flat].add(upd, mode="drop")


def dense_histogram(word: jnp.ndarray, valid: jnp.ndarray, k: int,
                    hist: jnp.ndarray | None = None) -> jnp.ndarray:
    """Counts into a dense 4^k table (k <= DENSE_K_MAX).

    `word` is the single-word key (B, P) or flat; invalid lanes add 0.
    Pass `hist` to accumulate across batches (donate it under jit).
    """
    assert k <= DENSE_K_MAX, f"dense mode needs k <= {DENSE_K_MAX}"
    return index_histogram(word, valid, 4 ** k, hist)
