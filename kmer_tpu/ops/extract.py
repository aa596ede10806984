"""Vectorized rolling-window k-mer extraction (jnp).

Replaces the reference's per-window string slicing + allocation hot loop
(k-mer-count/src/main.rs:63-81: 3.55M iterations, two UTF-8 checks and a
heap alloc each) with a static-shape slice-sum: the key contribution of
base offset j within the window is a single shifted slice of the code
matrix, so a k-mer key is built from k shift-or ops over (B, P) lanes
that XLA fuses into one elementwise pass — no gather, no per-window
work.

All shapes are static (XLA requirement): a read batch is a (B, L) uint8
code matrix plus a length vector; lanes whose window overruns the read
carry the all-ones sentinel key and sort to the end (the reference's
`r_end > len` break, main.rs:73-75, becomes a validity mask).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from .encode import words_per_key

SENTINEL = jnp.uint32(0xFFFFFFFF)


def _apply_sentinel(words: list[jnp.ndarray], valid: jnp.ndarray) -> list[jnp.ndarray]:
    return [jnp.where(valid, w, SENTINEL) for w in words]


def _valid_mask(B, P, lengths, span, limits):
    pos = lax.broadcasted_iota(jnp.int32, (B, P), 1)
    valid = pos <= (lengths.astype(jnp.int32)[:, None] - span)
    if limits is not None:
        valid = valid & (pos < limits.astype(jnp.int32)[:, None])
    return valid


def kmer_lanes(codes: jnp.ndarray, lengths: jnp.ndarray, k: int,
               *, limits: jnp.ndarray | None = None, sentinel: bool = True,
               mask_ambiguous: bool = False):
    """All k-mer keys of every read in a batch.

    Args:
      codes:   (B, L) uint8 2-bit base codes, rows padded past `lengths`.
      lengths: (B,) int32 true read lengths.
      k:       k-mer size (static).
      limits:  optional (B,) int32 — row owns only window starts o <
               limits[b] (segment-seam ownership, io.fasta.segment_records).
      mask_ambiguous: treat codes >= 4 (encode.AMBIG_CODE, i.e. N/IUPAC
               bases in skip-invalid mode) as window poison — any window
               containing one is masked out.

    Returns:
      words: list of W uint32 arrays, each (B, P) with P = L-k+1,
             most-significant word first; invalid lanes = sentinel.
      valid: (B, P) bool — lane p of row b is a real owned k-mer.
    """
    B, L = codes.shape
    assert L >= k, f"batch width {L} < k={k}"
    P = L - k + 1
    W = words_per_key(k)
    c32 = codes.astype(jnp.uint32)
    words = [jnp.zeros((B, P), dtype=jnp.uint32) for _ in range(W)]
    amb = jnp.zeros((B, P), bool) if mask_ambiguous else None
    for j in range(k):
        bitpos = 2 * (k - 1 - j)
        wi = W - 1 - bitpos // 32
        sh = bitpos % 32
        sl = lax.dynamic_slice_in_dim(c32, j, P, axis=1)
        words[wi] = words[wi] | ((sl & jnp.uint32(3)) << jnp.uint32(sh))
        if mask_ambiguous:
            amb = amb | (sl >= 4)
    valid = _valid_mask(B, P, lengths, k, limits)
    if mask_ambiguous:
        valid = valid & ~amb
    if sentinel:
        words = _apply_sentinel(words, valid)
    return words, valid


def parse_seed_mask(mask: str) -> tuple[int, ...]:
    """Validate a spaced-seed mask string ('1'=match, '0'=don't-care)
    and return the tuple of match offsets.  Must start and end with
    '1' (leading/trailing don't-cares would just shift windows)."""
    if not mask or set(mask) - {"0", "1"}:
        raise ValueError(f"seed mask must be nonempty 0/1, got {mask!r}")
    if mask[0] != "1" or mask[-1] != "1":
        raise ValueError("seed mask must start and end with '1'")
    return tuple(i for i, ch in enumerate(mask) if ch == "1")


def mask_from_positions(positions) -> str:
    """Inverse of parse_seed_mask (span = positions[-1] + 1)."""
    span = positions[-1] + 1
    sel = set(positions)
    return "".join("1" if j in sel else "0" for j in range(span))


def seed_mask_palindromic(mask: str) -> bool:
    """Canonical (strand-min) spaced keys are well-defined only when
    the mask equals its reverse: the reverse complement of a window
    then selects the same positions."""
    return mask == mask[::-1]


def spaced_lanes(codes: jnp.ndarray, lengths: jnp.ndarray, mask: str,
                 *, limits: jnp.ndarray | None = None,
                 sentinel: bool = True, mask_ambiguous: bool = False,
                 canonical: bool = False):
    """All SPACED-SEED keys of every read: per window of span
    len(mask), the key is the concatenation of the bases at the
    mask's '1' offsets (n_bases = popcount) — the standard spaced-seed
    semantics (cf. PatternHunter / spaced-seed counters).  Don't-care
    positions are ignored entirely, including for ambiguity masking.

    Same contract as kmer_lanes; P = L - span + 1.  canonical=True
    requires a palindromic mask (seed_mask_palindromic)."""
    positions = parse_seed_mask(mask)
    span, kk = len(mask), len(positions)
    if canonical and not seed_mask_palindromic(mask):
        raise ValueError("canonical spaced seeds need a palindromic "
                         f"mask, got {mask!r}")
    B, L = codes.shape
    assert L >= span, f"batch width {L} < seed span {span}"
    P = L - span + 1
    W = words_per_key(kk)
    c32 = codes.astype(jnp.uint32)
    words = [jnp.zeros((B, P), dtype=jnp.uint32) for _ in range(W)]
    rwords = ([jnp.zeros((B, P), dtype=jnp.uint32) for _ in range(W)]
              if canonical else None)
    amb = jnp.zeros((B, P), bool) if mask_ambiguous else None
    for i, j in enumerate(positions):
        sl = lax.dynamic_slice_in_dim(c32, j, P, axis=1)
        if mask_ambiguous:
            amb = amb | (sl >= 4)
            sl = sl & jnp.uint32(3)
        bitpos = 2 * (kk - 1 - i)
        wi = W - 1 - bitpos // 32
        words[wi] = words[wi] | (sl << jnp.uint32(bitpos % 32))
        if canonical:
            # reverse complement selects the mirrored offsets, which a
            # palindromic mask maps back onto `positions`: base at
            # selected index i lands at rc index kk-1-i, complemented
            rbit = 2 * i
            rwi = W - 1 - rbit // 32
            rwords[rwi] = rwords[rwi] | ((sl ^ jnp.uint32(3))
                                         << jnp.uint32(rbit % 32))
    if canonical:
        from .canonical import lex_min
        words = lex_min(words, rwords)
    valid = _valid_mask(B, P, lengths, span, limits)
    if mask_ambiguous:
        valid = valid & ~amb
    if sentinel:
        words = _apply_sentinel(words, valid)
    return words, valid


def rc_kmer_lanes(codes: jnp.ndarray, lengths: jnp.ndarray, k: int,
                  *, limits: jnp.ndarray | None = None, sentinel: bool = True,
                  mask_ambiguous: bool = False):
    """Reverse-complement k-mer keys for every lane of `kmer_lanes`.

    The RC of window [p, p+k) read 5'→3' on the other strand puts base
    p+j (complemented) at RC position k-1-j, i.e. at bit position 2j —
    so the RC key is the same slice-sum with complement codes (3-c) and
    mirrored shifts.  No reversal gather needed.
    """
    B, L = codes.shape
    P = L - k + 1
    W = words_per_key(k)
    c32 = codes.astype(jnp.uint32)
    words = [jnp.zeros((B, P), dtype=jnp.uint32) for _ in range(W)]
    amb = jnp.zeros((B, P), bool) if mask_ambiguous else None
    for j in range(k):
        bitpos = 2 * j
        wi = W - 1 - bitpos // 32
        sh = bitpos % 32
        sl = lax.dynamic_slice_in_dim(c32, j, P, axis=1)
        words[wi] = words[wi] | ((jnp.uint32(3) - (sl & jnp.uint32(3)))
                                << jnp.uint32(sh))
        if mask_ambiguous:
            amb = amb | (sl >= 4)
    valid = _valid_mask(B, P, lengths, k, limits)
    if mask_ambiguous:
        valid = valid & ~amb
    if sentinel:
        words = _apply_sentinel(words, valid)
    return words, valid


# ---------------------------------------------------------------------------
# Reference-parity gapped L+R extraction.
#
# The reference emits, for every read, every chunk size c in [c_min, c_max]
# and every window offset o with o + c <= len, the 54-mer
#     seq[o : o+27] ++ seq[o+c-27 : o+c]
# (main.rs:63-79 / test.py:22-38).  Formulation: the L part is
# the 27-mer key at position o and the R part is the 27-mer key at
# position o+c-27, so we compute ALL 27-mer keys once (one slice-sum) and
# the gapped key is two gathers + a word-level shift-or combine — the
# 61-chunk-size sweep shares one K27 table instead of re-slicing strings.
# ---------------------------------------------------------------------------

GAP_L = 27           # main.rs:48
GAP_R = 27           # main.rs:49
GAP_C_MIN = 80       # main.rs:63
GAP_C_MAX = 140      # main.rs:63 (`80..141`)


def _extract32(S: list[jnp.ndarray], p: int) -> jnp.ndarray:
    """Bits [p, p+32) of the multi-word big integer S (MS word first),
    for static p (negative p = the value shifted left by -p)."""
    Ws = len(S)
    if p <= -32:
        return jnp.zeros_like(S[0])
    if p < 0:
        return S[Ws - 1] << jnp.uint32(-p)
    q, sh = divmod(p, 32)
    lo = Ws - 1 - q
    if lo < 0:
        return jnp.zeros_like(S[0])
    w = S[lo] >> jnp.uint32(sh) if sh else S[lo]
    if sh and lo - 1 >= 0:
        w = w | (S[lo - 1] << jnp.uint32(32 - sh))
    return w


def _combine_lr(l_words: list[jnp.ndarray], r_words: list[jnp.ndarray],
                l_len: int, r_len: int) -> list[jnp.ndarray]:
    """value = L * 4^r_len + R as words_per_key(l_len+r_len) words."""
    W = words_per_key(l_len + r_len)
    out = []
    for wo in range(W):
        p = 32 * (W - 1 - wo)
        out.append(_extract32(r_words, p) |
                   _extract32(l_words, p - 2 * r_len))
    return out


def gapped_lanes(codes: jnp.ndarray, lengths: jnp.ndarray,
                 l_len: int = GAP_L, r_len: int = GAP_R,
                 c_min: int = GAP_C_MIN, c_max: int = GAP_C_MAX,
                 *, limits: jnp.ndarray | None = None,
                 mask_ambiguous: bool = False):
    """All gapped L+R chunk keys of a batch, reference semantics.

    Returns:
      words: list of W uint32 arrays (B, T) — 2(l_len+r_len)-bit keys,
             MSW first.  T = sum over chunk sizes c of the EXACT offset
             count L−c+1 (c-major), so no lane is wasted on the
             chunk-size triangle (a rectangular (C, O) layout would pad
             ~58 % dead lanes at the reference geometry on 150 bp
             reads, all of which the sort would still have to carry).
             Invalid (o + c > len) lanes = sentinel.
      valid: (B, T) bool.
    """
    assert l_len >= 1 and r_len >= 1
    assert c_min >= l_len + r_len, "L and R windows must not overlap"
    B, L = codes.shape
    n_c = c_max - c_min + 1
    O = max(L - c_min + 1, 0)
    W = words_per_key(l_len + r_len)
    if O == 0 or L < max(l_len, r_len):
        words = [jnp.full((B, n_c * max(O, 0)), SENTINEL, jnp.uint32)
                 for _ in range(W)]
        return words, jnp.zeros((B, n_c * max(O, 0)), bool)

    # Sub-key tables: the l_len-mer key at every position (and the
    # r_len-mer table, shared when l == r).  sentinel=False — validity
    # of a gapped lane is decided by its own mask below; the ambiguity
    # masks of both windows feed into it.
    lw, lval = kmer_lanes(codes, lengths, l_len, sentinel=False,
                          mask_ambiguous=mask_ambiguous)
    if r_len == l_len:
        rw, rval = lw, lval
    else:
        rw, rval = kmer_lanes(codes, lengths, r_len, sentinel=False,
                              mask_ambiguous=mask_ambiguous)

    lens32 = lengths.astype(jnp.int32)[:, None]
    lims32 = limits.astype(jnp.int32)[:, None] if limits is not None else None
    # No gather anywhere — every window is a static slice:
    #   L window at (c, o) is index o — independent of c: a slice;
    #   R window at (c, o) is index o + (c - r_len) — for each of the C
    #   static chunk sizes, a contiguous static slice of the r-table of
    #   EXACT width O_c = L - c + 1 (its end lands precisely at the
    #   r-table's last entry).
    val_parts, l_parts, r_parts = [], [], []
    for c in range(c_min, c_max + 1):
        O_c = L - c + 1
        if O_c <= 0:
            continue
        o_vals = jnp.arange(O_c, dtype=jnp.int32)[None, :]
        v = (o_vals + c) <= lens32
        if lims32 is not None:
            v = v & (o_vals < lims32)
        if mask_ambiguous:
            v = (v & lval[:, :O_c]
                 & lax.slice_in_dim(rval, c - r_len, c - r_len + O_c,
                                    axis=1))
        val_parts.append(v)
        l_parts.append([lax.slice_in_dim(w, 0, O_c, axis=1) for w in lw])
        r_parts.append([lax.slice_in_dim(w, c - r_len, c - r_len + O_c,
                                         axis=1) for w in rw])
    valid = jnp.concatenate(val_parts, axis=1)
    l_g = [jnp.concatenate([p[j] for p in l_parts], axis=1)
           for j in range(len(lw))]
    r_g = [jnp.concatenate([p[j] for p in r_parts], axis=1)
           for j in range(len(rw))]
    words = _combine_lr(l_g, r_g, l_len, r_len)
    words = _apply_sentinel(words, valid)
    return words, valid
