"""Pure-Python/NumPy differential oracles (no JAX).

The reference's only test methodology is differential: test.py is an
independent reimplementation diffed against the Rust binary (test.py:14-40
vs main.rs:43-92).  We adopt that as a first-class subsystem: every
device path has a tiny, obviously-correct host oracle here, and the test
suite asserts exact agreement (SURVEY.md §4).

Nothing here imports the engine's own ops: an oracle that shared the
engine's encoding or extraction code would share its bugs.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable

import numpy as np

_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def revcomp_str(seq: str) -> str:
    """Reverse complement of an ACGT string."""
    return "".join(_COMP[b] for b in reversed(seq))


def oracle_gapped_lines(seqs: Iterable[str], l_len: int = 27, r_len: int = 27,
                        c_min: int = 80, c_max: int = 140) -> list[str]:
    """Reference semantics (test.py:20-38 / main.rs:63-81): every chunk
    size c in [c_min, c_max], every offset o with o + c <= len, emit
    seq[o:o+l_len] + seq[o+c-r_len:o+c].  Unsorted; caller sorts."""
    out: list[str] = []
    for seq in seqs:
        n = len(seq)
        for c in range(c_min, c_max + 1):
            m = c - l_len - r_len
            for o in range(0, n):
                r_end = o + l_len + m + r_len
                if r_end > n:
                    break
                out.append(seq[o:o + l_len] + seq[r_end - r_len:r_end])
    return out


def oracle_gapped_sorted_dump(seqs: Iterable[str], **kw) -> bytes:
    """Sorted, newline-terminated dump — byte-exact vs the reference's
    stdout (main.rs:87-90; md5 contract in BASELINE.md)."""
    lines = oracle_gapped_lines(seqs, **kw)
    lines.sort()
    return ("\n".join(lines) + "\n").encode() if lines else b""


def oracle_kmers(seq: str, k: int, canonical: bool = False,
                 skip_invalid: bool = False) -> list[str]:
    """All k-mers of one read (reads shorter than k emit nothing).

    skip_invalid drops any window containing a non-ACGT character
    (N/IUPAC codes) — the oracle for KmerConfig.skip_invalid."""
    out = []
    up = seq.upper()
    for i in range(len(seq) - k + 1):
        s = up[i:i + k]
        if skip_invalid and any(b not in "ACGT" for b in s):
            continue
        if canonical:
            s = min(s, revcomp_str(s))
        out.append(s)
    return out


def oracle_spaced(seq: str, mask: str, canonical: bool = False,
                  skip_invalid: bool = False) -> list[str]:
    """Spaced-seed keys of one read: the bases at the mask's '1'
    offsets per window of span len(mask).  Canonical takes the strand
    min (palindromic masks only — the caller enforces)."""
    span = len(mask)
    pos = [i for i, ch in enumerate(mask) if ch == "1"]
    out = []
    up = seq.upper()
    for i in range(len(seq) - span + 1):
        s = "".join(up[i + j] for j in pos)
        if skip_invalid and any(b not in "ACGT" for b in s):
            continue
        if canonical:
            s = min(s, revcomp_str(s))
        out.append(s)
    return out


def oracle_spaced_count(seqs: Iterable[str], mask: str,
                        canonical: bool = False,
                        skip_invalid: bool = False) -> Counter:
    c: Counter = Counter()
    for seq in seqs:
        c.update(oracle_spaced(seq, mask, canonical, skip_invalid))
    return c


def oracle_count(seqs: Iterable[str], k: int, canonical: bool = False,
                 skip_invalid: bool = False) -> Counter:
    """(k-mer -> multiplicity) over a read set."""
    c: Counter = Counter()
    for seq in seqs:
        c.update(oracle_kmers(seq, k, canonical, skip_invalid))
    return c


def mask_low_quality(seq: str, qual: str, min_qual: int) -> str:
    """Replace bases whose Phred+33 quality is below min_qual with 'N'
    (the framework then drops windows containing them, like any
    ambiguous base).  Mirrors the native walker's in-place code-4
    masking (io/native/fasta_pack.cpp fastq_walk)."""
    if min_qual <= 0:
        return seq
    arr = np.frombuffer(seq.encode(), np.uint8).copy()
    qarr = np.frombuffer(qual.encode(), np.uint8)
    arr[qarr < 33 + min_qual] = ord("N")
    return arr.tobytes().decode()


def read_fastq_py(path: str, min_qual: int = 0) -> list[str]:
    """Minimal FASTQ reader (oracle-side): 4-line records, sequence may
    wrap; quality consumed by length ('@' is a legal quality char).
    min_qual > 0 masks low-quality bases to 'N' (mask_low_quality)."""
    seqs: list[str] = []
    with open(path, "r") as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        if not lines[i].startswith("@"):
            raise ValueError("FASTQ record must start with '@'")
        i += 1
        seq = []
        while i < len(lines) and not lines[i].startswith("+"):
            seq.append(lines[i].strip())
            i += 1
        i += 1                      # the '+' line
        s = "".join(seq)
        q: list[str] = []
        ql = 0
        while i < len(lines) and ql < len(s):
            q.append(lines[i].strip())
            ql += len(q[-1])
            i += 1
        if ql != len(s):
            raise ValueError("truncated FASTQ record")
        seqs.append(mask_low_quality(s, "".join(q), min_qual))
    return seqs


def read_fasta_py(path: str) -> list[str]:
    """Minimal host FASTA reader (oracle-side; the framework's real
    ingest is the native parser in io/fasta.py).  Mirrors Biopython
    SeqIO semantics used by test.py:7-11: '>' starts a record, sequence
    lines are concatenated."""
    seqs: list[str] = []
    cur: list[str] | None = None
    with open(path, "r") as f:
        for line in f:
            # '>' is a header marker only at COLUMN 0 (Biopython/native
            # semantics); '  >x' is sequence data and errs downstream
            if line.startswith(">"):
                if cur is not None:
                    seqs.append("".join(cur))
                cur = []
                continue
            s = "".join(line.split())    # native skips all whitespace
            if not s:
                continue
            if cur is None:
                raise ValueError("sequence data before first FASTA header")
            cur.append(s)
    if cur is not None:
        seqs.append("".join(cur))
    return seqs


def read_fastq_stream(f, min_qual: int = 0):
    """Yield sequences from an open FASTQ text stream — same semantics
    as read_fastq_py (wrapping-safe, '@'-in-quality safe) without
    materializing the file (chunked-ingest fallback path)."""
    while True:
        line = f.readline()
        if not line:
            return
        if not line.strip():
            continue
        # '@' must be at column 0 (native parser semantics; an indented
        # '@' raises, matching the native walker)
        if not line.startswith("@"):
            raise ValueError("FASTQ record must start with '@'")
        seq: list[str] = []
        while True:
            ln = f.readline()
            if not ln:
                raise ValueError("truncated FASTQ record")
            if ln.startswith("+"):
                break
            seq.append(ln.strip())
        s = "".join(seq)
        q: list[str] = []
        ql = 0
        while ql < len(s):
            ln = f.readline()
            if not ln:
                break
            q.append(ln.strip())
            ql += len(q[-1])
        if ql != len(s):
            raise ValueError("truncated FASTQ record")
        yield mask_low_quality(s, "".join(q), min_qual)


# ---------------------------------------------------------------------------
# Vectorized NumPy oracle: whole read sets at corpus scale.
# ---------------------------------------------------------------------------

# ASCII -> 2-bit code (A=0, C=1, G=2, T=3, either case); 4 = any other
# byte (ambiguous).  Code order is ASCII order, so integer key order is
# string order.
_CODE_LUT = np.full(256, 4, np.uint8)
for _i, _b in enumerate("ACGT"):
    _CODE_LUT[ord(_b)] = _i
    _CODE_LUT[ord(_b.lower())] = _i


def read_fasta_codes_np(path: str) -> tuple[np.ndarray, np.ndarray]:
    """FASTA file -> ((R, Lmax) uint8 code matrix, (R,) int64 lengths).

    Same record semantics as read_fasta_py ('>' at column 0 starts a
    record, sequence lines concatenate, whitespace is dropped); rows are
    padded past their length with code 4."""
    with open(path, "rb") as f:
        data = f.read()
    seqs: list[bytes] = []
    cur: list[bytes] | None = None
    for line in data.split(b"\n"):
        if line.startswith(b">"):
            if cur is not None:
                seqs.append(b"".join(cur))
            cur = []
            continue
        s = b"".join(line.split())
        if not s:
            continue
        if cur is None:
            raise ValueError("sequence data before first FASTA header")
        cur.append(s)
    if cur is not None:
        seqs.append(b"".join(cur))
    lengths = np.array([len(s) for s in seqs], np.int64)
    width = int(lengths.max(initial=0))
    if len(seqs) and (lengths == width).all():
        flat = np.frombuffer(b"".join(seqs), np.uint8)
        return _CODE_LUT[flat].reshape(len(seqs), width), lengths
    codes = np.full((len(seqs), width), 4, np.uint8)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = _CODE_LUT[np.frombuffer(s, np.uint8)]
    return codes, lengths


def oracle_keys_np(codes: np.ndarray, lengths: np.ndarray, k: int,
                   canonical: bool = False, skip_invalid: bool = False,
                   mask: str | None = None) -> np.ndarray:
    """(N, W) uint32 key of every counted window of a read set, in
    (read, position) order — the vectorized twin of oracle_kmers /
    oracle_spaced.

    codes: (R, L) uint8 2-bit base codes (values >= 4 are ambiguous
    bases), rows padded past `lengths`.  Keys use the engine's std
    layout: W = ceil((2n+1)/32) words, most significant first, value =
    sum_i code[i] * 4^(n-1-i) over the n key bases (first base most
    significant).  mask: a spaced seed ('1' = key base, k is then
    ignored); canonical keys take the smaller of a window and its
    reverse complement (spaced: palindromic masks only).  skip_invalid
    drops windows holding an ambiguous key base; without it such a
    window is an error, as in the engine's strict mode."""
    codes = np.asarray(codes, np.uint8)
    lengths = np.asarray(lengths, np.int64)
    if mask is not None:
        offsets = [i for i, ch in enumerate(mask) if ch == "1"]
        span = len(mask)
    else:
        offsets, span = list(range(k)), k
    n = len(offsets)
    R, L = codes.shape
    W = (2 * n + 1 + 31) // 32
    P = L - span + 1
    if P <= 0 or R == 0:
        return np.zeros((0, W), np.uint32)
    valid = np.arange(P)[None, :] <= (lengths[:, None] - span)
    amb = np.zeros((R, P), bool)
    fwd = [np.zeros((R, P), np.uint32) for _ in range(W)]
    rev = [np.zeros((R, P), np.uint32) for _ in range(W)] if canonical \
        else None
    for i, off in enumerate(offsets):
        sl = codes[:, off:off + P]
        amb |= sl >= 4
        base = (sl & 3).astype(np.uint32)
        bit = 2 * (n - 1 - i)              # first base most significant
        fwd[W - 1 - bit // 32] |= base << np.uint32(bit % 32)
        if canonical:                      # complement lands at bit 2i
            rbit = 2 * i
            rev[W - 1 - rbit // 32] |= (3 - base) << np.uint32(rbit % 32)
    if (amb & valid).any() and not skip_invalid:
        raise ValueError("ambiguous base inside a counted window "
                         "(pass skip_invalid=True to drop such windows)")
    valid &= ~amb
    words = fwd
    if canonical:
        # lexicographic fwd < rev, least significant word first
        lt = np.zeros((R, P), bool)
        for f, r in zip(reversed(fwd), reversed(rev)):
            lt = (f < r) | ((f == r) & lt)
        words = [np.where(lt, f, r) for f, r in zip(fwd, rev)]
    return np.stack([w[valid] for w in words], axis=1)


def oracle_count_np(codes: np.ndarray, lengths: np.ndarray, k: int,
                    canonical: bool = False, skip_invalid: bool = False,
                    mask: str | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(keys, counts) of a read set, vectorized: the sorted unique keys
    of oracle_keys_np as (M, W) uint32 std-layout words and their (M,)
    int64 counts — directly comparable with a KmerTable's keys/counts.
    Arguments as oracle_keys_np."""
    keys = oracle_keys_np(codes, lengths, k, canonical, skip_invalid, mask)
    W = keys.shape[1]
    if W <= 2:
        v = keys[:, -1].astype(np.uint64)
        if W == 2:
            v |= keys[:, 0].astype(np.uint64) << np.uint64(32)
        u, counts = np.unique(v, return_counts=True)
        out = [(u >> np.uint64(32)).astype(np.uint32),
               (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)][2 - W:]
        return np.stack(out, axis=1), counts.astype(np.int64)
    # big-endian rows compare bytewise in lexicographic word order
    be = np.ascontiguousarray(keys.astype(">u4"))
    rows = be.view(np.dtype((np.void, 4 * W))).reshape(-1)
    u, counts = np.unique(rows, return_counts=True)
    out = np.frombuffer(u.tobytes(), ">u4").reshape(-1, W).astype(np.uint32)
    return out, counts.astype(np.int64)
