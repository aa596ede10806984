"""2-bit DNA base encoding and multi-word k-mer key layout.

Design (not a port):
  * Bases are 2-bit codes from the moment they leave the parser:
    A=0, C=1, G=2, T=3.  This matches ASCII lexicographic order
    (A<C<G<T), so integer order on packed keys == byte order on the
    original strings — the same order the reference's effective sort
    produces (reference: k-mer-count/src/main.rs:87 `lr_chunk.sort()`).
  * A k-mer key is a fixed tuple of W uint32 "words", most-significant
    word first, holding the right-aligned big integer
        value = sum_j code[j] * 4**(k-1-j)
    (first base most significant).  uint32 words — not uint64 —
    because JAX runs with 64-bit types off by default and accelerator
    integer datapaths are 32 bits wide, so the key layout stays in the
    lane width explicitly.
  * One extra bit above the 2k value bits is reserved so the all-ones
    tuple is a sentinel strictly greater than every valid key:
        W = ceil((2k + 1) / 32)
    Invalid lanes (window past end-of-read, padding) carry the sentinel
    and sort to the end; no separate validity sort key is needed.
"""

from __future__ import annotations

import numpy as np

# Base codes.  Order is load-bearing: code order == ASCII order of ACGT.
BASE_ORDER = "ACGT"
CODE_A, CODE_C, CODE_G, CODE_T = 0, 1, 2, 3

SENTINEL_WORD = np.uint32(0xFFFFFFFF)

# Unknown-base marker (N and other IUPAC ambiguity codes in
# allow_ambiguous mode).  Does not fit 2 bits: extraction masks out any
# window containing it (ops/extract.py) instead of encoding it.
AMBIG_CODE = np.uint8(4)

# char -> code lookup; 255 marks invalid characters, AMBIG_CODE marks
# IUPAC ambiguity codes (only accepted when allow_ambiguous).
_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(BASE_ORDER):
    _LUT[ord(_b)] = _i
    _LUT[ord(_b.lower())] = _i
for _b in "NRYKMSWBDHVU":
    _LUT[ord(_b)] = AMBIG_CODE
    _LUT[ord(_b.lower())] = AMBIG_CODE

# code -> ASCII byte lookup.
_CODE_TO_ASCII = np.frombuffer(BASE_ORDER.encode(), dtype=np.uint8).copy()


class InvalidBaseError(ValueError):
    """Raised on non-ACGT input (reference panics instead: main.rs:23)."""


def words_per_key(n_bases: int) -> int:
    """Number of uint32 words for an n_bases-mer key (incl. sentinel bit)."""
    return (2 * n_bases + 1 + 31) // 32


def encode_seq(seq: str | bytes, allow_ambiguous: bool = False) -> np.ndarray:
    """ASCII sequence -> uint8 codes (2-bit, plus AMBIG_CODE when
    allow_ambiguous); raises InvalidBaseError otherwise."""
    raw = np.frombuffer(seq.encode() if isinstance(seq, str) else seq, dtype=np.uint8)
    codes = _LUT[raw]
    bad_cut = 255 if allow_ambiguous else AMBIG_CODE
    if codes.max(initial=0) >= bad_cut:
        bad = int(np.argmax(codes >= bad_cut))
        raise InvalidBaseError(
            f"invalid base {chr(int(raw[bad]))!r} at position {bad}"
        )
    return codes


def decode_codes(codes: np.ndarray) -> str:
    """uint8 codes -> ACGT string."""
    return _CODE_TO_ASCII[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def key_words_from_codes(codes: np.ndarray, n_bases: int | None = None) -> np.ndarray:
    """Pack one code vector into its key words (numpy, host-side oracle path).

    Returns uint32 array of shape (W,), most-significant word first.
    """
    codes = np.asarray(codes, dtype=np.uint64)
    k = len(codes) if n_bases is None else n_bases
    assert len(codes) == k
    W = words_per_key(k)
    words = np.zeros(W, dtype=np.uint32)
    for j in range(k):
        bitpos = 2 * (k - 1 - j)
        wi = W - 1 - bitpos // 32
        sh = bitpos % 32
        words[wi] |= np.uint32((int(codes[j]) & 3) << sh)
    return words


def codes_from_key_words(words: np.ndarray, n_bases: int) -> np.ndarray:
    """Inverse of key_words_from_codes: (…, W) uint32 -> (…, n_bases) uint8."""
    words = np.asarray(words, dtype=np.uint32)
    W = words.shape[-1]
    assert W == words_per_key(n_bases), (W, n_bases)
    out = np.empty(words.shape[:-1] + (n_bases,), dtype=np.uint8)
    for j in range(n_bases):
        bitpos = 2 * (n_bases - 1 - j)
        wi = W - 1 - bitpos // 32
        sh = bitpos % 32
        out[..., j] = (words[..., wi] >> np.uint32(sh)) & np.uint32(3)
    return out


def decode_key_words(words: np.ndarray, n_bases: int) -> list[str]:
    """Batch-decode (M, W) key words into ACGT strings."""
    codes = codes_from_key_words(np.atleast_2d(words), n_bases)
    ascii_arr = _CODE_TO_ASCII[codes]
    return [row.tobytes().decode() for row in ascii_arr]


def decode_key_words_to_bytes(words: np.ndarray, n_bases: int) -> np.ndarray:
    """Batch-decode (M, W) key words into an (M,) |S{n_bases} array."""
    words = np.atleast_2d(np.asarray(words, dtype=np.uint32))
    # native one-pass MT decode when available (pipeline/nativeagg —
    # the numpy path below makes n_bases strided passes)
    from ..pipeline.nativeagg import decode_rows
    rows = decode_rows(words, n_bases, newline=False)
    if rows is not None:
        return rows.reshape(-1).view(f"S{n_bases}")
    codes = codes_from_key_words(words, n_bases)
    raw = np.ascontiguousarray(_CODE_TO_ASCII[codes]).tobytes()
    return np.frombuffer(raw, dtype=f"S{n_bases}")


def decode_key_words_to_lines(words: np.ndarray, n_bases: int) -> bytes:
    """Batch-decode (M, W) key words into newline-terminated ASCII bytes.

    Vectorized dump used by the reference-parity path (the analog of the
    reference's stdout loop, main.rs:88-90): every line is exactly
    n_bases chars + '\\n', in input row order.
    """
    words = np.atleast_2d(np.asarray(words, dtype=np.uint32))
    from ..pipeline.nativeagg import decode_rows
    rows = decode_rows(words, n_bases, newline=True)
    if rows is not None:
        return rows.tobytes()
    codes = codes_from_key_words(words, n_bases)
    out = np.empty((codes.shape[0], n_bases + 1), dtype=np.uint8)
    out[:, :n_bases] = _CODE_TO_ASCII[codes]
    out[:, n_bases] = ord("\n")
    return out.tobytes()


def revcomp_str(seq: str) -> str:
    """Host-side reverse complement (oracle helper)."""
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    return "".join(comp[b] for b in reversed(seq))


def unpack_codes_u32(packed, L: int):
    """Device-side inverse of the host 2-bit packer (io/native
    fill_batch_packed / io.fasta.pack_batch_codes): (B, ceil(L/16))
    uint32 -> (B, L) uint8 codes.  16 shift-ands on the word array —
    negligible next to the 4x H2D saving the packed transfer buys.
    """
    import jax.numpy as jnp
    B, Lw = packed.shape
    shifts = jnp.asarray(2 * (15 - np.arange(16)), dtype=jnp.uint32)
    ex = (packed[:, :, None] >> shifts[None, None, :]) & jnp.uint32(3)
    return ex.reshape(B, Lw * 16)[:, :L].astype(jnp.uint8)
