"""2-bit DNA encoding, windowing, and canonical k-mer extraction.

Reference behaviors mirrored (not translated):
  - char -> 2-bit code A=0 C=1 G=2 T=3, anything else ambiguous
    (src/dna_encoding.h:330-336)
  - reverse complement via bit swaps + complement (src/dna_encoding.h:113-121)
  - canonical kmer = min(kmer, revcomp) (src/dna_encoding.h:187-197)
  - windowing: if len(seq) <= window -> ONE window = whole sequence; else
    full windows every `stride`, plus a tail window if characters remain
    (src/dna_encoding.h:261-276)

Device design: sequences are shipped to the device as packed bytes; the
char->code LUT, the rolling k-mer build (k static => k unrolled shift-or
steps over static slices), the reverse complement and the hash are all
elementwise ops over a [num_windows, window_size] tensor, fused by XLA into
a single pass.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# char -> 2-bit code lookup table. 0..3 = valid base, 255 = ambiguous.
# Padding bytes (0) are ambiguous, so padded regions yield no valid kmers.
# ---------------------------------------------------------------------------
AMBIG_CODE = np.uint8(255)

_LUT = np.full(256, AMBIG_CODE, dtype=np.uint8)
for ch, code in (("A", 0), ("a", 0), ("C", 1), ("c", 1),
                 ("G", 2), ("g", 2), ("T", 3), ("t", 3)):
    _LUT[ord(ch)] = code

CHAR_LUT = _LUT  # numpy, used host-side too


def encode_bytes(seq_bytes: jnp.ndarray) -> jnp.ndarray:
    """Map raw ASCII bytes [..., L] uint8 -> 2-bit codes (255=ambiguous)."""
    lut = jnp.asarray(_LUT)
    return lut[seq_bytes]


def np_encode_bytes(seq_bytes: np.ndarray) -> np.ndarray:
    return _LUT[seq_bytes]


# ---------------------------------------------------------------------------
# 2-bit packing for host->device transfer (4 bases/byte + ambiguity bitplane)
# Transfer bandwidth is a first-order bottleneck when feeding chips; packing
# cuts read-batch bytes by ~2.7x vs raw 1-byte codes.
# ---------------------------------------------------------------------------
def np_pack_codes(codes: np.ndarray):
    """[B, L] uint8 codes (0..3, 255=ambiguous) -> (packed [B, L/4],
    ambig_bits [B, L/8]); L must be a multiple of 8."""
    B, L = codes.shape
    assert L % 8 == 0, "pack length must be a multiple of 8"
    c = np.where(codes == AMBIG_CODE, 0, codes).astype(np.uint8)
    c = c.reshape(B, L // 4, 4)
    packed = (c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4)
              | (c[..., 3] << 6)).astype(np.uint8)
    a = (codes == AMBIG_CODE).reshape(B, L // 8, 8)
    weights = (1 << np.arange(8)).astype(np.uint8)
    ambig = (a * weights).sum(axis=-1).astype(np.uint8)
    return packed, ambig


def unpack_codes(packed: jnp.ndarray, ambig: jnp.ndarray) -> jnp.ndarray:
    """Device-side inverse of np_pack_codes -> [B, L] uint8 (0..3, 255)."""
    B, P4 = packed.shape
    L = P4 * 4
    shifts = jnp.arange(4, dtype=jnp.uint8) * 2
    c = (packed[:, :, None] >> shifts[None, None, :]) & jnp.uint8(3)
    c = c.reshape(B, L)
    bshifts = jnp.arange(8, dtype=jnp.uint8)
    a = (ambig[:, :, None] >> bshifts[None, None, :]) & jnp.uint8(1)
    a = a.reshape(B, L)
    return jnp.where(a == 1, jnp.uint8(AMBIG_CODE), c)


def synth_ambig_from_lens(lens: jnp.ndarray, qlen: int) -> jnp.ndarray:
    """Device-side ambiguity bitplane for reads KNOWN to contain no
    ambiguous characters: only the padding positions (>= len) are marked.

    This is the device half of the slim wire format (engine
    fuse_host_inputs_slim): the host ships 2-bit packed bases + lengths
    only; reads that DO contain ambiguous characters are detected host-side
    and re-classified through the legacy program with their real bitplane.
    Returns [B, qlen/8] uint8, bit b of byte i == position 8i+b >= len.
    """
    B = lens.shape[0]
    byte_pos = jnp.arange(qlen // 8, dtype=jnp.int32) * 8
    out = jnp.zeros((B, qlen // 8), dtype=jnp.uint8)
    for b in range(8):
        bit = (byte_pos[None, :] + b) >= lens[:, None]
        out = out | (bit.astype(jnp.uint8) << b)
    return out


_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)


def np_rows_with_ambiguity(ambig: np.ndarray, lens: np.ndarray,
                           qlen: int) -> np.ndarray:
    """Host-side: boolean [B] — does row b have any ambiguity bit set at a
    position < lens[b]?

    Fast path: both producers (np_pack_codes and the native reader's
    encode_row) set ALL padding bits, so a row is clean iff its popcount
    equals its padding count — one 256-entry LUT pass instead of
    unpackbits over B*qlen booleans (this runs per dispatched batch on the
    query hot path). Rows with FEWER set bits than padding (a producer
    that left padding unmarked) fall back to the exact bit scan."""
    if not ambig.any():
        return np.zeros(ambig.shape[0], dtype=bool)
    pop = _POP8[ambig].sum(axis=1, dtype=np.int32)
    pad = np.maximum(qlen - lens, 0).astype(np.int32)
    out = pop > pad
    under = pop < pad
    if under.any():
        rows = np.nonzero(under)[0]
        bits = np.unpackbits(ambig[rows], axis=1,
                             bitorder="little")[:, :qlen]
        pos = np.arange(qlen)
        out[rows] = ((bits != 0)
                     & (pos[None, :] < lens[rows, None])).any(axis=1)
    return out


# ---------------------------------------------------------------------------
# windowing (host helper): start offsets of windows of a sequence
# ---------------------------------------------------------------------------
def window_starts(seq_len: int, window: int, stride: int) -> np.ndarray:
    """Start offsets of all windows incl. the tail window.

    Matches for_each_window (src/dna_encoding.h:261-276): one window if
    seq_len <= window; otherwise full windows at every `stride`, plus a tail
    window if characters remain after the last full window.
    """
    if seq_len <= window:
        return np.zeros(1, dtype=np.int64)
    n_full = (seq_len - window) // stride + 1
    starts = np.arange(n_full, dtype=np.int64) * stride
    tail_start = n_full * stride
    if tail_start < seq_len:
        starts = np.append(starts, tail_start)
    return starts


def num_windows(seq_len: int, window: int, stride: int) -> int:
    return len(window_starts(seq_len, window, stride))


# ---------------------------------------------------------------------------
# canonical kmers over fixed-size windows (device)
# ---------------------------------------------------------------------------
def reverse_complement_u32(kmer: jnp.ndarray, k: int) -> jnp.ndarray:
    """Bit-twiddled reverse complement of 2-bit packed kmers (u32).

    Mirrors make_reverse_complement(uint32) (src/dna_encoding.h:113-121):
    reverse the 2-bit groups, complement, shift down to the low 2k bits.
    """
    s = kmer.astype(jnp.uint32)
    s = ((s >> 2) & jnp.uint32(0x33333333)) | ((s & jnp.uint32(0x33333333)) << 2)
    s = ((s >> 4) & jnp.uint32(0x0F0F0F0F)) | ((s & jnp.uint32(0x0F0F0F0F)) << 4)
    s = ((s >> 8) & jnp.uint32(0x00FF00FF)) | ((s & jnp.uint32(0x00FF00FF)) << 8)
    s = ((s >> 16) & jnp.uint32(0x0000FFFF)) | ((s & jnp.uint32(0x0000FFFF)) << 16)
    s = jnp.uint32(0xFFFFFFFF) - s
    shift = 32 - (k << 1)
    if shift:
        s = s >> shift
    return s


def canonical_u32(kmer: jnp.ndarray, k: int) -> jnp.ndarray:
    """min(kmer, revcomp) (src/dna_encoding.h:187-197)."""
    rc = reverse_complement_u32(kmer, k)
    return jnp.minimum(kmer, rc)


@functools.partial(jax.jit, static_argnames=("k",))
def window_kmers(codes: jnp.ndarray, valid_len: jnp.ndarray, k: int):
    """All canonical kmers + validity mask for a batch of windows.

    Args:
      codes:     [B, W] uint8 2-bit codes (255 = ambiguous/padding)
      valid_len: [B] int32 actual window lengths (chars beyond are padding)
      k:         kmer length (static, <= 16)

    Returns:
      (kmers, valid): [B, W-k+1] uint32 canonical kmers and bool mask.
      A kmer position i is valid iff i + k <= valid_len and none of its k
      characters is ambiguous — mirroring the per-kmer ambiguity bitmask of
      for_each_kmer_2bit (src/dna_encoding.h:305-348).
    """
    B, W = codes.shape
    n = W - k + 1
    kmer = jnp.zeros((B, n), dtype=jnp.uint32)
    ambig = jnp.zeros((B, n), dtype=jnp.bool_)
    for j in range(k):
        c = codes[:, j:j + n]
        ambig |= c == AMBIG_CODE
        kmer = (kmer << 2) | (c & jnp.uint8(3)).astype(jnp.uint32)
    pos = jnp.arange(n, dtype=jnp.int32)[None, :]
    in_range = pos + k <= valid_len[:, None]
    valid = in_range & ~ambig
    return canonical_u32(kmer, k), valid


# ---------------------------------------------------------------------------
# numpy oracle mirrors (used by host-side paths and for small sequences)
# ---------------------------------------------------------------------------
def np_reverse_complement_u32(kmer, k: int):
    s = np.asarray(kmer, dtype=np.uint32)
    s = ((s >> 2) & np.uint32(0x33333333)) | ((s & np.uint32(0x33333333)) << 2)
    s = ((s >> 4) & np.uint32(0x0F0F0F0F)) | ((s & np.uint32(0x0F0F0F0F)) << 4)
    s = ((s >> 8) & np.uint32(0x00FF00FF)) | ((s & np.uint32(0x00FF00FF)) << 8)
    s = ((s >> 16) & np.uint32(0x0000FFFF)) | ((s & np.uint32(0x0000FFFF)) << 16)
    with np.errstate(over="ignore"):
        s = np.uint32(0xFFFFFFFF) - s
    shift = 32 - 2 * k
    if shift:
        s = s >> np.uint32(shift)
    return s


def np_window_kmers(codes: np.ndarray, valid_len: int, k: int):
    """Scalar-ish numpy mirror of window_kmers for one window [W]."""
    W = len(codes)
    n = W - k + 1
    if n <= 0:
        return (np.zeros(0, dtype=np.uint32), np.zeros(0, dtype=bool))
    kmer = np.zeros(n, dtype=np.uint32)
    ambig = np.zeros(n, dtype=bool)
    for j in range(k):
        c = codes[j:j + n]
        ambig |= c == AMBIG_CODE
        kmer = (kmer << np.uint32(2)) | (c & np.uint8(3)).astype(np.uint32)
    pos = np.arange(n)
    valid = (pos + k <= valid_len) & ~ambig
    canon = np.minimum(kmer, np_reverse_complement_u32(kmer, k))
    return canon, valid
