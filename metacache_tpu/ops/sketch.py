"""MinHash sketching: the s smallest *unique* kmer hash values per window.

Reference: single_function_unique_min_hasher (src/hash_dna.h:50-182) —
hash every unambiguous canonical kmer of a window with one hash function and
keep the sketch_size smallest values, skipping duplicates; a window with
fewer than k characters yields an empty sketch; a window with n characters
yields at most min(sketch_size, n-k+1) features; the all-ones value ~0 can
never enter a sketch (it is the internal fill sentinel).

Device formulation (equivalence argument): the reference maintains a
sorted insert buffer, but the result — the set of the s smallest distinct
hash values — is order-independent. We therefore compute it as
    sort -> mask duplicates to sentinel -> sort -> take first s
which is two fixed-width row sorts, batched over [num_windows, lanes].
The <= min(s, n-k+1) output-size cap is automatic: a window with m valid
kmer positions has <= m distinct hash values.
Invalid positions (ambiguous chars / beyond window end / padding) carry the
sentinel 0xFFFFFFFF which sorts last and is never a legal feature.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FEATURE_SENTINEL
from .encode import window_kmers, np_window_kmers
from .hashes import thomas_mueller_hash, np_thomas_mueller_hash

SENTINEL = np.uint32(FEATURE_SENTINEL)  # np: no backend init at import


@functools.partial(jax.jit, static_argnames=("k", "sketch_size"))
def sketch_windows(codes: jnp.ndarray, valid_len: jnp.ndarray,
                   k: int, sketch_size: int) -> jnp.ndarray:
    """Compute MinHash sketches for a batch of windows.

    Args:
      codes:     [B, W] uint8 2-bit codes (255 = ambiguous/padding)
      valid_len: [B] int32 actual window lengths
      k:         kmer size (static)
      sketch_size: number of features per sketch (static)

    Returns:
      [B, sketch_size] uint32 features, ascending, padded with 0xFFFFFFFF.
    """
    kmers, valid = window_kmers(codes, valid_len, k)
    h = thomas_mueller_hash(kmers)
    h = jnp.where(valid, h, SENTINEL)
    # sentinel can also be a genuine hash output; the reference excludes it
    # (h < sketch.back() is false when back == ~0), and the formulation
    # below treats it exactly the same way: it never survives.
    #
    # s smallest *unique* values as sort -> mask adjacent duplicates ->
    # slice. The sorted-run dedup needs a second pass to compact, done
    # with one more single-key sort (chosen over sketch_size unrolled
    # min+where steps for its small generated code).
    hs = jax.lax.sort(h, dimension=-1, is_stable=False)
    dup = jnp.concatenate(
        [jnp.zeros_like(hs[..., :1], dtype=bool),
         hs[..., 1:] == hs[..., :-1]], axis=-1)
    hs = jnp.where(dup, SENTINEL, hs)
    hs = jax.lax.sort(hs, dimension=-1, is_stable=False)
    if hs.shape[-1] < sketch_size:   # window shorter than the sketch
        hs = jnp.concatenate(
            [hs, jnp.full(hs.shape[:-1] + (sketch_size - hs.shape[-1],),
                          SENTINEL, hs.dtype)], axis=-1)
    return hs[..., :sketch_size]


def np_sketch_window(codes: np.ndarray, valid_len: int,
                     k: int, sketch_size: int) -> np.ndarray:
    """Host/numpy mirror for one window; returns only the valid features."""
    kmers, valid = np_window_kmers(codes, valid_len, k)
    if len(kmers) == 0:
        return np.zeros(0, dtype=np.uint32)
    h = np_thomas_mueller_hash(kmers[valid])
    h = h[h != np.uint32(0xFFFFFFFF)]
    h = np.unique(h)  # sorted unique
    return h[:sketch_size]
