"""LCA-vote classification over candidate lists — vectorized on device.

Reference: classify() (src/classification.cpp:235-265):
  - unclassified if no candidates or top candidate hits < hitsMin
  - threshold = (hits0 - hitsMin) * hitsDiffFraction  if hits0 > hitsMin else 0
  - walk candidates 2..C in order; while hits > threshold, fold the
    candidate into a ranked LCA; stop at the first candidate at/below the
    threshold; unclassified if the LCA climbs above highestRank.

Vectorized formulation: ranked_lca(a, b) on dense ranked lineages is the
elementwise intersection mask — the common entries of two consistent
lineages are exactly the lineage of their LCA (SURVEY.md §2 #9). The fold
is an unrolled loop over the (static, small) candidate count; the final
taxon is the first nonzero lane of the folded lineage.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _lineage_rows(ranked_lineage, tax):
    """ranked_lineage[tax] without the per-element gather when the table is
    small: a [B, N] one-hot f32 matmul (exact for entries < 2^26 via a
    13-bit split) stands in for the row gather on the small per-engine
    candidate-lineage tables (QueryEngine._lineage_small). Whether it
    beats the plain gather on a GPU is not measured yet. Entries must be
    < 2^26 — guaranteed for node indices whenever the full taxonomy has
    < 2^26 nodes (the same bound the packed summary word already
    requires)."""
    N, R = ranked_lineage.shape
    if N > 2048:
        return ranked_lineage[tax]
    oh = (tax[:, None] == jax.lax.broadcasted_iota(jnp.int32, (1, N), 1)
          ).astype(jnp.float32)
    lo = (ranked_lineage & 0x1FFF).astype(jnp.float32)
    hi = (ranked_lineage >> 13).astype(jnp.float32)
    # Precision.HIGHEST: the 13-bit chunks (0..8191) must multiply-accumulate
    # exactly; a lower precision (bf16 passes, or TF32 on GPUs, exact only
    # to 2^11) would silently round node indices. Full f32 is exact to
    # 2^24 > 2^13.
    lor = jnp.dot(oh, lo, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    hir = jnp.dot(oh, hi, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    return lor.astype(jnp.int32) + (hir.astype(jnp.int32) << 13)


@functools.partial(jax.jit, static_argnames=("highest_rank",))
def classify_lca(cand_tax, cand_hits, ranked_lineage, hits_min,
                 hits_diff_fraction, highest_rank: int):
    """Classify each read from its candidate list.

    Args:
      cand_tax:  [B, C] int32 candidate taxon node indices (0 = empty slot),
                 sorted by hits descending
      cand_hits: [B, C] int32
      ranked_lineage: [N, R] int32 node index of ancestor per rank (0=none);
                 row 0 must be all zeros
      hits_min:  int32 scalar (already resolved from sketch size)
      hits_diff_fraction: float32 scalar
      highest_rank: static int rank code (classification stops above this)

    Returns:
      (best_node, best_rank): [B] int32 each; best_node==0 => unclassified,
      in which case best_rank == NUM_RANKS (the 'none' code).
    """
    B, C = cand_tax.shape
    R = ranked_lineage.shape[1]

    hits0 = cand_hits[:, 0]
    has_top = cand_tax[:, 0] > 0
    classifiable = has_top & (hits0 >= hits_min)

    thr = jnp.where(
        hits0 > hits_min,
        (hits0 - hits_min).astype(jnp.float32) * hits_diff_fraction,
        jnp.float32(0.0))

    lin = _lineage_rows(ranked_lineage, cand_tax[:, 0])   # [B, R]
    include_prefix = jnp.ones((B,), dtype=bool)
    for i in range(1, C):
        inc = include_prefix & (cand_hits[:, i].astype(jnp.float32) > thr) \
            & (cand_tax[:, i] > 0)
        lin_i = _lineage_rows(ranked_lineage, cand_tax[:, i])
        folded = jnp.where(lin == lin_i, lin, 0)
        lin = jnp.where(inc[:, None], folded, lin)
        include_prefix = inc

    nonzero = lin != 0
    any_nz = nonzero.any(axis=1)
    first = jnp.argmax(nonzero, axis=1).astype(jnp.int32)
    best_node = jnp.take_along_axis(lin, first[:, None], axis=1)[:, 0]
    ok = classifiable & any_nz & (first <= highest_rank)
    best_node = jnp.where(ok, best_node, 0)
    best_rank = jnp.where(ok, first, R)
    return best_node, best_rank
