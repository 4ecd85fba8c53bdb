"""Device-side database lookup: query features -> sorted per-read match lists.

Reference behavior being reproduced (sketch_database::accumulate_matches,
src/sketch_database.h:804-833 + the per-read merge_sort at
src/querying.h:88-106): for every query-window feature, append ALL stored
locations of that feature; the concatenation, sorted by (target, window),
is the per-read match list. A feature sketched in two query windows
contributes its locations twice (multiplicity matters for hit counts).

Device formulation: the hash-map probe becomes a batched binary search
(`searchsorted`) over the sorted key array; the location append becomes a
fixed-width slot gather driven by a per-read exclusive cumsum of run
lengths; the merge sort becomes one stable two-key `lax.sort` per read row.
All shapes are static: [B, NF] features in, [B, LMAX] match slots out.

Reads whose total match count exceeds LMAX are truncated deterministically
(trailing features' locations dropped); the overflow count is returned so
callers can report it. The reference has no such cap (unbounded vectors) —
this is the documented fixed-shape divergence knob (SURVEY.md §7 "hard
parts"); LMAX must simply be sized for the workload.
"""
from __future__ import annotations


import jax
import numpy as np
import jax.numpy as jnp

from ..config import FEATURE_SENTINEL, TARGET_SENTINEL

SENTINEL_U32 = np.uint32(FEATURE_SENTINEL)  # np: no backend init at import


RADIX_BITS = 16      # lower bound; build_radix_index widens adaptively
MAX_RADIX_BITS = 24  # 2^24+1 int32 offsets = 67 MB per shard; each
                     # halving of the max bucket removes one key-gather
                     # step per batch


def build_radix_index(keys: "np.ndarray"):
    """Host-side: bucket offsets for the top `bits` of the key space.

    bucket_offsets[b] = first index whose key >> (32-bits) >= b, so a
    query lands in [bucket_offsets[q>>(32-bits)], ...+1) and the on-device
    binary search needs only log2(max bucket size) steps. `bits` widens
    with the table so buckets stay O(1): each halving of the bucket size
    removes one key-gather step per batch.
    Returns (bucket_offsets [2^bits] int32, search_steps int); the bit
    width is recovered from the array length (len == 2^bits).
    """
    import numpy as np
    bits = min(MAX_RADIX_BITS,
               max(RADIX_BITS, int(max(1, len(keys))).bit_length() + 4))
    nb = 1 << bits
    prefixes = (keys >> np.uint32(32 - bits)).astype(np.int64)
    bucket_offsets = np.searchsorted(prefixes, np.arange(nb + 1),
                                     side="left").astype(np.int32)
    max_bucket = int(np.max(np.diff(bucket_offsets))) if len(keys) else 1
    steps = max(1, int(max_bucket).bit_length())
    # the device search derives hi = lo + 2^steps instead of gathering the
    # bucket end (global_lower_bound) — keys past the bucket end are larger,
    # so the lower bound still converges; encode the bound in `steps`
    return bucket_offsets[:-1].copy(), steps


def global_lower_bound(keys, queries, bucket_offsets=None,
                       search_steps=None):
    """Lower bound of each query in a sorted 1-D key array.

    Unrolled binary search keeping queries in their natural 2-D layout
    (jnp.searchsorted flattens to 1-D). With a radix prefix index
    (build_radix_index) the search needs only log2(max bucket) steps
    instead of log2(F).
    keys: [F] sorted uint32; queries: [B, Q] uint32. Returns [B, Q] int32.
    """
    F = keys.shape[0]
    if bucket_offsets is not None:
        bits = int(bucket_offsets.shape[0]).bit_length() - 1
        bidx = (queries >> jnp.uint32(32 - bits)).astype(jnp.int32)
        lo = bucket_offsets[bidx]             # [B, Q] one word-gather
        # hi = lo + (2^steps - 1) bounds the bucket: bit_length gives
        # max_bucket <= 2^steps - 1, and an interval of that size converges
        # in `steps` halvings; keys past the bucket end are larger, so the
        # lower bound is unaffected by the over-wide interval
        hi = lo + jnp.int32((1 << search_steps) - 1)
        steps = search_steps
    else:
        lo = jnp.zeros(queries.shape, dtype=jnp.int32)
        hi = jnp.full(queries.shape, F, dtype=jnp.int32)
        steps = max(1, F.bit_length())
    for _ in range(steps):
        mid = (lo + hi) >> 1
        mv = keys[jnp.minimum(mid, F - 1)]
        less = mv < queries
        lo = jnp.where(less, mid + 1, lo)
        hi = jnp.where(less, hi, mid)
    return lo


def row_upper_bound(values, queries):
    """Per-row upper bound: for each row b and query q, the count of
    values[b, :] that are <= q (i.e. searchsorted side='right').

    Manual unrolled binary search over take_along_axis steps — a vmapped
    jnp.searchsorted lowers to a serialized per-row while-loop.
    values: [B, N] sorted rows; queries: [B, Q]. Returns [B, Q] int32.
    """
    B, N = values.shape
    steps = max(1, N.bit_length())
    lo = jnp.zeros(queries.shape, dtype=jnp.int32)
    hi = jnp.full(queries.shape, N, dtype=jnp.int32)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        mv = jnp.take_along_axis(values, jnp.minimum(mid, N - 1), axis=1)
        le = mv <= queries
        lo = jnp.where(le, mid + 1, lo)
        hi = jnp.where(le, hi, mid)
    return lo


def _expand_slots(start, cum_ex, lmax: int):
    """Per-slot location index via rank-by-sort (gather-free).

    Slot j of a read belongs to the run (query feature) fi with
    cum_ex[fi] <= j < cum_ex[fi] + cnt[fi]; the slot reads location
    start[fi] + (j - cum_ex[fi]).  Rather than materialize the
    [B, lmax, NF] run-covers mask, co-sort the runs (key = cum_ex,
    payload = start - cum_ex) with the slot ids (key = slot) and propagate
    the most recent run's payload forward.  Among runs sharing a cum_ex
    value only the last in feature order has cnt > 0 (zero-length runs
    precede the one that advances the cumsum), so "most recent item" is
    exactly the covering run.  Slots past the read's total are garbage and
    must be masked by the caller.  Returns li [B, lmax] int32 (location
    index per slot).
    """
    B, NF = start.shape
    slots = jnp.arange(lmax, dtype=jnp.int32)
    i_pos = jnp.broadcast_to(jnp.arange(NF, dtype=jnp.int32)[None, :],
                             (B, NF))
    i_pay = start - cum_ex
    q_key = jnp.broadcast_to(slots[None, :], (B, lmax))
    # pack (key, flag) into one sort key (key*2 + flag): items before
    # queries at equal key, one fewer sort operand (sort bytes dominate)
    c_key = jnp.concatenate([cum_ex * 2, q_key * 2 + 1], axis=1)
    c_pos = jnp.concatenate([i_pos, q_key], axis=1)
    c_pay = jnp.concatenate([i_pay, jnp.zeros((B, lmax), jnp.int32)], axis=1)
    # items in feature order at equal packed key
    s_key, s_pos, s_pay = jax.lax.sort(
        (c_key, c_pos, c_pay), dimension=1, num_keys=2,
        is_stable=False)
    is_item = (s_key & 1) == 0

    # carry the most recent item's payload forward with a log-shift
    # fill-forward scan (Hillis-Steele over the "rightmost valid" operator):
    # position i without a value yet takes position i-s's value if that one
    # has found its carry within its own 2^log-step lookback. Pure
    # elementwise selects, chosen over lax.cummax + take_along_axis for
    # their much smaller generated code.
    W2 = NF + lmax
    pay = jnp.where(is_item, s_pay, 0)
    have = is_item
    s = 1
    while s < W2:
        pv = jnp.concatenate([jnp.zeros((B, s), pay.dtype),
                              pay[:, :-s]], axis=1)
        hv = jnp.concatenate([jnp.zeros((B, s), jnp.bool_),
                              have[:, :-s]], axis=1)
        pay = jnp.where(have, pay, pv)
        have = have | hv
        s <<= 1
    # return query slots to slot order: queries (flag 1) land in the last
    # lmax columns sorted by slot id — (flag, pos) packed into one key
    P2 = 1 << int(max(NF, lmax) - 1).bit_length()
    fp = (s_key & 1) * P2 + s_pos
    _, back = jax.lax.sort((fp, pay), dimension=1, num_keys=1,
                           is_stable=False)
    return back[:, NF:] + slots[None, :]


def build_direct_table(start, cnt, loc_packed, mb: int) -> "np.ndarray":
    """Host-side: padded per-feature location table for the direct tier.

    [F, mb+1] int32: column 0 = the feature's bucket size (uncapped),
    columns 1..mb = its first mb packed locations, sentinel-padded.

    Rationale: the flat [B, NF*mb] single-word gather from a device-memory
    location array lowers to scattered word fetches; gathering [B, NF]
    ALIGNED (mb+1)-word ROWS from this padded table carries the same
    information in a layout that reads whole rows. Memory cost is
    (mb+1)/mean_bucket x the location array — the engine gates it behind a
    budget and falls back to the flat gather.
    """
    import numpy as np
    F = len(start)
    tbl = np.full((F, mb + 1), np.int32(2**31 - 1), np.int32)
    tbl[:, 0] = cnt
    start = np.asarray(start, np.int64)
    for j in range(mb):
        sel = cnt > j
        tbl[sel, 1 + j] = loc_packed[start[sel] + j]
    return tbl


def lookup_matches_direct(features, keys, start_tbl, cnt_tbl, loc_tgt,
                          loc_win, mb: int, bucket_offsets=None,
                          search_steps=None, loc_packed=None,
                          win_bits: int = 0, direct_tbl=None):
    """Gather + sort match lists with a static per-feature location cap.

    The fast-tier alternative to lookup_matches: instead of computing
    per-read slot positions with an exclusive cumsum + rank-by-sort
    expansion,
    every query feature emits exactly `mb` slots — slot (f, j) reads
    location start[f] + j, masked to a sentinel when j >= cnt[f].  The
    per-read sort that downstream candidate generation needs anyway pushes
    the sentinels to the end, so no compaction step exists at all.  Output
    width is NF * mb (static).

    Correctness contract: a read where ANY feature has cnt > mb reports
    overflow > 0 and MUST be re-classified through the full-width
    lookup_matches program (QueryEngine.materialize does this); rows with
    overflow == 0 are exactly equal to the full path's output.  When mb >=
    the table's max bucket size no read ever overflows and the fast tier
    is exact by itself.

    Args:
      features: [B, NF] uint32 query features (FEATURE_SENTINEL = none).
      keys:     [F] uint32 sorted feature keys
      start_tbl:[F] int32 CSR start offsets (offsets[:-1])
      cnt_tbl:  [F] int32 per-feature location counts (diff(offsets))
      mb:       static per-feature location cap (fast-tier bucket bound)
      loc_packed/win_bits, bucket_offsets/search_steps: as lookup_matches.

    Returns (tgt [B, NF*mb], win [B, NF*mb], total [B], overflow [B]).
    """
    B, NF = features.shape
    F = keys.shape[0]

    idx = global_lower_bound(keys, features, bucket_offsets, search_steps)
    idx = jnp.minimum(idx, F - 1)
    found = (keys[idx] == features) & (features != SENTINEL_U32)

    if direct_tbl is not None:
        # row-gather fast path: ONE aligned (mb+1)-word row per feature
        # (cnt + sentinel-padded locations, build_direct_table) instead of
        # mb scattered word fetches
        row = direct_tbl[idx]                       # [B, NF, mb+1]
        cnt = jnp.where(found, row[..., 0], 0)
        cnt_c = jnp.minimum(cnt, mb)
        vals = jnp.where(found[..., None], row[..., 1:],
                         jnp.int32(2**31 - 1))
        packed = jax.lax.sort(vals.reshape(B, NF * mb), dimension=1,
                              is_stable=False)
        ok = packed != jnp.int32(2**31 - 1)
        tgt = jnp.where(ok, packed >> win_bits, TARGET_SENTINEL)
        win = jnp.where(ok, packed & jnp.int32((1 << win_bits) - 1),
                        jnp.int32(2**31 - 1))
        total = jnp.sum(cnt_c, axis=1)
        overflow = jnp.sum(cnt - cnt_c, axis=1)
        return tgt, win, total, overflow

    start = jnp.where(found, start_tbl[idx], 0)
    cnt = jnp.where(found, cnt_tbl[idx], 0)
    cnt_c = jnp.minimum(cnt, mb)

    # slot emission as pure 2-D concatenation, j-major: block j holds every
    # feature's (j+1)-th location (no [B, NF, mb] broadcast with a tiny
    # minor dimension); slot ORDER is irrelevant because the (tgt, win)
    # sort below canonicalizes it.
    li = jnp.concatenate([start + j for j in range(mb)], axis=1)
    validf = jnp.concatenate([cnt_c > j for j in range(mb)], axis=1)
    li = jnp.where(validf, li, 0)
    total = jnp.sum(cnt_c, axis=1)
    overflow = jnp.sum(cnt - cnt_c, axis=1)

    if loc_packed is not None:
        packed = jnp.where(validf, loc_packed[li], jnp.int32(2**31 - 1))
        packed = jax.lax.sort(packed, dimension=1, is_stable=False)
        ok = packed != jnp.int32(2**31 - 1)
        tgt = jnp.where(ok, packed >> win_bits, TARGET_SENTINEL)
        win = jnp.where(ok, packed & jnp.int32((1 << win_bits) - 1),
                        jnp.int32(2**31 - 1))
    else:
        loc_pairs = jnp.stack([loc_tgt, loc_win], axis=1)[li]
        tgt = jnp.where(validf, loc_pairs[..., 0], TARGET_SENTINEL)
        win = jnp.where(validf, loc_pairs[..., 1], jnp.int32(2**31 - 1))
        tgt, win = jax.lax.sort((tgt, win), dimension=1, num_keys=2,
                                is_stable=True)
    return tgt, win, total, overflow


def lookup_matches(features, keys, offsets, loc_tgt, loc_win, lmax: int,
                   bucket_offsets=None, search_steps=None, loc_packed=None,
                   win_bits: int = 0):
    """Gather + sort the match lists for a batch of reads.

    Args:
      features: [B, NF] uint32 query features (FEATURE_SENTINEL = none).
                NF = windows_per_read * sketch_size (* 2 for pairs).
      keys:     [F] uint32 sorted feature keys (padded with sentinel)
      offsets:  [F+1] int32/int64 CSR offsets
      loc_tgt:  [L] int32
      loc_win:  [L] int32
      lmax:     static per-read match-list capacity
      loc_packed: optional [L] int32 pre-packed (tgt << win_bits | win)
                location table (FeatureTable.packed_locations). When given,
                the location fetch is a single-word gather and the per-read
                merge sort a single-key sort — half the memory traffic of
                the pair path.
      win_bits: static shift of the packed encoding (required with
                loc_packed).

    Returns:
      (tgt, win, total, overflow):
        tgt, win: [B, LMAX] int32 sorted by (tgt, win) ascending, padded
                  with TARGET_SENTINEL rows
        total:    [B] int32 number of valid matches (pre-truncation count
                  clamped to LMAX)
        overflow: [B] int32 number of dropped locations per read
    """
    B, NF = features.shape
    F = keys.shape[0]

    idx = global_lower_bound(keys, features, bucket_offsets, search_steps)
    idx = jnp.minimum(idx, F - 1)
    found = (keys[idx] == features) & (features != SENTINEL_U32)

    # fetch (offset[i], offset[i+1]) as one row-gather
    off_pairs = jnp.stack([offsets[:-1], offsets[1:]], axis=1)[idx]
    start = off_pairs[..., 0].astype(jnp.int32)
    cnt = (off_pairs[..., 1] - off_pairs[..., 0]).astype(jnp.int32)
    cnt = jnp.where(found, cnt, 0)

    # exclusive cumsum of counts = output slot of each feature's first location
    cum = jnp.cumsum(cnt, axis=1)
    total_all = cum[:, -1]
    cum_ex = cum - cnt

    # slot j of read b belongs to feature fi = #{features whose run ends <= j}
    # and reads location start[fi] + (j - cum_ex[fi]) — rank-by-sort
    # expansion (see _expand_slots).
    slots = jnp.arange(lmax, dtype=jnp.int32)
    li = _expand_slots(start, cum_ex, lmax)
    valid = slots[None, :] < jnp.minimum(total_all, lmax)[:, None]
    li = jnp.where(valid, li, 0)

    if loc_packed is not None:
        # single-word gather + single-key sort; lexicographic (tgt, win)
        # order == numeric packed order by construction
        packed = jnp.where(valid, loc_packed[li], jnp.int32(2**31 - 1))
        packed = jax.lax.sort(packed, dimension=1, is_stable=False)
        ok = packed != jnp.int32(2**31 - 1)
        tgt = jnp.where(ok, packed >> win_bits, TARGET_SENTINEL)
        win = jnp.where(ok, packed & jnp.int32((1 << win_bits) - 1),
                        jnp.int32(2**31 - 1))
    else:
        # fetch (tgt, win) as one row-gather from the interleaved table
        loc_pairs = jnp.stack([loc_tgt, loc_win], axis=1)[li]
        tgt = jnp.where(valid, loc_pairs[..., 0], TARGET_SENTINEL)
        win = jnp.where(valid, loc_pairs[..., 1], jnp.int32(2**31 - 1))

        # stable lexicographic sort by (tgt, win) per read
        tgt, win = jax.lax.sort((tgt, win), dimension=1, num_keys=2,
                                is_stable=True)

    total = jnp.minimum(total_all, lmax)
    overflow = jnp.maximum(total_all - lmax, 0)
    return tgt, win, total, overflow
