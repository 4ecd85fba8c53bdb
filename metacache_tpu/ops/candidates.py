"""Candidate generation: sorted per-read match lists -> top-k classification
candidates with contiguous-window-range hit counts.

Reference semantics reproduced (src/candidates.h:118-285):

  for_all_contiguous_window_ranges — slide over the (target, window)-sorted
  match list; for every right endpoint j the window range is the maximal
  suffix i..j of the same target with win_j - win_i < numWindows; a target's
  candidate is its *first* range achieving the maximal hit count (strict
  `hits > curBest.hits` update).

  best_distinct_matches_in_contiguous_window_ranges::insert — map each
  candidate taxon to its ancestor at `mergeBelow` (the query's lowest rank)
  if one exists; candidates with the same (merged) taxon keep the max hit
  count (strict update => first achiever wins ties); the final list is
  sorted by hits descending, ties in consume order (= ascending target id),
  truncated to maxCandidates.

Device formulation — the per-element computations are expressed without
gathers (whether that still pays on a GPU is not measured yet):

  * the sliding-window left boundary (a per-element lower bound) is computed
    by RANK-BY-SORT: queries (tgt, win-numWindows+1) are co-sorted with the
    match list; a query's rank among matches (= its lower bound) falls out
    of a cumulative count, and a second sort returns ranks to match order.
  * per-target segment maxima / first-achiever positions use segmented
    prefix scans (log-step shift/select, elementwise) instead of
    scatter-based segment reductions.
  * dedup-by-taxon and final top-k are lexicographic sorts.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import jax.numpy as jnp

from ..config import TARGET_SENTINEL

_BIG = np.int32(2**31 - 1)  # np scalar: no backend init at import


def _lower_bound_pairs(tgt, win, q_tgt, q_win):
    """Per-row lower bound over lexicographically sorted (tgt, win) pairs.

    Unrolled binary search (take_along_axis steps). Used for the *bounded*
    per-candidate window queries (small query counts); the per-element
    lower bounds in generate_candidates use rank-by-sort instead.
    """
    B, L = tgt.shape
    steps = max(1, L.bit_length())
    lo = jnp.zeros_like(q_tgt)
    hi = jnp.full_like(q_tgt, L)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        midc = jnp.minimum(mid, L - 1)
        mt = jnp.take_along_axis(tgt, midc, axis=1)
        mw = jnp.take_along_axis(win, midc, axis=1)
        less = (mt < q_tgt) | ((mt == q_tgt) & (mw < q_win))
        lo = jnp.where(less, mid + 1, lo)
        hi = jnp.where(less, hi, mid)
    return lo


def _rank_lower_bound_packed(pk, qk, L):
    """Packed-key variant of _rank_lower_bound: items pk and queries qk are
    single int32 keys ((tgt << win_bits) | win), both < 2^30, both sorted
    ascending per row. Returns the per-query lower bound [B, L].

    Two sorts like _rank_lower_bound, but with every operand packed:
      sort 1: ONE key (pk*2+1 / qk*2 — queries before items at equal key)
              + ONE payload (pos), vs 3 operands / 2 keys unpacked;
      sort 2: ONE operand ((flag, pos) packed with the rank), vs 2.
    Fewer sort operands move fewer bytes per sort.
    """
    B = pk.shape[0]
    pos = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[None, :], (B, L))
    c_key = jnp.concatenate([qk * 2, pk * 2 + 1], axis=1)
    c_pos = jnp.concatenate([pos, pos], axis=1)
    s_key, s_pos = jax.lax.sort((c_key, c_pos), dimension=1, num_keys=1,
                                is_stable=False)
    s_item = s_key & 1
    items_before = jnp.cumsum(s_item, axis=1)
    # route ranks back to query order with ONE packed operand:
    # (flag, pos, rank) -> (flag*P2 + pos)*RP + rank; queries (flag 0)
    # occupy the first L slots ordered by pos, rank decodes by mask
    P2 = 1 << int(max(1, L - 1)).bit_length()
    RP = 1 << int(L).bit_length()          # RP > L >= max rank
    bkey = (s_item * P2 + s_pos) * RP + items_before
    sb = jax.lax.sort(bkey, dimension=1, is_stable=False)
    return sb[:, :L] & (RP - 1)


def _rank_lower_bound(tgt, win, q_win):
    """left[b, j] = #{i : (tgt[b,i], win[b,i]) < (tgt[b,j], q_win[b,j])}
    via co-sorting matches and queries (rank-by-sort): two width-2L sorts
    and a cumsum instead of an unrolled take_along_axis binary search."""
    B, L = tgt.shape
    pos = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[None, :], (B, L))
    c_tgt = jnp.concatenate([tgt, tgt], axis=1)
    # pack (win, is_item) into one sort key: win*2 keeps the order (window
    # ids are indices, far below 2^30) and the LSB puts queries before
    # items at equal (tgt, win) => lower bound. One packed key replaces
    # two sort operands — sort bytes are the stage's cost.
    c_wkey = jnp.concatenate([q_win * 2, win * 2 + 1], axis=1)
    c_pay = jnp.concatenate([pos, pos], axis=1)
    s_tgt, s_wkey, s_pay = jax.lax.sort(
        (c_tgt, c_wkey, c_pay), dimension=1, num_keys=2, is_stable=False)
    s_item = s_wkey & 1
    items_before = jnp.cumsum(s_item, axis=1)
    # return ranks to query order: queries (is_item=0) first, by payload —
    # again as one packed key (item above the payload bits)
    P2 = 1 << int(2 * L - 1).bit_length()
    bkey = s_item * P2 + s_pay
    _, back = jax.lax.sort((bkey, items_before), dimension=1,
                           num_keys=1, is_stable=False)
    return back[:, :L]


def _onehot_map(values, idx):
    """values[idx] for a small table without the per-element gather: exact
    one-hot f32 matmuls with a 13-bit value split (same trick as
    classify_op._lineage_rows). Whether it beats the plain gather on a GPU
    is not measured yet. Requires 0 <= values < 2^26 and
    0 <= idx < len(values)."""
    T = values.shape[0]
    oh = (idx[..., None] == jax.lax.broadcasted_iota(
        jnp.int32, (1, 1, T), 2)).astype(jnp.float32)
    lo = (values & 0x1FFF).astype(jnp.float32)
    hi = (values >> 13).astype(jnp.float32)
    # Precision.HIGHEST: the 13-bit chunks must accumulate exactly; a lower
    # precision (bf16 passes, or TF32 on GPUs, exact only to 2^11) would
    # silently round them. f32 is exact to 2^24.
    mlo = jax.lax.dot_general(oh, lo, (((2,), (0,)), ((), ())),
                              preferred_element_type=jnp.float32,
                              precision=jax.lax.Precision.HIGHEST)
    mhi = jax.lax.dot_general(oh, hi, (((2,), (0,)), ((), ())),
                              preferred_element_type=jnp.float32,
                              precision=jax.lax.Precision.HIGHEST)
    return mlo.astype(jnp.int32) + (mhi.astype(jnp.int32) << 13)


def _prefix_max(x):
    """Inclusive prefix max along axis 1 via log-shift steps.

    log2(W) shifted elementwise maxima, chosen over lax.cummax for their
    much smaller generated code."""
    B, W = x.shape
    s = 1
    while s < W:
        shifted = jnp.concatenate(
            [jnp.full((B, s), np.iinfo(np.int32).min, x.dtype),
             x[:, :-s]], axis=1)
        x = jnp.maximum(x, shifted)
        s <<= 1
    return x


def _suffix_max(x):
    """Inclusive suffix max along axis 1 (mirror of _prefix_max)."""
    B, W = x.shape
    s = 1
    while s < W:
        shifted = jnp.concatenate(
            [x[:, s:], jnp.full((B, s), np.iinfo(np.int32).min, x.dtype)],
            axis=1)
        x = jnp.maximum(x, shifted)
        s <<= 1
    return x


def _segment_broadcast_max(values, new_seg, vmax: int):
    """Per-element max over the element's whole segment (contiguous runs
    marked by new_seg). `values` must lie in [0, vmax].

    Plain prefix max over segment-encoded values (seg_id * (vmax+1) + v is
    monotone across segment boundaries, so the running max resets
    automatically), then a suffix max with NEGATED segment bases (later
    segments encode strictly lower, so they never leak left) broadcasts
    each segment's total to all its elements. No jnp.flip: the reverse op
    costs ~1.5 MB of generated code per use on this backend."""
    K = jnp.int32(vmax + 1)
    seg = jnp.cumsum(new_seg.astype(jnp.int32), axis=1)
    fwd = _prefix_max(seg * K + values) - seg * K
    return _suffix_max(fwd - seg * K) + seg * K


def _segment_broadcast_min(values, new_seg, vmax: int):
    """min(v) = vmax - max(vmax - v); `values` must lie in [0, vmax]."""
    return vmax - _segment_broadcast_max(vmax - values, new_seg, vmax)


@functools.partial(jax.jit, static_argnames=("max_candidates", "win_bits",
                                             "ci_shift", "tax_onehot",
                                             "map_topk"))
def generate_candidates(tgt, win, num_windows, target_cand_tax,
                        max_candidates: int, win_bits: int = 0,
                        ci_shift: int = 0, tax_onehot: bool = False,
                        map_topk: bool = False):
    """Top-k candidates per read.

    Args:
      tgt, win: [B, L] int32 match lists sorted by (tgt, win); padding rows
                carry tgt == TARGET_SENTINEL.
      num_windows: [B] int32 per-read maxWindowsInRange
                   (2 + max(len1+len2, insertSizeMax)//stride,
                   src/classification.cpp:217-219)
      target_cand_tax: [T+1] int32 map target id -> candidate taxon node
                   (ancestor at the query's lowest rank if it exists, else
                   the target's own sequence-level taxon node). The last
                   entry is a scratch slot for the sentinel target.
      max_candidates: static top-k size.
      win_bits: static width of the DB's packed (tgt << win_bits | win)
                location encoding. When > 0 and the packed keys fit 30
                bits, every sort in this stage runs with packed
                single-word operands (less sort traffic). 0 falls back to
                the multi-operand formulation (result-identical).
      map_topk: the caller asserts target_cand_tax restricted to real
                targets is INJECTIVE (every target its own candidate
                taxon — e.g. sequence-level classification, or one
                genome per species as in BASELINE config-2). Dedup then
                keys on the raw target id (dedup-by-target ==
                dedup-by-taxon under a bijection) and only the C winning
                candidates' taxa are gathered from the map — a [B, C]
                gather instead of the [B, L] per-element map gather (the
                configurations where BOTH seg encoding (nci > 2048) and
                the one-hot map (operand bytes) are out of range).
      ci_shift: static bit position of a COMPACT CANDIDATE-TAXON INDEX
                baked into the tgt field: tgt = (ci << ci_shift) | raw_tgt
                (engine-side seg encoding). The dedup key is then just
                tgt >> ci_shift — replacing the [B, L] tiny-table gather
                target_cand_tax[tgt]. In this mode the "tax" output is ci + 1
                (compact index, 0 = empty) and "tgt" stays seg-encoded;
                the engine decodes both host-side. target_cand_tax is
                unused. Requires win_bits > 0 and the seg keys to pass the
                30-bit gate.

    Returns dict of [B, C] arrays: tax, hits, beg, end, tgt
      (tax==0 marks an empty candidate slot).
    """
    B, L = tgt.shape
    assert L <= 32768, "packed (hits, pos) sort key needs L*P2 < 2^31"
    T1 = target_cand_tax.shape[0]
    valid = tgt != TARGET_SENTINEL
    pos = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[None, :], (B, L))

    # static gates, independent knobs:
    #  - pk_ok: packed single-key rank-lower-bound — the (tgt, win) keys
    #    must fit 30 bits (pk*2+1 < 2^31 in the rank sort). In seg mode
    #    the CALLER guarantees the fit (it computed the max seg value).
    #  - hpl_ok: the (hits, pos, left) one-word payload pack must fit 31
    #    bits (holds for L <= 512; engine lmax defaults 256).
    P2 = 1 << int(max(1, L - 1)).bit_length()
    LP = 1 << int(L).bit_length()
    pk_ok = win_bits > 0 and (
        ci_shift > 0 or ((T1 - 1) << win_bits) <= 2**30 - 1)
    # the rank-by-sort back-route key (s_item*P2 + s_pos)*RP + rank in
    # _rank_lower_bound_packed must also fit int32 (RP == LP there);
    # overflows at L >= ~32768
    pk_ok = pk_ok and (P2 + L - 1) * LP + L < 2**31
    hpl_ok = (L * P2 + P2 - 1) * LP + L < 2**31
    if ci_shift > 0:
        assert win_bits > 0, "seg encoding requires the packed-key path"
    PK_PAD = jnp.int32(2**30 - 1)

    # ---- per-element contiguous-range hit count --------------------------
    if pk_ok:
        # items and window queries as single packed keys: the query
        # (tgt, max(win - numWindows + 1, 0)) is max(pk - (nw-1), segment
        # base) — clamping at the target's window 0 is exact because no
        # stored window id is negative
        pk_raw = (tgt << win_bits) | win
        pk = jnp.where(valid, pk_raw, PK_PAD)
        base = pk_raw & jnp.int32(~((1 << win_bits) - 1))
        qk = jnp.where(valid,
                       jnp.maximum(pk_raw - (num_windows[:, None] - 1), base),
                       PK_PAD)
        left = _rank_lower_bound_packed(pk, qk, L)
    else:
        q_win = win - num_windows[:, None] + 1
        left = _rank_lower_bound(tgt, win, q_win)
    hits = jnp.where(valid, pos - left + 1, 0).astype(jnp.int32)

    # ---- per-target best (segmented scans, first achiever) ---------------
    new_seg = jnp.concatenate(
        [jnp.ones((B, 1), dtype=jnp.bool_), tgt[:, 1:] != tgt[:, :-1]], axis=1)
    seg_best = _segment_broadcast_max(hits, new_seg, L)
    achiever = valid & (hits == seg_best)
    # sentinel L (> any pos) marks non-achievers; it can never equal pos
    first_pos = _segment_broadcast_min(jnp.where(achiever, pos, L),
                                       new_seg, L)
    rep = achiever & (pos == first_pos)

    # ---- map targets to candidate taxa (merge below lowest rank) ---------
    if ci_shift > 0:
        # compact taxon index from the seg-encoded high bits — NO gather
        # (dedup-by-ci == dedup-by-taxon: ci <-> taxon is a bijection);
        # +1 keeps 0 as the empty-slot marker
        key = jnp.where(rep, (tgt >> ci_shift) + 1, _BIG)
    elif map_topk:
        # injective map (caller-asserted): dedup by raw target id; the
        # winners' taxa are gathered AFTER the top-k cut ([B, C] only)
        key = jnp.where(rep, tgt + 1, _BIG)
    else:
        safe_tgt = jnp.where(valid, tgt, T1 - 1)
        # gate the [B, L, T1] f32 one-hot operand on BYTES, not target
        # count: at B=8192, L=256, T1=2048 it would be ~17 GB; cap at
        # 2 GiB (covers the realistic world's ~0.8 GB operand)
        if tax_onehot and T1 <= 2048 and B * L * T1 * 4 <= (2 << 30):
            # configurations whose seg keys don't fit 30 bits (config-3's
            # ci+tgt+win = 32) still avoid the per-element map gather:
            # the caller asserts node indices < 2^26 (same bound as the
            # packed summary word)
            mapped = _onehot_map(target_cand_tax, safe_tgt)
        else:
            mapped = target_cand_tax[safe_tgt]
        key = jnp.where(rep, mapped, _BIG)

    # ---- dedup by taxon: keep max hits, first achiever on ties -----------
    # (hits desc, pos asc) packs into ONE sort key: hp = (L-hits)*P2 + pos
    # (hits <= L, pos < L <= P2) — same lexicographic order, two fewer
    # sort operands, and hits/pos decode back by divmod.
    hp = (L - hits) * P2 + pos
    Cn = max_candidates
    if pk_ok and hpl_ok:
        # pack further: (hp, left) in one word (left <= L < LP; secondary
        # tie-break by left is inert — pos is already unique per row) and
        # (end, tgt) as the original packed location word. 3 sort operands
        # instead of 5, twice.
        hpl = hp * LP + left
        s_key, s_hpl, s_pk = jax.lax.sort(
            (key, hpl, pk_raw), dimension=1, num_keys=2, is_stable=False)
        first_of_key = jnp.concatenate(
            [jnp.ones((B, 1), dtype=jnp.bool_),
             s_key[:, 1:] != s_key[:, :-1]], axis=1)
        winner = first_of_key & (s_key != _BIG)

        o_hpl = jnp.where(winner, s_hpl, _BIG)
        f_hpl, f_key, f_pk = jax.lax.sort(
            (o_hpl, s_key, s_pk), dimension=1, num_keys=1, is_stable=False)
        top_ok = f_hpl[:, :Cn] != _BIG
        f_hp = f_hpl[:, :Cn] // LP
        f_hits = L - f_hp // P2
        top_left = jnp.clip(f_hpl[:, :Cn] & (LP - 1), 0, L - 1)
        f_end = f_pk[:, :Cn] & jnp.int32((1 << win_bits) - 1)
        f_tgt = f_pk[:, :Cn] >> win_bits
    else:
        s_key, s_hp, s_left, s_end, s_tgt = jax.lax.sort(
            (key, hp, left, win, tgt), dimension=1, num_keys=2,
            is_stable=False)
        first_of_key = jnp.concatenate(
            [jnp.ones((B, 1), dtype=jnp.bool_),
             s_key[:, 1:] != s_key[:, :-1]], axis=1)
        winner = first_of_key & (s_key != _BIG)

        # ---- final top-k by (hits desc, consume order asc) ----------------
        # = ascending hp; one single-key sort + slice instead of lax.top_k +
        # per-field take_along_axis gathers
        o_hp = jnp.where(winner, s_hp, _BIG)
        f_hp, f_key, f_left, f_end, f_tgt = jax.lax.sort(
            (o_hp, s_key, s_left, s_end, s_tgt), dimension=1,
            num_keys=1, is_stable=False)
        top_ok = f_hp[:, :Cn] != _BIG
        f_hits = L - f_hp[:, :Cn] // P2
        top_left = jnp.clip(f_left[:, :Cn], 0, L - 1)
        f_end = f_end[:, :Cn]
        f_tgt = f_tgt[:, :Cn]
    beg = jnp.take_along_axis(win, top_left, axis=1)
    out_tax = f_key[:, :Cn]
    if map_topk:
        # map only the C winners — [B, C] gather vs [B, L] per element
        out_tax = target_cand_tax[jnp.clip(f_tgt, 0, T1 - 1)]
    return {
        "tax": jnp.where(top_ok, out_tax, 0),
        "hits": jnp.where(top_ok, f_hits, 0),
        "beg": jnp.where(top_ok, beg, 0),
        "end": jnp.where(top_ok, f_end, 0),
        "tgt": jnp.where(top_ok, f_tgt, TARGET_SENTINEL),
    }


def merge_candidate_lists(cand_a, cand_b, max_candidates: int):
    """Merge two candidate dicts (e.g. from different database shards).

    Reproduces the cross-rank re-insertion of querying.h:958-971: same-taxon
    candidates keep the max hit count; the merged list is re-sorted by hits
    (descending) and truncated. Associative & commutative => shard-count
    invariant. Works on [B, C] dicts; returns [B, C] dict.
    """
    tax = jnp.concatenate([cand_a["tax"], cand_b["tax"]], axis=1)
    hits = jnp.concatenate([cand_a["hits"], cand_b["hits"]], axis=1)
    beg = jnp.concatenate([cand_a["beg"], cand_b["beg"]], axis=1)
    end = jnp.concatenate([cand_a["end"], cand_b["end"]], axis=1)
    tgt = jnp.concatenate([cand_a["tgt"], cand_b["tgt"]], axis=1)
    return _dedup_topk(tax, hits, beg, end, tgt, max_candidates)


def _dedup_topk(tax, hits, beg, end, tgt, max_candidates: int):
    """Dedup by taxon then order by (hits desc, winning target id asc).

    The target-id tie key is global, so merging per-shard lists commutes
    with single-shard candidate generation (the reference's tree merge is
    tie-UNstable across shard counts — std::upper_bound insertion at
    querying.h:958-971; we define the deterministic order instead).
    """
    B, L = tax.shape
    key = jnp.where(tax > 0, tax, _BIG)
    # dedup winner per taxon: max hits, smallest target id on ties
    s_key, s_neg, s_tgt, s_hits, s_beg, s_end = jax.lax.sort(
        (key, -hits, tgt, hits, beg, end), dimension=1, num_keys=3,
        is_stable=False)
    first = jnp.concatenate(
        [jnp.ones((B, 1), dtype=jnp.bool_), s_key[:, 1:] != s_key[:, :-1]],
        axis=1)
    winner = first & (s_key != _BIG)
    o_neg = jnp.where(winner, -s_hits, _BIG)
    o_tgt = jnp.where(winner, s_tgt, _BIG)
    f_neg, f_tgt, f_key, f_hits, f_beg, f_end = jax.lax.sort(
        (o_neg, o_tgt, s_key, s_hits, s_beg, s_end), dimension=1, num_keys=2,
        is_stable=False)
    ok = f_neg[:, :max_candidates] != _BIG
    cut = lambda a: jnp.where(ok, a[:, :max_candidates], 0)
    return {
        "tax": cut(f_key),
        "hits": cut(f_hits),
        "beg": cut(f_beg),
        "end": cut(f_end),
        "tgt": jnp.where(ok, f_tgt[:, :max_candidates], TARGET_SENTINEL),
    }
