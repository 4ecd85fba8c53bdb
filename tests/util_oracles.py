"""Direct transcriptions of reference algorithms, used as test oracles.

These are intentionally scalar/naive — line-for-line re-statements of the
semantics in src/candidates.h and src/classification.cpp — so the
vectorized device ops can be validated against them on random inputs.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple


def oracle_contiguous_ranges(matches: List[Tuple[int, int]], num_windows: int):
    """for_all_contiguous_window_ranges (src/candidates.h:118-180).

    matches: sorted list of (tgt, win). Yields per-target candidates
    (tgt, hits, beg, end) in consume order.
    """
    out = []
    if not matches:
        return out
    fst = 0
    hits = 1
    best = [matches[0][0], 1, matches[0][1], matches[0][1]]  # tgt,hits,beg,end
    for lst in range(1, len(matches)):
        if matches[lst][0] == best[0]:
            hits += 1
            while fst != lst and matches[lst][1] - matches[fst][1] >= num_windows:
                hits -= 1
                fst += 1
            if hits > best[1]:
                best = [best[0], hits, matches[fst][1], matches[lst][1]]
        else:
            out.append(tuple(best))
            fst = lst
            hits = 1
            best = [matches[lst][0], 1, matches[lst][1], matches[lst][1]]
    out.append(tuple(best))
    return out


def oracle_insert_candidates(per_target, tgt_to_tax, max_candidates: int):
    """best_distinct_matches_…::insert (src/candidates.h:236-285).

    per_target: consume-order list of (tgt, hits, beg, end)
    tgt_to_tax: maps tgt -> (tax_key, is_sequence_level)
    Returns list of dicts sorted by hits desc (insertion semantics).
    """
    top: List[dict] = []
    for tgt, hits, beg, end in per_target:
        tax, is_seq = tgt_to_tax[tgt]
        cand = {"tax": tax, "hits": hits, "beg": beg, "end": end, "tgt": tgt}
        if is_seq:
            # upper_bound by hits desc
            i = _upper_bound_desc(top, hits)
            if i != len(top) or len(top) < max_candidates:
                top.insert(i, cand)
                del top[max_candidates:]
        else:
            j = next((j for j, c in enumerate(top) if c["tax"] == tax), None)
            if j is not None:
                if hits > top[j]["hits"]:
                    top[j] = cand
                top[:j + 1] = sorted(top[:j + 1], key=lambda c: -c["hits"])
            else:
                i = _upper_bound_desc(top, hits)
                if i != len(top) or len(top) < max_candidates:
                    top.insert(i, cand)
                    del top[max_candidates:]
    return top


def _upper_bound_desc(top, hits):
    # first index where top[i].hits < hits (list sorted desc)
    lo, hi = 0, len(top)
    while lo < hi:
        mid = (lo + hi) // 2
        if top[mid]["hits"] >= hits:
            lo = mid + 1
        else:
            hi = mid
    return lo


def oracle_classify(cands: List[dict], ranked_lineage, hits_min: int,
                    hits_diff_fraction: float, highest_rank: int):
    """classify() (src/classification.cpp:235-265) over dense lineages.

    cands: list of {tax, hits}; ranked_lineage: [N, R] numpy array.
    Returns best node index (0 = unclassified).
    """
    import numpy as np
    if not cands or cands[0]["tax"] == 0:
        return 0
    if cands[0]["hits"] < hits_min:
        return 0

    def lca(a, b):
        la, lb = ranked_lineage[a], ranked_lineage[b]
        eq = (la == lb) & (la != 0)
        nz = eq.nonzero()[0]
        return int(la[nz[0]]) if len(nz) else 0

    def rank_of_first(node):
        row = ranked_lineage[node]
        nz = (row != 0).nonzero()[0]
        # rank of `node` itself = first lane where it appears
        for r in nz:
            if row[r] == node:
                return int(r)
        return ranked_lineage.shape[1]

    cur = cands[0]["tax"]
    thr = (cands[0]["hits"] - hits_min) * hits_diff_fraction \
        if cands[0]["hits"] > hits_min else 0.0
    for c in cands[1:]:
        if c["hits"] > thr:
            cur = lca(cur, c["tax"])
            if cur == 0 or rank_of_first(cur) > highest_rank:
                return 0
        else:
            break
    return cur if rank_of_first(cur) <= highest_rank else 0


def oracle_sketch_batch(codes, lens, k: int, sketch_size: int):
    """single_function_unique_min_hasher (src/hash_dna.h:50-182) over a
    batch of windows, in plain numpy: the sketch_size smallest distinct
    thomas_mueller hashes (src/hash_int.h:39-45) of the unambiguous
    canonical k-mers of each window.

    codes: [B, W] uint8 (0..3 = ACGT, anything else ambiguous);
    lens: [B] valid lengths. Returns [B, sketch_size] uint32, ascending,
    padded with 0xFFFFFFFF. The reverse complement is built from the
    complemented codes read backwards, independent of the device's
    bit-twiddled version."""
    import numpy as np
    codes = np.asarray(codes)
    B, W = codes.shape
    n = W - k + 1
    fwd = np.zeros((B, n), np.uint64)
    rev = np.zeros((B, n), np.uint64)
    ambig = np.zeros((B, n), bool)
    for j in range(k):
        c = codes[:, j:j + n].astype(np.uint64)
        ambig |= codes[:, j:j + n] > 3
        fwd = (fwd << np.uint64(2)) | (c & np.uint64(3))
        rev |= (np.uint64(3) - (c & np.uint64(3))) << np.uint64(2 * j)
    kmer = np.minimum(fwd, rev)
    m32 = np.uint64(0xFFFFFFFF)
    x = kmer
    for _ in range(2):
        x = (((x >> np.uint64(16)) ^ x) * np.uint64(0x45D9F3B)) & m32
    x = (x >> np.uint64(16)) ^ x
    valid = (np.arange(n)[None, :] + k <= np.asarray(lens)[:, None]) & ~ambig
    h = np.where(valid, x, m32)
    h = np.sort(h, axis=1)
    dup = np.zeros_like(valid)
    dup[:, 1:] = h[:, 1:] == h[:, :-1]
    h = np.sort(np.where(dup, m32, h), axis=1)
    out = np.full((B, sketch_size), m32, np.uint64)
    w = min(sketch_size, n)
    out[:, :w] = h[:, :w]
    return out.astype(np.uint32)
