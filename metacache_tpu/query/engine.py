"""Query engine: batched on-device read classification.

The device replacement for the reference's MPI+thread query engine
(query_batched_parallel2, src/querying.h:721-1173). Instead of per-thread
read blocks and a log2(P) candidate tree reduce, the pipeline is:

  host: stream reads -> pad into fixed [B, Lq] uint8 byte tensors
  device (one jitted program):
      encode -> per-window sketches -> feature lookup over the shard's
      feature table -> sorted match lists -> contiguous-window-range
      candidates -> (multi-shard: all-gather + deterministic merge) ->
      ranked-LCA classification
  host: format per-read output, accumulate statistics

Paired-end reads contribute the features of both mates to one match list
(accumulate_matches called for seq1 and seq2, src/querying.h:787-790), and
maxWindowsInRange is derived from the pair's combined length
(src/classification.cpp:217-219).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (ClassifyParams, QueryPipelineParams,
                      TARGET_SENTINEL)
from ..db.database import Database
from ..db.taxonomy import Rank
from ..ops import candidates as cand_ops
from ..ops import classify_op, encode, lookup, sketch


def _window_starts_static(max_len: int, window: int, stride: int) -> List[int]:
    """Static window start offsets covering reads up to max_len chars.

    Per-read window structure falls out automatically: windows starting at
    or beyond a read's length contain only padding (ambiguous) characters
    and contribute no features.
    """
    return [int(s) for s in encode.window_starts(max_len, window, stride)]


def compute_features(packed1, ambig1, lens1, packed2, ambig2, lens2,
                     *, k: int, sketch_size: int, window_size: int,
                     starts: Tuple[int, ...]):
    """Per-read query features: sketches of every window of both mates
    (accumulate_matches for seq1 and seq2, src/querying.h:787-790).
    Returns [B, NF] uint32, NF = 2 * len(starts) * sketch_size."""
    B = packed1.shape[0]
    codes1 = encode.unpack_codes(packed1, ambig1)
    codes2 = encode.unpack_codes(packed2, ambig2)
    feats = []
    for codes, lens in ((codes1, lens1), (codes2, lens2)):
        for s in starts:
            wcodes = codes[:, s:s + window_size]
            if wcodes.shape[1] < window_size:
                pad = jnp.full((B, window_size - wcodes.shape[1]), 255,
                               dtype=jnp.uint8)
                wcodes = jnp.concatenate([wcodes, pad], axis=1)
            wlen = jnp.clip(lens - s, 0, window_size)
            feats.append(sketch.sketch_windows(wcodes, wlen, k,
                                               sketch_size))
    return jnp.concatenate(feats, axis=1)


def local_candidates(packed1, ambig1, lens1, packed2, ambig2, lens2,
                     keys, offsets, loc_tgt, loc_win, target_cand_tax,
                     exclude_groups, target_groups, bucket_offsets,
                     loc_packed, start_tbl=None, cnt_tbl=None,
                     direct_tbl=None,
                     *, k: int, sketch_size: int, window_size: int,
                     window_stride: int, starts: Tuple[int, ...],
                     lmax: int, max_candidates: int, insert_size_max: int,
                     search_steps: int, win_bits: int, direct_mb: int = 0,
                     ci_shift: int = 0, tax_onehot: bool = False,
                     map_topk: bool = False):
    """Sketch -> lookup -> (clade exclusion) -> candidate generation over
    ONE feature-table (shard). Shared by the single-chip engine and each
    shard of the sharded engine (the reference runs the identical local
    pipeline on every rank before the candidate merge, querying.h:749-830).

    exclude_groups/target_groups implement clade exclusion
    (remove_hits_on_rank, src/classification.cpp:141-157): matches whose
    target's ancestor group equals the read's ground-truth group are
    discarded before candidate generation.

    Returns (cand dict, tgt [B,lmax], win [B,lmax], total [B], overflow [B]).
    """
    with jax.named_scope("sketch"):
        features = compute_features(
            packed1, ambig1, lens1, packed2, ambig2, lens2,
            k=k, sketch_size=sketch_size, window_size=window_size,
            starts=starts)

    if direct_mb > 0:
        # fast tier: static per-feature slot emission, no CSR expansion
        # (ops/lookup.lookup_matches_direct); overflow rows are re-run at
        # full width by QueryEngine.materialize
        tgt, win, total, overflow = lookup.lookup_matches_direct(
            features, keys, start_tbl, cnt_tbl, loc_tgt, loc_win,
            direct_mb, bucket_offsets=bucket_offsets,
            search_steps=search_steps, loc_packed=loc_packed,
            win_bits=win_bits, direct_tbl=direct_tbl)
    else:
        tgt, win, total, overflow = lookup.lookup_matches(
            features, keys, offsets, loc_tgt, loc_win, lmax,
            bucket_offsets=bucket_offsets, search_steps=search_steps,
            loc_packed=loc_packed, win_bits=win_bits)

    if exclude_groups is not None and target_groups is not None:
        T1 = target_groups.shape[0]
        # seg-encoded tgt fields carry the compact taxon index in the high
        # bits; target_groups is indexed by RAW target id
        raw = tgt if ci_shift == 0 else tgt & jnp.int32((1 << ci_shift) - 1)
        safe = jnp.where(tgt == TARGET_SENTINEL, T1 - 1, raw)
        excl = (target_groups[safe] == exclude_groups[:, None]) & \
            (exclude_groups[:, None] > 0)
        tgt = jnp.where(excl, TARGET_SENTINEL, tgt)
        win = jnp.where(excl, jnp.int32(2**31 - 1), win)
        # keep the list sorted after masking
        tgt, win = jax.lax.sort((tgt, win), dimension=1, num_keys=2,
                                is_stable=True)

    # maxWindowsInRange = 2 + max(len1+len2, insertSizeMax) / winstride
    # (src/classification.cpp:217-219)
    pair_len = jnp.maximum(lens1 + lens2, insert_size_max)
    num_windows = (2 + pair_len // window_stride).astype(jnp.int32)

    cand = cand_ops.generate_candidates(tgt, win, num_windows,
                                        target_cand_tax, max_candidates,
                                        win_bits=win_bits,
                                        ci_shift=ci_shift,
                                        tax_onehot=tax_onehot,
                                        map_topk=map_topk)
    return cand, tgt, win, total, overflow


def target_window_hits(cand, tgt, win, target_window_k: int):
    """Per-candidate window hit counts for the hits-per-target report
    (matches_per_target::insert, src/matches_per_target.h:111-155):
    counts of (cand.tgt, cand.beg + k) in the sorted match list. A target
    absent from this match list (other shard) yields all-zero counts, so
    per-shard results psum to the global counts."""
    K = target_window_k
    B, C = cand["tgt"].shape
    kk = jnp.arange(K, dtype=jnp.int32)
    q_win = (cand["beg"][:, :, None] + kk[None, None, :]).reshape(B, C * K)
    q_tgt = jnp.repeat(cand["tgt"], K, axis=1)
    lb = cand_ops._lower_bound_pairs(tgt, win, q_tgt, q_win)
    ub = cand_ops._lower_bound_pairs(tgt, win, q_tgt, q_win + 1)
    counts = (ub - lb).reshape(B, C, K)
    in_range = (cand["beg"][:, :, None] + kk[None, None, :]) <= \
        cand["end"][:, :, None]
    return jnp.where(in_range, counts, 0)


def make_target_groups(db: "Database", rank_code: int) -> np.ndarray:
    """[T+1] int32 map target id -> ancestor taxon at `rank_code` (the
    exclusion group of remove_hits_on_rank, src/classification.cpp:141-157);
    the trailing slot absorbs the sentinel target."""
    anc = db.taxonomy.ranked_lineage[:, rank_code].astype(np.int32)
    groups = np.zeros(db.target_count + 1, np.int32)
    groups[:-1] = anc[db.target_taxon_node]
    return groups


def fuse_host_inputs(p1, a1, l1, p2, a2, l2) -> np.ndarray:
    """Pack the six per-batch host arrays into ONE uint8 buffer so each
    dispatch pays a single host->device transfer instead of six."""
    B = p1.shape[0]
    l1b = np.ascontiguousarray(l1, dtype="<i4").view(np.uint8).reshape(B, 4)
    l2b = np.ascontiguousarray(l2, dtype="<i4").view(np.uint8).reshape(B, 4)
    return np.concatenate([p1, a1, l1b, p2, a2, l2b], axis=1)


def unfuse_device_inputs(fused, qlen: int):
    """Device-side inverse of fuse_host_inputs."""
    pw, aw = qlen // 4, qlen // 8
    o = 0
    p1 = fused[:, o:o + pw]; o += pw
    a1 = fused[:, o:o + aw]; o += aw
    l1 = jax.lax.bitcast_convert_type(fused[:, o:o + 4], jnp.int32); o += 4
    p2 = fused[:, o:o + pw]; o += pw
    a2 = fused[:, o:o + aw]; o += aw
    l2 = jax.lax.bitcast_convert_type(fused[:, o:o + 4], jnp.int32)
    return p1, a1, l1, p2, a2, l2


def fuse_host_inputs_slim(p1, l1, p2, l2, len_bytes: int) -> np.ndarray:
    """Slim wire format: 2-bit packed bases + u8/u16 lengths ONLY — no
    ambiguity bitplane (synthesized on device from the lengths,
    ops.encode.synth_ambig_from_lens). 100bp pairs drop from 104 to 54
    wire bytes. Reads WITH ambiguous characters are re-run through the
    legacy program by QueryEngine.materialize."""
    B = p1.shape[0]
    dt = "<u1" if len_bytes == 1 else "<u2"
    l1b = np.ascontiguousarray(l1.astype(dt)).view(np.uint8).reshape(
        B, len_bytes)
    l2b = np.ascontiguousarray(l2.astype(dt)).view(np.uint8).reshape(
        B, len_bytes)
    return np.concatenate([p1, p2, l1b, l2b], axis=1)


def fuse_host_inputs_slim1(p1, l1, len_bytes: int) -> np.ndarray:
    """Single-end slim wire: mate-1 packed bases + length ONLY — 27 B per
    100bp read instead of the paired slim format's 54 B, so single-end
    workloads (BASELINE config-2's 1M Illumina reads) do not ship an empty
    mate. Auto-selected per batch when every mate-2 length is zero
    (dispatch_packed detects the format by row width)."""
    B = p1.shape[0]
    dt = "<u1" if len_bytes == 1 else "<u2"
    l1b = np.ascontiguousarray(l1.astype(dt)).view(np.uint8).reshape(
        B, len_bytes)
    return np.concatenate([p1, l1b], axis=1)


def unfuse_device_inputs_slim1(fused, qlen: int, len_bytes: int):
    """Device-side inverse of fuse_host_inputs_slim1 (mate 2 empty)."""
    pw = qlen // 4
    p1 = fused[:, :pw]
    if len_bytes == 1:
        l1 = fused[:, pw].astype(jnp.int32)
    else:
        l1 = (fused[:, pw].astype(jnp.int32)
              | (fused[:, pw + 1].astype(jnp.int32) << 8))
    l2 = jnp.zeros_like(l1)
    p2 = jnp.zeros_like(p1)
    a1 = encode.synth_ambig_from_lens(l1, qlen)
    a2 = encode.synth_ambig_from_lens(l2, qlen)
    return p1, a1, l1, p2, a2, l2


def unfuse_device_inputs_slim(fused, qlen: int, len_bytes: int):
    """Device-side inverse of fuse_host_inputs_slim; the ambiguity planes
    are synthesized (padding-only) from the lengths."""
    pw = qlen // 4
    p1 = fused[:, :pw]
    p2 = fused[:, pw:2 * pw]
    o = 2 * pw
    if len_bytes == 1:
        l1 = fused[:, o].astype(jnp.int32)
        l2 = fused[:, o + 1].astype(jnp.int32)
    else:
        l1 = (fused[:, o].astype(jnp.int32)
              | (fused[:, o + 1].astype(jnp.int32) << 8))
        l2 = (fused[:, o + 2].astype(jnp.int32)
              | (fused[:, o + 3].astype(jnp.int32) << 8))
    a1 = encode.synth_ambig_from_lens(l1, qlen)
    a2 = encode.synth_ambig_from_lens(l2, qlen)
    return p1, a1, l1, p2, a2, l2


def pack_summary_word(best, best_rank):
    """(rank << 26) | node in one int32 — halves (or quarters) the
    per-batch result transfer. Valid while node indices stay < 2^26
    (guarded by QueryEngine._pack_ok) and rank codes < 32."""
    return (best_rank << 26) | best


def unpack_summary_word(v: np.ndarray):
    return (v & np.int32((1 << 26) - 1)).astype(np.int32), \
        (v >> 26).astype(np.int32)


@functools.partial(
    jax.jit,
    static_argnames=("k", "sketch_size", "window_size", "starts", "lmax",
                     "max_candidates", "highest_rank", "window_stride",
                     "insert_size_max", "target_window_k", "search_steps",
                     "win_bits", "qlen", "direct_mb",
                     "wire", "sfmt", "len_bytes", "ci_shift", "tax_onehot",
                     "map_topk"))
def _query_batch_device(fused,
                        keys, offsets, loc_tgt, loc_win, target_cand_tax,
                        ranked_lineage, hits_min, hits_diff,
                        exclude_groups=None, target_groups=None,
                        bucket_offsets=None, loc_packed=None,
                        start_tbl=None, cnt_tbl=None, direct_tbl=None,
                        *, k: int, sketch_size: int, window_size: int,
                        window_stride: int, starts: Tuple[int, ...],
                        lmax: int, max_candidates: int, highest_rank: int,
                        insert_size_max: int, qlen: int,
                        target_window_k: int = 0,
                        search_steps: int = None,
                        win_bits: int = 0, direct_mb: int = 0,
                        wire: str = "legacy", sfmt: str = "s4",
                        len_bytes: int = 1, ci_shift: int = 0,
                        tax_onehot: bool = False, map_topk: bool = False):
    """One fused device program: 2-bit-packed reads -> classification.

    When ci_shift > 0 the location words are seg-encoded (compact
    candidate-taxon index in the high bits, QueryEngine seg encoding):
    ranked_lineage must then be the engine's small per-candidate-taxon
    lineage table, cand["tax"] is ci + 1 and cand["tgt"] seg-encoded
    (decoded host-side by BatchResult)."""
    if wire == "slim":
        packed1, ambig1, lens1, packed2, ambig2, lens2 = \
            unfuse_device_inputs_slim(fused, qlen, len_bytes)
    elif wire == "slim1":
        packed1, ambig1, lens1, packed2, ambig2, lens2 = \
            unfuse_device_inputs_slim1(fused, qlen, len_bytes)
    else:
        packed1, ambig1, lens1, packed2, ambig2, lens2 = \
            unfuse_device_inputs(fused, qlen)
    cand, tgt, win, total, overflow = local_candidates(
        packed1, ambig1, lens1, packed2, ambig2, lens2,
        keys, offsets, loc_tgt, loc_win, target_cand_tax,
        exclude_groups, target_groups, bucket_offsets, loc_packed,
        start_tbl, cnt_tbl, direct_tbl,
        k=k, sketch_size=sketch_size, window_size=window_size,
        window_stride=window_stride, starts=starts, lmax=lmax,
        max_candidates=max_candidates, insert_size_max=insert_size_max,
        search_steps=search_steps, win_bits=win_bits, direct_mb=direct_mb,
        ci_shift=ci_shift, tax_onehot=tax_onehot, map_topk=map_topk)
    # fusion fence: keeps XLA from fusing across the candidates->classify
    # boundary, where fusion once made it re-layout the candidate stage on
    # GB-scale tables. The fence covers EVERY tensor that crosses out of
    # the candidate stage — classify inputs and program outputs alike.
    # Whether it pays on a GPU is not measured yet. Semantically a no-op.
    keys5 = ("tax", "hits", "beg", "end", "tgt")
    fenced = jax.lax.optimization_barrier(
        tuple(cand[k] for k in keys5) + (total, overflow))
    cand = dict(zip(keys5, fenced[:5]))
    total, overflow = fenced[5], fenced[6]
    best, best_rank = classify_op.classify_lca(
        cand["tax"], cand["hits"], ranked_lineage, hits_min, hits_diff,
        highest_rank)
    # the default output path needs only these [B] vectors; stacking them
    # lets BatchResult fetch them in ONE device->host transfer, and the
    # packed formats ("p1"/"p2") fold (rank << 26 | node) into a single
    # int32 word per read.
    if sfmt == "p1":        # exact direct tier: overflow provably zero
        summary = pack_summary_word(best, best_rank)[None, :]
    elif sfmt == "p2":
        summary = jnp.stack([pack_summary_word(best, best_rank), overflow])
    elif sfmt == "s2":
        summary = jnp.stack([best, best_rank])
    else:
        summary = jnp.stack([best, best_rank, total, overflow])
    out = {"cand": cand, "best": best, "best_rank": best_rank,
           "match_total": total, "match_overflow": overflow,
           "summary": summary}
    if target_window_k:
        out["target_window_hits"] = target_window_hits(cand, tgt, win,
                                                       target_window_k)
    return out


class BatchResult:
    """Result of one classified batch (first n valid reads).

    Fields are pulled from the device LAZILY on first access and cached:
    the common output path (per-read taxon only) fetches just
    `best`/`best_rank`/`match_overflow` (~50 KB) and leaves the candidate
    tensors on device unless -tophits/-locations/-align/-hits-per-seq
    actually need them.
    """

    _FIELDS = {
        "best": ("best",),
        "best_rank": ("best_rank",),
        "match_total": ("match_total",),
        "match_overflow": ("match_overflow",),
        "cand_tax": ("cand", "tax"),
        "cand_hits": ("cand", "hits"),
        "cand_beg": ("cand", "beg"),
        "cand_end": ("cand", "end"),
        "cand_tgt": ("cand", "tgt"),
        "target_window_hits": ("target_window_hits",),
    }

    def __init__(self, n: int, out: Dict, has_target_window_hits=False):
        self.n = n
        self._out = out
        self._has_twh = has_target_window_hits
        self._cache: Dict[str, Optional[np.ndarray]] = {}
        # patch tiers: [(row_indices, full-width out dict, offset), ...] —
        # rows re-classified through the legacy full-capacity program
        # (fast-tier overflow, or ambiguous-character reads under the slim
        # wire format); their results overwrite the fast-tier rows on
        # access. `offset` is where this batch's rows start inside the
        # (possibly cross-batch coalesced) re-run dispatch.
        self._patches: List = []

    def __getattr__(self, name):
        path = BatchResult._FIELDS.get(name)
        if path is None:
            raise AttributeError(name)
        cache = self.__dict__["_cache"]
        if name in cache:
            return cache[name]
        out = self.__dict__["_out"]
        patches = self.__dict__["_patches"]
        if "summary" in out and "_sum_done" not in cache:
            d = _decode_summary_host(out)
            if out.get("_zero_overflow") and "match_overflow" not in d:
                # exact direct tier: overflow provably all-zero —
                # synthesize instead of transferring
                d["match_overflow"] = np.zeros(out["summary"].shape[-1],
                                               np.int32)
            if patches:
                d = {f: np.array(v) for f, v in d.items()}
                for rows, patch_out, off in patches:
                    pd = _decode_summary_host(patch_out)
                    for f in d:
                        if f in pd:
                            d[f][rows] = pd[f][off:off + len(rows)]
            cache.update(d)
            cache["_sum_done"] = True
            if name in cache:
                return cache[name]
        # lazy device pull (candidate tensors, match_total under packed
        # summary formats, target_window_hits)
        if name == "target_window_hits" and not self._has_twh:
            cache[name] = None
        else:
            v = out
            for k in path:
                v = v[k]
            v = _to_host(v)
            if patches:
                v = np.array(v)
                for rows, patch_out, off in patches:
                    pv = patch_out
                    for k in path:
                        pv = pv[k]
                    v[rows] = _to_host(pv)[off:off + len(rows)]
            sd = out.get("_seg_decode")
            if sd is not None and name in ("cand_tax", "cand_tgt"):
                # seg encoding (QueryEngine): tax is a compact candidate-
                # taxon index + 1, tgt carries that index in its high bits
                shift, uniq = sd
                v = np.asarray(v)
                if name == "cand_tax":
                    v = np.where(v > 0, uniq[np.maximum(v - 1, 0)], 0)
                else:
                    from ..config import TARGET_SENTINEL as _TS
                    v = np.where(v == _TS, v,
                                 v & np.int32((1 << shift) - 1))
            cache[name] = v
        return cache[name]


def _summary_host(out) -> np.ndarray:
    """Host copy of an out dict's stacked summary tensor, preferring one
    pre-fetched by materialize_many's stacked transfer."""
    pre = out.get("_summary_host")
    return pre if pre is not None else _to_host(out["summary"])


def _decode_summary_host(out) -> Dict[str, np.ndarray]:
    """Decode an out dict's summary into named [B] host rows.

    Formats (static "sfmt" of _query_batch_device):
      p1: [1,B] (rank<<26|node)               — exact direct tier
      p2: [2,B] (rank<<26|node), overflow
      s2: [2,B] best, best_rank               — sharded direct tier
      s4: [4,B] best, best_rank, total, overflow
    """
    v = _summary_host(out)
    fmt = out.get("_sfmt") or {1: "p1", 2: "s2", 4: "s4"}[v.shape[0]]
    d: Dict[str, np.ndarray] = {}
    if fmt in ("p1", "p2"):
        d["best"], d["best_rank"] = unpack_summary_word(v[0])
        if fmt == "p2":
            d["match_overflow"] = v[1]
    else:
        d["best"], d["best_rank"] = v[0], v[1]
        if v.shape[0] >= 4:
            d["match_total"], d["match_overflow"] = v[2], v[3]
    return d


def _to_host(arr) -> np.ndarray:
    """Device -> host, handling multi-host replicated outputs (not fully
    addressable; read the local replica)."""
    if getattr(arr, "is_fully_addressable", True):
        return np.asarray(arr)
    return np.asarray(arr.addressable_shards[0].data)


def choose_direct_cap(sizes, nf: int, lmax_full: int, requested_cap: int):
    """Static per-feature location cap for the direct fast tier.

    requested_cap: 0 = auto (smallest cap in {2,4,6,8,12,16} achieving
    >=99.5% of the location coverage the LARGEST allowed cap would achieve,
    or the exact max bucket when small); -1 = disable; >0 = explicit. The
    static match width NF*cap must stay within lmax_full: a wider direct
    program would classify reads untruncated that a single-tier run
    truncates at lmax, silently changing the documented truncation
    contract.

    Coverage is measured RELATIVE to the best achievable cap, not to the
    raw location total: a heavy-tailed table (repeat elements at the
    254-location cap) has a tail no allowed cap can cover — those reads
    re-run at full width regardless, so a tail-chasing wide cap only
    doubles every sort width in the fast program. (Realistic bench world:
    absolute coverage never reaches 99.5% and the old rule ran to cap 8;
    relative coverage picks 4 — same re-run set to within ~1%, half the
    [B, NF*mb] sort width.)

    Returns (mb, exact): mb == 0 disables the direct tier; exact means the
    cap covers the table's max bucket (no read can ever overflow).
    """
    cap_limit = max(1, lmax_full // nf)
    max_bucket = int(sizes.max()) if len(sizes) else 0
    cap = requested_cap
    if cap == 0 and len(sizes):
        if max_bucket <= min(16, cap_limit):
            # small max bucket: cover it exactly — no overflow re-runs
            # AND no synchronous per-batch overflow pull
            cap = max_bucket
        else:
            best_c = min(16, cap_limit)
            coverable = float(np.minimum(sizes, best_c).sum())
            cap = -1
            for c in (2, 4, 6, 8, 12, 16):
                if c > cap_limit:
                    break
                cap = c
                if np.minimum(sizes, c).sum() >= 0.995 * coverable:
                    break
    elif cap > cap_limit:
        import warnings
        warnings.warn(
            f"fast_bucket_cap {cap} exceeds max_locations_per_query/"
            f"NF = {cap_limit}; disabling the direct fast tier to "
            f"preserve the truncation contract")
        cap = -1
    mb = 0 if cap < 0 else int(min(cap, max(1, max_bucket)))
    return mb, mb >= max_bucket


def estimate_overflow_fraction(sizes, loc_tgt, loc_win, cap: int,
                               total_windows: int) -> float:
    """Fraction of database windows containing at least one feature whose
    bucket exceeds `cap` — an empirical estimate of the read re-run rate a
    non-exact direct tier would incur (reads sketch the same windows the
    build did).

    This distinguishes the two heavy-tail regimes that a plain
    location-coverage number cannot: a CONCENTRATED tail (a repeat element
    at the 254 cap — few windows touch it, re-runs stay rare, the fast
    tier pays) vs a DIFFUSE tail (k-mer-space saturation at Gbp scale —
    at 5 Gbp the fused table's mean bucket is 3.4 and >80% of windows hold
    a >cap feature, so nearly every read re-runs and the fast tier is pure
    overhead). Cost: one repeat + one unique over only the heavy
    locations."""
    if total_windows <= 0 or len(sizes) == 0:
        return 0.0
    frac = count_heavy_windows(sizes, loc_tgt, loc_win, cap) / total_windows
    # a read pair queries two windows
    return float(min(1.0, 2.0 * frac))


def count_heavy_windows(sizes, loc_tgt, loc_win, cap: int) -> int:
    """Number of distinct (target, window) pairs holding at least one
    location of a feature whose bucket exceeds `cap`."""
    if len(sizes) == 0:
        return 0
    bs = np.repeat(sizes.astype(np.int32), sizes)
    heavy = bs > cap
    if not heavy.any():
        return 0
    key = (loc_tgt[heavy].astype(np.int64) << 32) | \
        loc_win[heavy].astype(np.int64)
    return len(np.unique(key))


#: maximum acceptable ESTIMATED re-run rate for a direct-tier cap. A
#: re-run dispatches a second, full-width program, so re-runs are weighted
#: heavily: the cap walk keeps the smallest cap whose estimated re-run
#: rate stays below this,
#: and disables the fast tier entirely (single-tier full-width, zero
#: re-runs) when no allowed cap qualifies — the diffuse-saturation regime
#: of Gbp-scale tables.
OVERFLOW_DISABLE_THRESHOLD = 0.10


def derive_seg_encoding(tct, target_count: int, n_nodes: int, win_bits: int,
                        packed, ranked_lineage):
    """Shared seg-encoding derivation (QueryEngine + ShardedQueryEngine).

    Bakes a compact candidate-taxon index (ci) into the high bits of every
    packed location word so the candidate stage's dedup taxon comes from
    bits instead of a per-element map gather, and classification runs
    against a small [nci+1, R] lineage table (one-hot matmul). The gate,
    bit layout, and small-lineage construction live HERE so the fused and
    sharded engines can never drift apart on the wire encoding.

    Args:
      tct: [T+1] int32 target -> candidate-taxon node map.
      packed: int32 packed (tgt << win_bits | win) location words (any
              shape; None disables).
      ranked_lineage: [n_nodes, R] np array.

    Returns (packed, seg_shift, uniq_tct, lineage_small) — seg_shift == 0
    means the encoding does not apply (packed returned unchanged).
    """
    if packed is None or target_count <= 0 or n_nodes >= (1 << 26):
        return packed, 0, None, None
    T = target_count
    uniq = np.unique(tct[:T])
    nci = len(uniq)
    tb = max(1, int(max(T - 1, 1)).bit_length())
    seg_max = ((nci - 1) << tb) | (T - 1)
    if nci + 1 > 2048 or (int(seg_max) << win_bits) * 2 + 1 >= 2**31:
        return packed, 0, None, None
    ci_of_t = np.searchsorted(uniq, tct[:T]).astype(np.int64)
    t_of_loc = packed.astype(np.int64) >> win_bits
    packed = (packed.astype(np.int64)
              | (ci_of_t[t_of_loc] << (tb + win_bits))).astype(np.int32)
    lineage_small = np.asarray(ranked_lineage)[
        np.concatenate([[0], uniq])].astype(np.int32)
    return packed, tb, uniq.astype(np.int32), lineage_small


class EngineBase:
    """Host-side engine machinery shared by the single-chip QueryEngine and
    the multi-chip ShardedQueryEngine: wire formats (slim/legacy fused input
    buffers), packed result summaries, two-tier dispatch with cross-batch
    coalesced overflow re-runs, and lazy batch materialization.

    Subclasses provide __init__ (device-resident tables + tier parameters)
    and _dispatch_tier(fused, exclude_groups, lmax, direct_mb, wire, sfmt)
    -> out dict with "summary" (+ "_sfmt")."""

    def update_runtime_thresholds(self, classify: "ClassifyParams"):
        """Adopt new hits_min / hits_diff_fraction without recompiling.

        Both are runtime device scalars, not program shape — a REPL line
        changing -hitmin/-hitdiff must reuse the loaded engine
        (mode_query.cpp:269-315 exists to amortize exactly this)."""
        self.classify = classify
        self.hits_min = classify.resolved_hits_min(
            self.db.sketch_params.sketch_size)
        self._hits_min_dev = jnp.int32(self.hits_min)
        self._hits_diff_dev = jnp.float32(classify.hits_diff_fraction)

    def make_host_buffers(self):
        B, L = self.pipeline.batch_size, self.pipeline.max_query_len
        return (np.zeros((B, L), np.uint8), np.zeros(B, np.int32),
                np.zeros((B, L), np.uint8), np.zeros(B, np.int32))

    def classify_batch(self, codes1, lens1, codes2, lens2, n: int,
                       exclude_groups=None) -> BatchResult:
        """Classify a (padded) batch; first `n` rows are valid reads."""
        p1, a1 = encode.np_pack_codes(codes1)
        p2, a2 = encode.np_pack_codes(codes2)
        return self.classify_batch_packed(p1, a1, lens1, p2, a2, lens2, n,
                                          exclude_groups=exclude_groups)

    def classify_batch_packed(self, p1, a1, lens1, p2, a2, lens2, n: int,
                              exclude_groups=None) -> BatchResult:
        """Classify a batch already in packed form (see native.mcio /
        ops.encode.np_pack_codes). Synchronous wrapper over dispatch."""
        out = self.dispatch_packed(p1, a1, lens1, p2, a2, lens2,
                                   exclude_groups=exclude_groups)
        return self.materialize(out, n)

    def _main_sfmt(self) -> str:
        if not self._pack_ok:
            return "s4"
        if self._direct_mb > 0 and self._direct_exact:
            return "p1"
        return "p2"

    def precompute_wire(self, p1, a1, lens1, p2, a2, lens2):
        """Host-side wire buffer + ambiguous-row indices, reusable across
        dispatches of the same batch (dispatch_packed(wire=...)). Lets
        readers/pipelines overlap or amortize the packing work."""
        if self._wire == "slim":
            qlen = self.pipeline.max_query_len
            lens2arr = np.asarray(lens2)
            if lens2arr.size and int(lens2arr.max()) == 0:
                # single-end batch: ship only mate 1 (27 vs 54 B/read —
                # the wire is the floor in degraded service windows)
                fused = fuse_host_inputs_slim1(p1, lens1, self._len_bytes)
            else:
                fused = fuse_host_inputs_slim(p1, lens1, p2, lens2,
                                              self._len_bytes)
            ambig = np.zeros(p1.shape[0], bool)
            if a1 is not None:
                ambig |= encode.np_rows_with_ambiguity(a1, lens1, qlen)
            if a2 is not None:
                ambig |= encode.np_rows_with_ambiguity(a2, lens2, qlen)
            ambig_rows = np.nonzero(ambig)[0]
        else:
            fused = fuse_host_inputs(p1, a1, lens1, p2, a2, lens2)
            ambig_rows = np.zeros(0, np.int64)
        return fused, ambig_rows

    def dispatch_packed(self, p1, a1, lens1, p2, a2, lens2,
                        exclude_groups=None, wire=None):
        """Enqueue the device program; returns on-device outputs without
        blocking (JAX dispatch is async), enabling host/device overlap —
        the device counterpart of the reference's reader/worker thread
        overlap (src/querying.h:749-830). Runs the narrow fast-tier program
        over the slim wire format; materialize() re-runs overflowing reads
        and reads containing ambiguous characters at full legacy capacity.
        `wire`: optional precompute_wire() result for this exact batch."""
        eg = None if exclude_groups is None else np.asarray(exclude_groups)
        sfmt = self._main_sfmt()
        fused, ambig_rows = wire if wire is not None else \
            self.precompute_wire(p1, a1, lens1, p2, a2, lens2)
        wire_fmt = self._wire
        if wire_fmt == "slim":
            # the single-end format is detected by row width (pw+len_bytes
            # vs 2*(pw+len_bytes)) so precompute_wire results stay a
            # 2-tuple for callers
            pw = self.pipeline.max_query_len // 4
            if fused.shape[1] == pw + self._len_bytes:
                wire_fmt = "slim1"
        out = self._dispatch_tier(fused, exclude_groups, self.lmax_fast,
                                  direct_mb=self._direct_mb,
                                  wire=wire_fmt, sfmt=sfmt)
        if self._direct_mb > 0 and self._direct_exact:
            # overflow is provably all-zero in the exact direct tier (every
            # feature's full location list fits the static per-feature cap)
            out["_zero_overflow"] = True
        out["_inputs"] = (p1, a1, lens1, p2, a2, lens2, eg)
        out["_ambig_rows"] = ambig_rows
        out["_need_overflow"] = (
            (self._direct_mb > 0 and not self._direct_exact)
            or (self._direct_mb == 0 and self.lmax_fast < self.lmax_full))
        return out

    def _rerun_rows(self, out, n: int) -> np.ndarray:
        """Row indices of this batch that must re-run through the
        full-width legacy program (fast-tier overflow + slim-wire
        ambiguous reads)."""
        rows = out.get("_ambig_rows")
        rows = rows[rows < n] if rows is not None else np.zeros(0, np.int64)
        if out.get("_need_overflow"):
            ovf = _decode_summary_host(out).get("match_overflow")
            if ovf is None:
                ovf = np.asarray(_to_host(out["match_overflow"]))
            orows = np.nonzero(np.asarray(ovf)[:n] > 0)[0]
            rows = np.union1d(rows, orows)
        return np.asarray(rows, np.int64)

    def _dispatch_reruns(self, specs):
        """Re-classify rows through the full-width legacy-wire program,
        COALESCING rows across batches into full rerun-batch dispatches.

        specs: [(res, out, rows), ...]. Without coalescing, a dispatch
        window whose every batch overflows a few rows pays one full-width
        dispatch PER BATCH (~3% occupancy on the realistic workload);
        packing rows across batches cuts the number of heavy-program
        executions by that same factor."""
        RB = self._rerun_batch
        prep = []
        for res, out, rows in specs:
            p1, a1, l1, p2, a2, l2, eg = out["_inputs"]
            if a1 is None or a2 is None:
                # inputs arrived without ambiguity planes: synthesize empty
                a1 = np.zeros((p1.shape[0], p1.shape[1] // 2), np.uint8)
                a2 = np.zeros_like(a1)
            prep.append((res, rows, (p1, a1, l1, p2, a2, l2), eg))
        any_eg = any(eg is not None for _, _, _, eg in prep)
        # pack (batch, row-subrange) spans into RB-row chunks
        chunks, cur, fill = [], [], 0
        for pi, (_, rows, _, _) in enumerate(prep):
            o = 0
            while o < len(rows):
                take = min(RB - fill, len(rows) - o)
                cur.append((pi, rows[o:o + take]))
                fill += take
                o += take
                if fill == RB:
                    chunks.append(cur)
                    cur, fill = [], 0
        if cur:
            chunks.append(cur)
        for chunk in chunks:
            parts = [[] for _ in range(6)]
            eg_parts = []
            total = 0
            for pi, sub in chunk:
                _, _, fields, eg = prep[pi]
                for fi, f in enumerate(fields):
                    parts[fi].append(f[sub])
                if any_eg:
                    eg_parts.append(eg[sub] if eg is not None
                                    else np.zeros(len(sub), np.int32))
                total += len(sub)
            pad = RB - total

            def cat(lst):
                a = np.concatenate(lst) if len(lst) > 1 else lst[0]
                if pad:
                    a = np.concatenate(
                        [a, np.zeros((pad,) + a.shape[1:], a.dtype)])
                return a

            fused2 = fuse_host_inputs(*(cat(p) for p in parts))
            out2 = self._dispatch_tier(
                fused2, cat(eg_parts) if any_eg else None,
                self.lmax_full, wire="legacy", sfmt="s4")
            off = 0
            for pi, sub in chunk:
                prep[pi][0]._patches.append((sub, out2, off))
                off += len(sub)

    def materialize(self, out, n: int) -> BatchResult:
        """Wrap a dispatched batch; fields transfer lazily on access.

        Patch tiers: reads whose match count exceeded the fast tier's
        capacity — and, under the slim wire format, reads containing
        ambiguous characters (whose bitplane was not shipped) — are
        re-classified through the full-width legacy program and their rows
        patched into the result, so truncation only ever happens at
        max_locations_per_query, exactly as in a single-tier run."""
        res = BatchResult(n, out,
                          has_target_window_hits=bool(self.target_window_k))
        rows = self._rerun_rows(out, n)
        if len(rows):
            self._dispatch_reruns([(res, out, rows)])
        return res

    def materialize_many(self, items) -> List[BatchResult]:
        """Materialize several dispatched batches at once.

        All pending summaries are stacked ON DEVICE and fetched in ONE
        device->host transfer (one round trip per window, not per batch); the
        overflow/ambiguity re-runs of ALL batches are then coalesced into
        full rerun-batch dispatches (_dispatch_reruns) and their summaries
        fetched in one more stacked transfer.

        items: [(out, n), ...] as returned by dispatch_packed.
        """
        outs = [o for o, _ in items]
        if outs and all(
                "summary" in o and getattr(o["summary"],
                                           "is_fully_addressable", True)
                for o in outs):
            host = np.asarray(jnp.stack([o["summary"] for o in outs]))
            for o, h in zip(outs, host):
                o["_summary_host"] = h
        results = []
        specs = []
        for o, n in items:
            res = BatchResult(
                n, o, has_target_window_hits=bool(self.target_window_k))
            results.append(res)
            rows = self._rerun_rows(o, n)
            if len(rows):
                specs.append((res, o, rows))
        if specs:
            self._dispatch_reruns(specs)
        pouts, seen = [], set()
        for r in results:
            for _, pout, _ in r._patches:
                if id(pout) not in seen:
                    seen.add(id(pout))
                    pouts.append(pout)
        if pouts and all(
                "summary" in p and getattr(p["summary"],
                                           "is_fully_addressable", True)
                for p in pouts):
            ph = np.asarray(jnp.stack([p["summary"] for p in pouts]))
            for p, h in zip(pouts, ph):
                p["_summary_host"] = h
        return results




class QueryEngine(EngineBase):
    """Holds device-resident database arrays + compiled pipeline."""

    def __init__(self, db: Database, classify: ClassifyParams,
                 pipeline: QueryPipelineParams = QueryPipelineParams(),
                 devices=None, target_window_k: int = 0):
        self.db = db
        self.classify = classify
        self.pipeline = pipeline
        self.target_window_k = target_window_k
        p = db.query_sketch_params
        self.sketch_params = p
        # threshold deduced from the TARGET sketcher's size, like
        # adapt_options_to_database (src/mode_query.cpp:247-260)
        self.hits_min = classify.resolved_hits_min(
            db.sketch_params.sketch_size)
        self.lowest_rank = Rank.SEQUENCE if classify.lowest_rank is None \
            else _rank_code(classify.lowest_rank)
        self.highest_rank = _rank_code(classify.highest_rank)
        self.starts = tuple(_window_starts_static(
            pipeline.max_query_len, p.window_size, p.window_stride))

        import os

        # two-tier match-list capacity: batches run through a narrow fast
        # program sized for the TYPICAL per-read match count; the rare reads
        # that overflow it re-run through the full-width program.
        self.lmax_full = pipeline.max_locations_per_query
        fast = pipeline.fast_locations_per_query
        if fast <= 0:
            nf = 2 * len(self.starts) * p.sketch_size
            sizes = db.features.bucket_sizes()
            mean_b = float(sizes.mean()) if len(sizes) else 1.0
            est = int(nf * mean_b * 2)           # 2x headroom over typical
            fast = 1 << max(6, max(1, est - 1).bit_length())
        self.lmax_fast = max(64, min(self.lmax_full, fast))
        self._rerun_batch = 1024                 # overflow re-run shape

        keys, offsets, loc_tgt, loc_win = db.features.device_arrays()
        bucket_offsets, self._search_steps = lookup.build_radix_index(keys)
        self._bucket_offsets = jnp.asarray(bucket_offsets)
        self._keys = jnp.asarray(keys)
        self._offsets = jnp.asarray(offsets)
        packed, self._win_bits = db.features.packed_locations()
        # seg encoding: bake a compact candidate-taxon index (ci) into the
        # high bits of every packed location word, so the candidate stage
        # reads the dedup taxon from bits instead of a [B, L] tiny-table
        # gather, and classification runs against a
        # [nci+1, R] lineage table via an exact one-hot matmul
        # (ops/classify_op._lineage_rows) instead of full-table row
        # gathers. Result-identical: ci <-> candidate taxon is a bijection.
        tct_np = np.asarray(db.target_cand_tax(self.lowest_rank))
        n_nodes = int(db.taxonomy.ranked_lineage.shape[0])
        packed, self._seg_shift, self._uniq_tct, lin_small = \
            derive_seg_encoding(tct_np, db.target_count, n_nodes,
                                self._win_bits, packed,
                                db.taxonomy.ranked_lineage)
        self._lineage_small = (jnp.asarray(lin_small)
                               if lin_small is not None else None)
        # injective target->candidate-taxon map (e.g. one genome per
        # species): candidates can dedup by raw target id and gather only
        # the top-k winners' taxa — the fallback for worlds where both
        # seg encoding and the one-hot map are out of range (config-2)
        self._map_topk = bool(
            self._seg_shift == 0 and db.target_count > 0
            and len(np.unique(tct_np[:db.target_count]))
            == db.target_count)
        if packed is None:
            self._loc_tgt = jnp.asarray(loc_tgt)
            self._loc_win = jnp.asarray(loc_win)
        else:
            # dead operands under the packed single-word path: a [1] dummy
            # instead of 2 x 4 B/location of device memory (5.4 GB at
            # config-3 scale)
            self._loc_tgt = self._loc_win = jnp.zeros(1, jnp.int32)

        # direct fast-tier lookup: flat (start, cnt) tables + a static
        # per-feature location cap covering >=99.5% of stored locations
        # (heavier buckets route their reads to the full-width re-run).
        # The static match width NF*cap must stay within
        # max_locations_per_query: a wider direct program would classify
        # reads untruncated that a single-tier run truncates at lmax,
        # silently changing the documented truncation contract (and the
        # sharded engine applies the same guard, parallel/sharding.py).
        nf = 2 * len(self.starts) * p.sketch_size
        sizes = np.diff(np.asarray(offsets))
        self._direct_mb, self._direct_exact = choose_direct_cap(
            sizes, nf, self.lmax_full, pipeline.fast_bucket_cap)
        if self._direct_mb > 0 and not self._direct_exact \
                and pipeline.fast_bucket_cap == 0:
            # refine the coverage-based cap with the EMPIRICAL re-run
            # estimate: walk the allowed caps from widest down and keep the
            # smallest whose estimated re-run rate stays under threshold
            # (estimate_overflow_fraction). Realistic bench world: cap 8
            # (the 5..8-bucket chance collisions are scattered over ~20% of
            # windows, so narrower caps explode the re-run rate even though
            # they cover 99.6% of locations); config-3 scale: every
            # allowed cap fails (diffuse k-mer-space saturation) -> 0 =
            # single-tier full-width, no re-runs.
            total_w = int(db.taxonomy.source_windows.sum())
            cap_limit = max(1, self.lmax_full // nf)
            best = 0
            for c in sorted((c for c in (2, 4, 6, 8, 12, 16)
                             if c <= cap_limit), reverse=True):
                est = estimate_overflow_fraction(sizes, loc_tgt, loc_win,
                                                 c, total_w)
                if est > OVERFLOW_DISABLE_THRESHOLD:
                    break
                best = c
            self._direct_mb = best
        self._start_tbl = jnp.asarray(offsets[:-1].astype(np.int32))
        self._cnt_tbl = jnp.asarray(sizes.astype(np.int32))
        self._loc_packed = None if packed is None else jnp.asarray(packed)
        # padded row-gather table for the direct tier (build_direct_table),
        # gated behind a device-memory budget ((mb+1)/mean_bucket x the
        # location array — huge DBs fall back to the flat gather). The
        # 2048 MB default is untuned on the H100.
        self._direct_tbl = None
        if self._direct_mb > 0 and packed is not None:
            import os as _os
            budget_mb = float(_os.environ.get("METACACHE_DIRECT_TBL_MB",
                                              "2048"))
            need_mb = len(sizes) * (self._direct_mb + 1) * 4 / 1e6
            if need_mb <= budget_mb:
                self._direct_tbl = jnp.asarray(lookup.build_direct_table(
                    np.asarray(offsets[:-1]), sizes.astype(np.int32),
                    packed, self._direct_mb))
        self._tct = jnp.asarray(tct_np)
        self._lineage = jnp.asarray(db.taxonomy.ranked_lineage)
        # classification thresholds as device-resident scalars: creating
        # them per dispatch costs two extra host->device copies per batch
        self._hits_min_dev = jnp.int32(self.hits_min)
        self._hits_diff_dev = jnp.float32(classify.hits_diff_fraction)

        # wire/summary formats: slim wire (no ambiguity plane, short
        # lengths) + packed one-word summaries, few bytes per read each
        # way. METACACHE_WIRE=legacy restores the
        # round-2 format (bit-identical results either way — ambiguous
        # reads re-run through the legacy program, tests/test_slim_wire).
        qlen = pipeline.max_query_len
        self._wire = "legacy" if os.environ.get(
            "METACACHE_WIRE") == "legacy" or qlen % 8 != 0 else "slim"
        self._len_bytes = 1 if qlen <= 255 else 2
        n_nodes = int(db.taxonomy.ranked_lineage.shape[0])
        n_ranks = int(db.taxonomy.ranked_lineage.shape[1])
        self._pack_ok = n_nodes < (1 << 26) and n_ranks + 1 < 32

    # ------------------------------------------------------------- batching
    def set_exclusion(self, rank_code: int):
        """Enable clade exclusion on the given rank: per-read exclusion
        groups must then be passed to classify_batch."""
        anc = self.db.taxonomy.ranked_lineage[:, rank_code].astype(np.int32)
        groups = np.zeros(self.db.target_count + 1, np.int32)
        groups[:-1] = anc[self.db.target_taxon_node]
        self._target_groups = jnp.asarray(groups)
        self.exclude_rank = rank_code

    def exclusion_group_of(self, node: int) -> int:
        if node == 0:
            return 0
        return int(self.db.taxonomy.ranked_lineage[node, self.exclude_rank])

    def _dispatch_tier(self, fused, exclude_groups, lmax: int,
                       direct_mb: int = 0, wire: str = "legacy",
                       sfmt: str = "s4"):
        out = _query_batch_device(
            jnp.asarray(fused),
            self._keys, self._offsets, self._loc_tgt, self._loc_win,
            self._tct,
            self._lineage_small if self._seg_shift else self._lineage,
            self._hits_min_dev, self._hits_diff_dev,
            exclude_groups if exclude_groups is None
            else jnp.asarray(exclude_groups),
            None if exclude_groups is None else self._target_groups,
            self._bucket_offsets,
            self._loc_packed,
            self._start_tbl, self._cnt_tbl,
            self._direct_tbl if direct_mb > 0 else None,
            k=self.sketch_params.kmer_size,
            sketch_size=self.sketch_params.sketch_size,
            window_size=self.sketch_params.window_size,
            window_stride=self.sketch_params.window_stride,
            starts=self.starts,
            lmax=lmax,
            max_candidates=self.classify.max_candidates,
            highest_rank=self.highest_rank,
            insert_size_max=self.classify.insert_size_max,
            qlen=self.pipeline.max_query_len,
            target_window_k=self.target_window_k,
            search_steps=self._search_steps,
            win_bits=self._win_bits, direct_mb=direct_mb,
            wire=wire, sfmt=sfmt, len_bytes=self._len_bytes,
            ci_shift=self._seg_shift,
            tax_onehot=self._seg_shift == 0 and self._pack_ok,
            map_topk=self._map_topk)
        out["_sfmt"] = sfmt
        if self._seg_shift:
            out["_seg_decode"] = (self._seg_shift, self._uniq_tct)
        return out


def _rank_code(rank) -> int:
    if isinstance(rank, int):
        return rank
    from ..db.taxonomy import rank_from_name
    return rank_from_name(rank)


def encode_read_into(buf_codes: np.ndarray, buf_lens: np.ndarray, row: int,
                     data: str, max_len: int):
    """Encode one read into a host batch buffer row (truncating at max_len)."""
    raw = np.frombuffer(data[:max_len].encode(), dtype=np.uint8)
    codes = encode.np_encode_bytes(raw)
    buf_codes[row, :len(codes)] = codes
    buf_codes[row, len(codes):] = 255
    buf_lens[row] = len(codes)
