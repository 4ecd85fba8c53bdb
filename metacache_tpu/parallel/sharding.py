"""Multi-chip sharded query: database shards across a device mesh.

The device-mesh replacement for the reference's MPI query distribution
(query_batched_parallel2, src/querying.h:721-1173):

  reference                                this module
  ---------                                -----------
  per-rank DB shard file (t % P == rank)   feature-table shard per device,
                                           stacked [P, F] + NamedSharding
  every rank reads the same read block     read batch replicated to devices
  log2(P) MPI_Send/Recv candidate tree     all_gather of fixed-shape [B, C]
  + re-insert into per-qid lists           candidate tensors (NVLink) +
                                           deterministic dedup/top-k merge
  rank 0 classifies + formats              classification computed
                                           replicated; host 0 formats

The merge is associative/commutative (max hits per taxon), so results are
shard-count invariant (each target's matches live wholly on one shard).

The host-side machinery — slim wire format (2-bit packed bases + short
lengths in ONE fused buffer), packed one-word summaries, and the two-tier
dispatch whose overflow/ambiguity re-runs are coalesced across batches —
is inherited from query.engine.EngineBase, so the sharded engine ships the
same minimal wire as the single-chip engine: per-shard overflow counts are
psum'd and overflowing reads re-run through the full-width sharded program
(the reference's unbounded per-rank location vectors, querying.h:804-833,
make the cap a device-side fixed-shape knob; re-runs keep it semantically
invisible below max_locations_per_query).

Every per-read feature of the single-chip engine is available here with
identical semantics (the local pipeline is literally the same function,
query.engine.local_candidates): clade exclusion, the packed-location
single-key fast path, and per-candidate window
hit counts (-hits-per-seq) — the latter computed against each shard's
local match list and psum'd (a target's matches live wholly on one shard,
so per-shard counts sum to the reference's global counts,
src/matches_per_target.h:111-155).
"""
from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import ClassifyParams, QueryPipelineParams
from ..db.database import Database
from ..ops import candidates as cand_ops
from ..ops import classify_op, lookup
from ..query.engine import (BatchResult, EngineBase, _rank_code,
                            _window_starts_static, choose_direct_cap,
                            local_candidates, make_target_groups,
                            pack_summary_word, target_window_hits,
                            unfuse_device_inputs, unfuse_device_inputs_slim)


def make_mesh(devices=None, axis: str = "shard") -> Mesh:
    """Mesh over the given (default: ALL, incl. other hosts') devices."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


def stack_shard_tables(dbs: List[Database], pad_keys_to=None,
                       pad_locs_to=None, win_bits: int = 0):
    """Pad shard feature tables to common sizes and stack to [P_local, ...].

    Multi-host: every process must pad to the same (global) sizes; pass the
    globally agreed pad_keys_to/pad_locs_to/win_bits (ShardedQueryEngine).

    Returns (keys, offsets, tgts, wins, packed) — packed is None unless
    every shard packs with the common win_bits.
    """
    fmax = pad_keys_to or max(d.features.num_keys for d in dbs)
    lmax = pad_locs_to or max(d.features.num_locations for d in dbs)
    keys, offsets, tgts, wins, packs = [], [], [], [], []
    for d in dbs:
        k, o, t, w = d.features.device_arrays(pad_keys_to=fmax,
                                              pad_locs_to=lmax)
        keys.append(k)
        offsets.append(o.astype(np.int32))
        tgts.append(t)
        wins.append(w)
        if win_bits and packs is not None:
            p, wb = d.features.packed_locations(pad_locs_to=lmax,
                                                win_bits=win_bits)
            packs = None if p is None else packs + [p]
    packed = np.stack(packs) if win_bits and packs else None
    return (np.stack(keys), np.stack(offsets), np.stack(tgts),
            np.stack(wins), packed)


class ShardedQueryEngine(EngineBase):
    """Query engine over a device mesh: one database shard per device.

    API-compatible with query.engine.QueryEngine (classify_batch,
    dispatch_packed/materialize/materialize_many, set_exclusion,
    target_window_k); the host-side wire/tier/re-run machinery is shared
    (EngineBase)."""

    def __init__(self, dbs: List[Database], classify: ClassifyParams,
                 pipeline: QueryPipelineParams = QueryPipelineParams(),
                 mesh: Optional[Mesh] = None, target_window_k: int = 0):
        """dbs: this process's shards, in mesh-device order. Single-process:
        all shards. Multi-process (jax.distributed initialized): only the
        shards owned by this host's devices — shard s belongs to global
        device s, mirroring the reference's per-rank DB files
        (mode_query.cpp:421-426)."""
        from . import distributed as dist
        if mesh is None:
            mesh = make_mesh()
        n_dev = mesh.devices.size
        multiproc = jax.process_count() > 1
        expected = len(dist.local_shard_ids(n_dev, mesh)) if multiproc \
            else n_dev
        if len(dbs) != expected:
            raise ValueError(f"{len(dbs)} shards for {expected} "
                             f"local devices")
        self.mesh = mesh
        self.db = dbs[0]          # taxonomy/targets replicated across shards
        self.classify = classify
        self.pipeline = pipeline
        self.target_window_k = target_window_k
        p = self.db.query_sketch_params
        self.sketch_params = p
        # threshold deduced from the TARGET sketcher's size, like
        # adapt_options_to_database (src/mode_query.cpp:247-260)
        self.hits_min = classify.resolved_hits_min(
            self.db.sketch_params.sketch_size)
        self.lowest_rank = _rank_code(classify.lowest_rank)
        self.highest_rank = _rank_code(classify.highest_rank)
        self.starts = tuple(_window_starts_static(
            pipeline.max_query_len, p.window_size, p.window_stride))

        import os

        pad_f = max(d.features.num_keys for d in dbs)
        pad_l = max(d.features.num_locations for d in dbs)
        # common packed-location encoding: win_bits must fit every shard's
        # max window AND leave room for the global max target id
        wb = max((int(d.features.loc_win.max()) if d.features.num_locations
                  else 0) for d in dbs)
        tb = max((int(d.features.loc_tgt.max()) if d.features.num_locations
                  else 0) for d in dbs)
        win_bits = max(1, wb.bit_length())
        packable = max(1, tb.bit_length()) + win_bits <= 31
        max_bucket = max((int(d.features.bucket_sizes().max())
                          if d.features.num_keys else 0) for d in dbs)
        # direct fast tier: same cap heuristic as the single-chip engine,
        # over the union of this host's shard bucket-size distributions;
        # per-shard overflow is psum'd and overflowing reads re-run through
        # the full-width sharded program (EngineBase._dispatch_reruns)
        nf = 2 * len(self.starts) * p.sketch_size
        self.lmax_full = pipeline.max_locations_per_query
        self.lmax_fast = self.lmax_full   # no narrow CSR tier: the direct
        #                                   tier covers the fast path
        self._rerun_batch = 1024
        all_sizes = np.concatenate(
            [d.features.bucket_sizes() for d in dbs]) if dbs else \
            np.zeros(0, np.int64)
        mb, _ = choose_direct_cap(all_sizes, nf, self.lmax_full,
                                  pipeline.fast_bucket_cap)
        # empirical re-run estimate (see engine.estimate_overflow_fraction):
        # shards own disjoint targets, so per-shard heavy-window counts sum
        # to the union; a read re-runs if ANY shard overflows it. Counts
        # are computed for EVERY candidate cap so all hosts can walk the
        # same aggregated numbers after one allgather.
        cap_limit = max(1, self.lmax_full // nf)
        cand_caps = [c for c in (2, 4, 6, 8, 12, 16) if c <= cap_limit]
        heavy = np.zeros(6, np.int64)
        tot_win = 0
        # counts are computed whenever auto-capping, so every host
        # contributes regardless of its local coverage pick; whether to
        # walk is decided from GLOBAL quantities after the allgather
        if pipeline.fast_bucket_cap == 0:
            from ..query.engine import count_heavy_windows
            for d in dbs:
                s = d.features.bucket_sizes()
                for i, c in enumerate(cand_caps):
                    heavy[i] += count_heavy_windows(
                        s, d.features.loc_tgt, d.features.loc_win, c)
                tot_win += int(d.taxonomy.source_windows.sum())
        if multiproc:
            # all shards must pad to the same (global) table sizes, and the
            # unrolled-search step count / win_bits / direct-path bucket cap
            # are static compile parameters — agree across hosts
            from jax.experimental import multihost_utils
            g = multihost_utils.process_allgather(
                np.array([pad_f, pad_l, win_bits, int(packable),
                          max_bucket, mb, tot_win]
                         + list(heavy), np.int64))
            pad_f, pad_l = int(g[:, 0].max()), int(g[:, 1].max())
            win_bits = int(g[:, 2].max())
            packable = bool(g[:, 3].min())
            max_bucket = int(g[:, 4].max())
            mb = int(g[:, 5].max())
            tot_win = int(g[:, 6].sum())
            heavy = g[:, 7:7 + 6].sum(axis=0)
        from ..query.engine import OVERFLOW_DISABLE_THRESHOLD
        walk = (pipeline.fast_bucket_cap == 0 and tot_win > 0
                and max_bucket > min(16, cap_limit))
        if walk:
            # walk the caps from widest down; keep the smallest whose
            # estimated re-run rate stays under threshold, else single-tier
            mb = 0
            for i in range(len(cand_caps) - 1, -1, -1):
                est = min(1.0, 2.0 * int(heavy[i]) / tot_win)
                if est > OVERFLOW_DISABLE_THRESHOLD:
                    break
                mb = cand_caps[i]
        self._direct_mb = mb
        self._direct_exact = mb >= max_bucket
        keys, offsets, tgts, wins, packed = stack_shard_tables(
            dbs, pad_keys_to=pad_f, pad_locs_to=pad_l,
            win_bits=win_bits if packable else 0)
        self._win_bits = win_bits if packed is not None else 0
        # seg encoding (see QueryEngine: compact candidate-taxon index in
        # the high bits of every packed location word -> the candidate
        # stage's dedup taxon comes from bits instead of a per-element
        # tiny-table gather, and classification uses a small one-hot-dot
        # lineage table). All inputs are replicated across hosts (tct,
        # target_count, the agreed win_bits), so every process derives the
        # same static seg parameters without another allgather.
        tct_np = np.asarray(self.db.target_cand_tax(self.lowest_rank))
        n_nodes = int(self.db.taxonomy.ranked_lineage.shape[0])
        from ..query.engine import derive_seg_encoding
        packed, self._seg_shift, self._uniq_tct, lin_small = \
            derive_seg_encoding(tct_np, self.db.target_count, n_nodes,
                                win_bits, packed,
                                self.db.taxonomy.ranked_lineage)
        lineage_np = (lin_small if lin_small is not None
                      else self.db.taxonomy.ranked_lineage.astype(np.int32))
        # injective target->taxon map: dedup by target id, gather only
        # top-k winners' taxa (see query.engine; config-2-style worlds)
        self._map_topk = bool(
            self._seg_shift == 0 and self.db.target_count > 0
            and len(np.unique(tct_np[:self.db.target_count]))
            == self.db.target_count)
        buckets = []
        radix_steps = 1
        for i in range(keys.shape[0]):
            bo, st = lookup.build_radix_index(keys[i])
            buckets.append(bo)
            radix_steps = max(radix_steps, st)
        if multiproc:
            from jax.experimental import multihost_utils
            g = multihost_utils.process_allgather(
                np.array([radix_steps], np.int64))
            radix_steps = int(g.max())
        self._search_steps = radix_steps
        self._bucket_offsets = dist.put_sharded(np.stack(buckets), mesh)
        self._keys = dist.put_sharded(keys, mesh)
        self._offsets = dist.put_sharded(offsets, mesh)
        # flat (start, cnt) tables for the direct lookup; padded key slots
        # carry cnt == 0 (device_arrays pads offsets with the last offset)
        self._start_tbl = dist.put_sharded(
            offsets[:, :-1].astype(np.int32), mesh)
        self._cnt_tbl = dist.put_sharded(
            np.diff(offsets, axis=1).astype(np.int32), mesh)
        if packed is None:
            self._loc_tgt = dist.put_sharded(tgts, mesh)
            self._loc_win = dist.put_sharded(wins, mesh)
        else:
            # dead operands under the packed single-word path (see
            # QueryEngine): don't spend device memory on the (tgt, win)
            # pair arrays
            dummy = np.zeros((tgts.shape[0], 1), np.int32)
            self._loc_tgt = dist.put_sharded(dummy, mesh)
            self._loc_win = dist.put_sharded(dummy, mesh)
        self._loc_packed = None if packed is None \
            else dist.put_sharded(packed, mesh)
        # padded row-gather table for the direct tier (one per shard; see
        # lookup.build_direct_table; budget-gated like QueryEngine's)
        self._direct_tbl = None
        if self._direct_mb > 0 and packed is not None:
            # same untuned 2048 MB default as QueryEngine
            budget_mb = float(os.environ.get("METACACHE_DIRECT_TBL_MB",
                                             "2048"))
            need_mb = (offsets.shape[0] * (offsets.shape[1] - 1)
                       * (self._direct_mb + 1) * 4 / 1e6)
            if need_mb <= budget_mb:
                tbls = np.stack([
                    lookup.build_direct_table(
                        offsets[i, :-1],
                        np.diff(offsets[i]).astype(np.int32),
                        packed[i], self._direct_mb)
                    for i in range(offsets.shape[0])])
                self._direct_tbl = dist.put_sharded(tbls, mesh)
        self._tct = dist.put_replicated(
            np.asarray(self.db.target_cand_tax(self.lowest_rank)), mesh)
        self._lineage = dist.put_replicated(lineage_np, mesh)
        self._dist = dist
        self._target_groups = None
        self._compiled = {}
        # device-resident threshold scalars (see QueryEngine: per-dispatch
        # scalar creation costs two extra host->device copies per batch)
        self._hits_min_dev = jnp.int32(self.hits_min)
        self._hits_diff_dev = jnp.float32(classify.hits_diff_fraction)
        # wire/summary formats (see QueryEngine: few bytes per read each
        # way; ambiguous reads re-run via the legacy tier)
        qlen = pipeline.max_query_len
        self._wire = "legacy" if os.environ.get(
            "METACACHE_WIRE") == "legacy" or qlen % 8 != 0 else "slim"
        self._len_bytes = 1 if qlen <= 255 else 2
        n_nodes = int(self.db.taxonomy.ranked_lineage.shape[0])
        n_ranks = int(self.db.taxonomy.ranked_lineage.shape[1])
        self._pack_ok = n_nodes < (1 << 26) and n_ranks + 1 < 32

    # ------------------------------------------------------------------
    def set_exclusion(self, rank_code: int):
        """Enable clade exclusion on the given rank: per-read exclusion
        groups must then be passed to classify_batch (remove_hits_on_rank,
        src/classification.cpp:141-157)."""
        groups = make_target_groups(self.db, rank_code)
        self._target_groups = self._dist.put_replicated(groups, self.mesh)
        self.exclude_rank = rank_code

    def exclusion_group_of(self, node: int) -> int:
        if node == 0:
            return 0
        return int(self.db.taxonomy.ranked_lineage[node, self.exclude_rank])

    def _build_fn(self, with_exclusion: bool, lmax: int, direct_mb: int,
                  wire: str, sfmt: str):
        p = self.sketch_params
        starts = self.starts
        C = self.classify.max_candidates
        highest = self.highest_rank
        insert_max = self.classify.insert_size_max
        k, S, W, stride = (p.kmer_size, p.sketch_size, p.window_size,
                           p.window_stride)
        search_steps = self._search_steps
        win_bits = self._win_bits
        ci_shift = self._seg_shift
        tax_onehot = self._seg_shift == 0 and self._pack_ok
        map_topk = self._map_topk
        twk = self.target_window_k
        has_packed = self._loc_packed is not None
        has_direct = direct_mb > 0 and self._direct_tbl is not None
        qlen = self.pipeline.max_query_len
        len_bytes = self._len_bytes

        def shard_fn(fused, keys, offsets, loc_tgt, loc_win, loc_packed,
                     buckets, start_tbl, cnt_tbl, direct_tbl,
                     tct, lineage, hits_min, hits_diff,
                     exclude_groups, target_groups):
            if wire == "slim":
                packed1, ambig1, lens1, packed2, ambig2, lens2 = \
                    unfuse_device_inputs_slim(fused, qlen, len_bytes)
            elif wire == "slim1":
                from ..query.engine import unfuse_device_inputs_slim1
                packed1, ambig1, lens1, packed2, ambig2, lens2 = \
                    unfuse_device_inputs_slim1(fused, qlen, len_bytes)
            else:
                packed1, ambig1, lens1, packed2, ambig2, lens2 = \
                    unfuse_device_inputs(fused, qlen)
            # local shard block: leading axis of size 1
            cand, tgt, win, total, overflow = local_candidates(
                packed1, ambig1, lens1, packed2, ambig2, lens2,
                keys[0], offsets[0], loc_tgt[0], loc_win[0], tct,
                exclude_groups, target_groups, buckets[0],
                loc_packed[0] if has_packed else None,
                start_tbl[0], cnt_tbl[0],
                direct_tbl[0] if has_direct else None,
                k=k, sketch_size=S, window_size=W, window_stride=stride,
                starts=starts, lmax=lmax, max_candidates=C,
                insert_size_max=insert_max, search_steps=search_steps,
                win_bits=win_bits,
                direct_mb=direct_mb, ci_shift=ci_shift,
                tax_onehot=tax_onehot, map_topk=map_topk)
            B = tgt.shape[0]

            # ---- cross-shard candidate merge over the mesh ----
            # all_gather fixed-shape candidate tensors, then deterministic
            # dedup/top-k (replaces the reference's log2(P) Send/Recv tree)
            gath = {key: jax.lax.all_gather(val, "shard")
                    for key, val in cand.items()}           # [P, B, C]
            Pn = gath["tax"].shape[0]
            flat = {key: jnp.transpose(val, (1, 0, 2)).reshape(B, Pn * C)
                    for key, val in gath.items()}
            merged = cand_ops._dedup_topk(flat["tax"], flat["hits"],
                                          flat["beg"], flat["end"],
                                          flat["tgt"], C)
            # fusion fence before classify — as in the fused engine
            # (_query_batch_device): keeps XLA from fusing across this
            # boundary. Semantically a no-op.
            merged = dict(merged)
            merged["tax"], merged["hits"] = jax.lax.optimization_barrier(
                (merged["tax"], merged["hits"]))
            best, best_rank = classify_op.classify_lca(
                merged["tax"], merged["hits"], lineage, hits_min, hits_diff,
                highest)
            ovf = jax.lax.psum(overflow, "shard")
            tot = jax.lax.psum(total, "shard")
            # fused summary: one device->host transfer serves the default
            # output path (see query.engine.BatchResult); packed formats
            # fold (rank << 26 | node) into one int32 word per read
            if sfmt == "p1":
                summary = pack_summary_word(best, best_rank)[None, :]
            elif sfmt == "p2":
                summary = jnp.stack([pack_summary_word(best, best_rank),
                                     ovf])
            elif sfmt == "s2":
                summary = jnp.stack([best, best_rank])
            else:
                summary = jnp.stack([best, best_rank, tot, ovf])
            twh = None
            if twk:
                # per-shard counts vs the local match list; psum = global
                # counts (each target's matches live wholly on one shard)
                twh = jax.lax.psum(
                    target_window_hits(merged, tgt, win, twk), "shard")
            return merged, best, best_rank, tot, ovf, summary, twh

        mesh = self.mesh
        fn = jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(),                            # fused reads replicated
                      P("shard"), P("shard"), P("shard"), P("shard"),
                      P("shard"), P("shard"), P("shard"), P("shard"),
                      P("shard"),
                      P(), P(), P(), P(), P(), P()),
            out_specs=(P(), P(), P(), P(), P(), P(), P()),
            check_vma=False)
        return jax.jit(fn)

    def _dispatch_tier(self, fused, exclude_groups, lmax: int,
                       direct_mb: int = 0, wire: str = "legacy",
                       sfmt: str = "s4"):
        with_excl = exclude_groups is not None
        if with_excl and self._target_groups is None:
            raise ValueError("call set_exclusion() before passing "
                             "exclude_groups")
        key = (with_excl, int(fused.shape[0]), lmax, direct_mb, wire, sfmt)
        if key not in self._compiled:
            self._compiled[key] = self._build_fn(with_excl, lmax,
                                                 direct_mb, wire, sfmt)
        if jax.process_count() > 1:
            # every process streams the same reads (the reference's "all
            # ranks read the same block", querying.h:749-790) -> replicate
            put = lambda x: self._dist.put_replicated(np.asarray(x),
                                                      self.mesh)
        else:
            put = jnp.asarray
        # dummy placeholder for the unused packed-location operand: the
        # sharded keys array (never read when has_packed is False)
        loc_packed = self._loc_packed if self._loc_packed is not None \
            else self._keys
        direct_tbl = self._direct_tbl if (
            direct_mb > 0 and self._direct_tbl is not None) else self._keys
        eg = put(np.asarray(exclude_groups)) if with_excl else None
        tg = self._target_groups if with_excl else None
        merged, best, best_rank, tot, ovf, summary, twh = \
            self._compiled[key](
                put(fused),
                self._keys, self._offsets, self._loc_tgt, self._loc_win,
                loc_packed, self._bucket_offsets,
                self._start_tbl, self._cnt_tbl, direct_tbl,
                self._tct, self._lineage,
                self._hits_min_dev, self._hits_diff_dev,
                eg, tg)
        out = {"cand": merged, "best": best, "best_rank": best_rank,
               "match_total": tot, "match_overflow": ovf,
               "summary": summary, "_sfmt": sfmt}
        if self._seg_shift:
            out["_seg_decode"] = (self._seg_shift, self._uniq_tct)
        if twh is not None:
            out["target_window_hits"] = twh
        return out
