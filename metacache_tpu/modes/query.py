"""Query mode: load database shard(s), classify read files, write output.

The analogue of main_mode_query + process_input_files
(src/mode_query.cpp:55-455) and the per-read driver of
map_queries_to_targets_parallel (src/classification.cpp:653-767).
"""
from __future__ import annotations

import dataclasses
import glob
import os
import sys
from typing import Dict, List, Optional, TextIO, Tuple

import numpy as np

from ..config import ClassifyParams, QueryPipelineParams
from ..db.database import Database, shard_path
from ..db.feature_table import FeatureTable
from ..db.taxonomy import Rank, rank_from_name, rank_name
from ..io import sequence_io
from ..query import abundance as abundance_mod
from ..query import output as out_mod
from ..query.engine import QueryEngine, encode_read_into
from ..query.stats import ClassificationStatistics
from ..utils import ArgsParser, Timer


@dataclasses.dataclass
class EvaluationOptions:
    """(src/query_options.h:144-154)"""
    precision: bool = False
    taxon_coverage: bool = False
    exclude_rank: int = Rank.NONE
    determine_ground_truth: bool = False


@dataclasses.dataclass
class QueryModeOptions:
    pairing: str = "none"               # none | files | sequences
    query_limit: int = -1
    # echoed in the query-parameters block; the reference defaults to
    # hardware concurrency (query_options.h:106)
    num_threads: int = os.cpu_count() or 1
    classify: ClassifyParams = dataclasses.field(default_factory=ClassifyParams)
    evaluate: EvaluationOptions = dataclasses.field(
        default_factory=EvaluationOptions)
    output: out_mod.OutputOptions = dataclasses.field(
        default_factory=out_mod.OutputOptions)
    pipeline: QueryPipelineParams = dataclasses.field(
        default_factory=QueryPipelineParams)
    # query-time database tuning (database_query_options,
    # src/query_options.cpp:41-66; applied in mode_query.cpp:354-388)
    max_locations_per_feature: int = -1
    remove_overpopulated_features: bool = False
    db_sketch_len: int = -1
    db_win_len: int = -1
    db_win_stride: int = -1


def get_query_options(args: ArgsParser, defaults: QueryModeOptions = None
                      ) -> QueryModeOptions:
    """Flag harvesting mirroring get_query_options
    (src/query_options.cpp:41-387), same flag aliases."""
    opt = defaults or QueryModeOptions()

    if args.contains("pairfiles") or args.contains(
            ["pair-files", "pair_files", "paired_files", "paired-files"]):
        opt.pairing = "files"
    elif args.contains(["pairseq", "pair-seq", "pair_seq", "paired_seq",
                        "paired-seq"]):
        opt.pairing = "sequences"

    opt.query_limit = args.get(["query-limit", "query_limit"], -1, int)
    threads = args.get("threads", 0, int)
    if threads >= 1:
        opt.num_threads = threads

    c = opt.classify
    lowest = args.get("lowest", "")
    lowest_rank = c.lowest_rank
    if lowest:
        r = rank_from_name(lowest)
        if r < Rank.ROOT:
            lowest_rank = r
    highest = args.get("highest", "")
    highest_rank = c.highest_rank
    if highest:
        r = rank_from_name(highest)
        if r <= Rank.ROOT:
            highest_rank = r
    lowest_code = _code(lowest_rank)
    highest_code = _code(highest_rank)
    if lowest_code > highest_code:
        lowest_code = highest_code
    hitsdiff = args.get(["hitdiff", "hit-diff", "hit_diff", "hitsdiff",
                         "hits-diff", "hits_diff"], None, float)
    if hitsdiff is not None:
        # percentages > 1 are divided by 100 (query_options.cpp:166-172)
        if hitsdiff > 1:
            hitsdiff /= 100.0
        if hitsdiff < 0:
            hitsdiff = 0.0
    else:
        hitsdiff = c.hits_diff_fraction
    opt.classify = ClassifyParams(
        lowest_rank=lowest_code,
        highest_rank=highest_code,
        hits_min=args.get(["hitmin", "hit-min", "hit_min", "hitsmin",
                           "hits-min", "hits_min"], c.hits_min, int),
        hits_diff_fraction=hitsdiff,
        insert_size_max=args.get(["insertsize", "insert-size", "insert_size"],
                                 c.insert_size_max, int),
        max_candidates=args.get(["maxcand", "max-cand", "max_cand"],
                                c.max_candidates, int))

    e = opt.evaluate
    e.precision = e.precision or args.contains("precision") \
        or args.contains(["taxon-coverage", "taxon_coverage"])
    e.taxon_coverage = e.taxon_coverage or args.contains(
        ["taxon-coverage", "taxon_coverage"])
    e.determine_ground_truth = e.determine_ground_truth or args.contains(
        ["ground-truth", "ground_truth", "groundtruth"])
    excl = args.get(["exclude", "exclude-rank", "exclude_rank"], "")
    if excl:
        e.exclude_rank = rank_from_name(excl)
    if e.exclude_rank != Rank.NONE:
        e.determine_ground_truth = True

    # query-time database tuning (src/query_options.cpp:47-61)
    opt.max_locations_per_feature = args.get(
        ["max-locations-per-feature", "max_locations_per_feature"],
        opt.max_locations_per_feature, int)
    opt.remove_overpopulated_features = opt.remove_overpopulated_features \
        or args.contains(["remove-overpopulated-features",
                          "remove_overpopulated_features"])
    opt.db_sketch_len = args.get("sketchlen", opt.db_sketch_len, int)
    opt.db_win_len = args.get("winlen", opt.db_win_len, int)
    opt.db_win_stride = args.get(
        "winstride", opt.db_win_len if opt.db_win_len > 0
        else opt.db_win_stride, int)
    # accepted-and-ignored for reference cluster-script compatibility:
    # hash-table load factor and per-thread queueing have no analogue in
    # the dense-table / batched-device design (query_options.cpp:63-66,
    # :100-103)
    args.get(["max-load-fac", "max_load_fac", "maxloadfac"], -1.0, float)
    args.get(["per-thread-sequential-queries",
              "per_thread_sequential_queries"], -1, int)

    o = opt.output
    o.format.comment = args.get("comment", o.format.comment)
    o.format.column = args.get("separator", o.format.column)
    if args.contains(["separate-cols", "separatecols", "separate_cols",
                      "separate-columns", "separatecolumns",
                      "separate_columns"]):
        # rank/name/taxid into separate columns (query_options.cpp:235-247)
        o.collapse_unclassified = False
        o.format.tax_separator = o.format.column
        o.format.rank_suffix = o.format.column
        o.format.taxid_prefix = o.format.column
        o.format.taxid_suffix = ""
    o.show_query_ids = o.show_query_ids or args.contains(
        ["queryids", "query-ids", "query_ids"])
    o.lowest_rank = opt.classify.lowest_rank
    o.highest_rank = _code(opt.classify.highest_rank)
    o.show_lineage = o.show_lineage or args.contains("lineage")
    o.show_locations = o.show_locations or args.contains("locations")
    o.show_top_hits = o.show_top_hits or args.contains(
        ["tophits", "top-hits", "top_hits"])
    o.show_all_hits = o.show_all_hits or args.contains(
        ["allhits", "all-hits", "all_hits"])
    show_ranks = not args.contains(["omit-ranks", "omitranks", "omit_ranks"])
    if args.contains(["taxidsonly", "taxids-only", "taxids_only",
                      "taxid-only", "taxid_only"]):
        o.show_taxa_as = out_mod.TaxonPrintMode.RANK_ID if show_ranks \
            else out_mod.TaxonPrintMode.ID
    elif args.contains(["taxids", "taxid"]):
        o.show_taxa_as = out_mod.TaxonPrintMode.RANK_NAME_ID if show_ranks \
            else out_mod.TaxonPrintMode.NAME_ID
    else:
        o.show_taxa_as = out_mod.TaxonPrintMode.RANK_NAME if show_ranks \
            else out_mod.TaxonPrintMode.NAME
    if args.contains(["nomap", "no-map", "no_map"]):
        o.map_view_mode = out_mod.MapViewMode.NONE
    elif args.contains(["mapped-only", "mapped_only", "mappedonly"]):
        o.map_view_mode = out_mod.MapViewMode.MAPPED_ONLY
    elif o.show_all_hits:
        o.map_view_mode = out_mod.MapViewMode.ALL
    o.show_ground_truth = e.determine_ground_truth
    o.show_alignment = o.show_alignment or args.contains(
        ["align", "alignment", "showalignment", "showalign", "show-align",
         "show_align"])

    o.show_hits_per_target_list = o.show_hits_per_target_list or args.contains(
        ["hits-per-seq", "hitsperseq", "hits_per_seq", "hits-per-sequence",
         "hitspersequence", "hits_per_sequence"])
    o.targets_file = args.get(
        ["hits-per-seq", "hitsperseq", "hits_per_seq", "hits-per-sequence",
         "hitspersequence", "hits_per_sequence"], o.targets_file) or ""
    o.show_query_ids = o.show_query_ids or o.show_hits_per_target_list

    o.show_tax_abundances = o.show_tax_abundances or args.contains(
        "abundances")
    o.abundance_file = args.get("abundances", o.abundance_file) or ""
    est = args.get(["abundance-per", "abundances-per", "abundance_per",
                    "abundances_per"], "")
    if est:
        r = rank_from_name(est)
        if r != Rank.NONE and r <= Rank.ROOT:
            o.abundance_estimates_rank = r
    o.make_tax_counts = o.show_tax_abundances or \
        o.abundance_estimates_rank != Rank.NONE

    # info-level flags (query_options.cpp:325-341, io_options.h:32)
    verbose = args.contains("verbose")
    o.show_db_properties = o.show_db_properties or verbose
    o.show_query_params = (o.show_query_params or verbose) and \
        not args.contains(["no-query-params", "noqueryparams",
                           "no_query_params"])
    o.show_summary = (o.show_summary or verbose) and \
        not args.contains(["no-summary", "nosummary", "no_summary"])
    o.show_errors = o.show_errors and \
        not args.contains(["noerr", "noerrors"])

    o.query_mappings_file = args.get("out", o.query_mappings_file) or ""
    if not o.query_mappings_file:
        split = args.get(["splitout", "split-out"], "")
        if split:
            o.split_files = True
            o.query_mappings_file = split

    import jax
    if jax.default_backend() == "cpu":
        # XLA:CPU takes minutes to compile the accelerator-sized fused
        # pipeline (B=4096, LMAX=2048); CPU runs are smoke/dev runs, so
        # default to shapes that compile in tens of seconds. Explicit flags
        # still win.
        opt.pipeline = dataclasses.replace(
            opt.pipeline, batch_size=512, max_locations_per_query=1024)

    batch = args.get(["batch-size", "batch_size"], None, int)
    if batch:
        opt.pipeline = dataclasses.replace(opt.pipeline, batch_size=batch)
    maxloc = args.get(["max-locations-per-query",
                       "max_locations_per_query"], None, int)
    if maxloc:
        opt.pipeline = dataclasses.replace(opt.pipeline,
                                           max_locations_per_query=maxloc)
    maxqlen = args.get(["max-query-len", "max_query_len"], None, int)
    if maxqlen:
        opt.pipeline = dataclasses.replace(opt.pipeline, max_query_len=maxqlen)
    return opt


def _code(rank) -> int:
    if isinstance(rank, int):
        return rank
    return rank_from_name(rank)


# ---------------------------------------------------------------------------
def load_all_shards(dbname: str) -> Database:
    """Load every '<dbname>_<s>.npz' shard and fuse the feature tables for
    single-process querying (the union is equivalent to per-shard lookup +
    candidate merge — see FeatureTable.concat_shards)."""
    shards = []
    s = 0
    while os.path.exists(shard_path(dbname, s)):
        # memmap the shard feature tables: the fused merge then READS
        # from evictable file-backed pages instead of holding every
        # shard's table resident alongside the merged copy (config-3
        # fused load peaked at 38 GB RSS in round 4)
        shards.append(Database.load(dbname, s, mmap=True))
        s += 1
    if not shards:
        raise FileNotFoundError(
            f"can't open file {shard_path(dbname, 0)}")
    db = shards[0]
    if len(shards) > 1:
        db.features = FeatureTable.concat_shards([d.features for d in shards])
        db.num_shards = 1
        db.shard_id = 0
    return db


def ground_truth_node(db: Database, header: str) -> int:
    """(classification.cpp:111-131)"""
    t = db.taxonomy
    name2node: Dict[str, int] = getattr(db, "_name2node", None)
    if name2node is None:
        name2node = {}
        for node in range(1, len(t)):
            if t.rank[node] == Rank.SEQUENCE:
                name2node.setdefault(t.names[node], node)
        db._name2node = name2node

    acc = sequence_io.extract_ncbi_accession_version(header)
    node = name2node.get(acc, 0)
    if node:
        return t.next_ranked_ancestor(node)
    accs = sequence_io.extract_ncbi_accession(header)
    if accs:
        for name, n in name2node.items():
            if accs in name:
                return t.next_ranked_ancestor(n)
    tid = sequence_io.extract_taxon_id(header)
    if tid:
        n = t.node_of_id(tid)
        if n:
            return t.next_ranked_ancestor(n)
    node = name2node.get(header, 0)
    if node:
        return t.next_ranked_ancestor(node)
    return 0


class QueryProcessor:
    """Streams read files through the engine, formats output, accumulates
    statistics/abundances — the host half of the query engine."""

    def __init__(self, db: Database, opt: QueryModeOptions, engine=None):
        self.db = db
        self.opt = opt
        twk = 16 if opt.output.show_hits_per_target_list else 0
        self.engine = engine or QueryEngine(db, opt.classify, opt.pipeline,
                                            target_window_k=twk)
        self.exclusion = opt.evaluate.exclude_rank != Rank.NONE
        if self.exclusion:
            self.engine.set_exclusion(opt.evaluate.exclude_rank)
        self.stats = ClassificationStatistics()
        self.tax_counts: Dict[int, float] = {}
        self.total_overflow = 0
        # reads re-classified through the full-width program (fast-tier
        # overflow or ambiguous characters under the slim wire)
        self.total_reruns = 0
        # target node -> [(qid, [(win, hits), ...]), ...]
        self.target_matches: Dict[int, List] = {}
        self._seq_cache: Dict[str, List[str]] = {}

    def _load_target_sequence(self, filename: str, index: int) -> str:
        """Fetch record #index (1-based) of a reference file, with a
        per-file cache (show_alignment re-reads source files,
        classification.cpp:447-453)."""
        if filename not in self._seq_cache:
            self._seq_cache[filename] = [
                r.data for r in sequence_io.read_sequences(filename)]
        seqs = self._seq_cache[filename]
        return seqs[index - 1] if 0 < index <= len(seqs) else ""

    def process_files(self, infiles: List[str], out: TextIO):
        timer = Timer()
        timer.start()
        # the parameters echo precedes the table header in result files
        # (mode_query.cpp:119-121 before map_queries_to_targets)
        if self.opt.output.show_query_params:
            out_mod.show_query_parameters(out, self.opt)
        if self.opt.output.map_view_mode != out_mod.MapViewMode.NONE:
            out_mod.show_query_mapping_header(out, self.opt.output)
        pairing = self.opt.pairing
        cmt = self.opt.output.format.comment
        if pairing == "files":
            infiles = sorted(infiles)
            pairs = list(zip(infiles[0::2], infiles[1::2]))
            for f1, f2 in pairs:
                # input-file announcement (querying.h:1337 via the
                # appendToOutput callback, classification.cpp:736-738)
                out.write(f"{cmt}{f1} + {f2}\n")
                self._process_one(f1, f2, out)
        else:
            for f in infiles:
                out.write(f"{cmt}{f}\n")
                self._process_one(f, None, out)
        timer.stop()
        self.time_ms = timer.milliseconds()

    def _process_one(self, f1: str, f2: Optional[str], out: TextIO):
        if not self.opt.output.show_alignment:
            if self._process_one_native(f1, f2, out):
                return
        self._process_one_python(f1, f2, out)

    def _process_one_native(self, f1: str, f2: Optional[str],
                            out: TextIO) -> bool:
        """Fast path: native C++ reader/encoder (native/mcio.cpp) feeding
        packed batches, with one batch in flight (dispatch batch k+1 before
        materializing batch k) so host formatting overlaps device compute.
        Returns False if the native library is unavailable (caller falls
        back to the pure-Python reader)."""
        try:
            from ..native import NativeBatchReader, load_mcio
            if load_mcio() is None:
                return False
            reader = NativeBatchReader(
                f1, f2, self.opt.pairing,
                self.opt.pipeline.batch_size, self.opt.pipeline.max_query_len,
                limit=self.opt.query_limit if self.opt.query_limit > 0
                else -1)
        except OSError:
            return False
        # windowed pipelining: dispatch WINDOW batches, fetch their result
        # summaries in ONE stacked device->host transfer, and format window
        # k while window k+1 computes — the device counterpart of the
        # reference's reader/worker/output thread overlap
        # (src/querying.h:749-830, :1088-1136).
        # reader prefetch thread: the native parse/encode releases the GIL
        # (ctypes call), so reading batch k+2 overlaps dispatching k+1 and
        # formatting k — the reference runs readers on their own threads
        # the same way (querying.h:749-830). Queue depth 2 bounds memory.
        import queue as _queue
        import threading as _threading
        q: "_queue.Queue" = _queue.Queue(maxsize=2)

        def _feed():
            try:
                for batch in reader:
                    q.put(batch)
                q.put(None)
            except BaseException as e:   # surfaced by the consumer
                q.put(e)

        feeder = _threading.Thread(target=_feed, daemon=True)
        feeder.start()

        def _batches():
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item

        WINDOW = 8
        pending = []   # dispatched, not yet materialized
        windows = []   # completed dispatch windows
        first = True
        for b in _batches():
            if first:
                print("compiling query pipeline (cached after first run)...",
                      file=sys.stderr)
                first = False
            meta = b          # batch: headers decode lazily on demand
            exclude_groups = None
            gts = None
            if self.exclusion:
                gts = [ground_truth_node(self.db, h) for h in b.headers]
                exclude_groups = np.zeros(self.opt.pipeline.batch_size,
                                          np.int32)
                for i, g in enumerate(gts):
                    exclude_groups[i] = self.engine.exclusion_group_of(g)
            dev = self.engine.dispatch_packed(
                b.packed1, b.ambig1, b.lens1, b.packed2, b.ambig2, b.lens2,
                exclude_groups=exclude_groups)
            pending.append((dev, b.n, meta, gts))
            if len(pending) >= WINDOW:
                windows.append(pending)
                pending = []
                if len(windows) == 2:
                    self._finalize_window(windows.pop(0), out)
        if pending:
            windows.append(pending)
        for w in windows:
            self._finalize_window(w, out)
        return True

    def _finalize_window(self, window, out: TextIO):
        results = self.engine.materialize_many(
            [(dev, n) for dev, n, _, _ in window])
        for res, (dev, n, meta, gts) in zip(results, window):
            self._postprocess(res, n, meta, gts, out)

    def _finalize(self, pending, out: TextIO):
        dev, n, meta, gts = pending
        res = self.engine.materialize(dev, n)
        self._postprocess(res, n, meta, gts, out)

    def _process_one_python(self, f1: str, f2: Optional[str], out: TextIO):
        B = self.opt.pipeline.batch_size
        L = self.opt.pipeline.max_query_len
        c1, l1, c2, l2 = self.engine.make_host_buffers()
        meta: List[Tuple[int, str]] = []  # (query_id, header)
        n = 0
        limit = self.opt.query_limit
        count = 0
        for r1, r2 in sequence_io.read_sequence_pairs(f1, f2,
                                                      self.opt.pairing):
            if limit > 0 and count >= limit:
                break
            count += 1
            if r1.empty:
                continue
            encode_read_into(c1, l1, n, r1.data, L)
            if r2 is not None and r2.data:
                encode_read_into(c2, l2, n, r2.data, L)
            else:
                l2[n] = 0
            if self.opt.output.show_alignment:
                meta.append((r1.index, r1.header, r1.data,
                             r2.data if r2 is not None else ""))
            else:
                meta.append((r1.index, r1.header))
            n += 1
            if n == B:
                self._emit(c1, l1, c2, l2, n, meta, out)
                c1[:] = 0; l1[:] = 0; c2[:] = 0; l2[:] = 0
                meta = []
                n = 0
        if n:
            self._emit(c1, l1, c2, l2, n, meta, out)

    def _emit(self, c1, l1, c2, l2, n, meta, out: TextIO):
        gts = None
        exclude_groups = None
        if self.exclusion:
            gts = [ground_truth_node(self.db, m[1]) for m in meta]
            exclude_groups = np.zeros(self.opt.pipeline.batch_size, np.int32)
            for i, g in enumerate(gts):
                exclude_groups[i] = self.engine.exclusion_group_of(g)
        res = self.engine.classify_batch(c1, l1, c2, l2, n,
                                         exclude_groups=exclude_groups)
        self._postprocess(res, n, meta, gts, out)

    def _postprocess(self, res, n, meta, gts, out: TextIO):
        # count READS whose match list truncated at lmax (not dropped
        # locations — a single repeat-element read can drop thousands)
        self.total_overflow += int((res.match_overflow[:n] > 0).sum())
        self.total_reruns += sum(len(rows) for rows, _, _ in res._patches)
        db, opt = self.db, self.opt
        ev = opt.evaluate
        o = opt.output
        if self._fast_path_ok(gts):
            if hasattr(meta, "hdr_buf") and \
                    self._postprocess_fast_native(res, n, meta, out):
                return
            if hasattr(meta, "hdr_buf"):
                meta = list(zip(meta.indices.tolist(), meta.headers))
            self._postprocess_fast(res, n, meta, out)
            return
        if hasattr(meta, "hdr_buf"):
            meta = list(zip(meta.indices.tolist(), meta.headers))
        # candidate tensors are only transferred from the device when an
        # output mode actually displays them (BatchResult is lazy; slicing
        # rows eagerly would defeat that)
        need_cand = (o.show_top_hits or o.show_all_hits or o.show_locations
                     or o.show_alignment or o.show_hits_per_target_list)
        c_tax = res.cand_tax if need_cand else None
        c_hits = res.cand_hits if need_cand else None
        c_beg = res.cand_beg if need_cand else None
        c_end = res.cand_end if need_cand else None
        _none = np.zeros(0, np.int32)
        for i in range(n):
            qid, header = meta[i][0], meta[i][1]
            best = int(res.best[i])
            gt = 0
            if gts is not None:
                gt = gts[i]
            elif ev.precision or ev.determine_ground_truth or \
                    ev.exclude_rank != Rank.NONE:
                gt = ground_truth_node(db, header)
            if ev.precision:
                lca = db.taxonomy.ranked_lca_node(best, gt)
                lowest_correct = int(db.taxonomy.rank[lca]) if lca \
                    else Rank.NONE
                self.stats.assign_known_correct(
                    int(res.best_rank[i]),
                    int(db.taxonomy.rank[gt]) if gt else Rank.NONE,
                    lowest_correct)
                if ev.taxon_coverage and gt:
                    self._update_coverage(gt, best, int(res.best_rank[i]))
            else:
                self.stats.assign(int(res.best_rank[i]))
            if opt.output.make_tax_counts and best:
                self.tax_counts[best] = self.tax_counts.get(best, 0) + 1
            if opt.output.show_hits_per_target_list and \
                    res.target_window_hits is not None:
                self._collect_target_matches(res, i, qid)
            suffix = ""
            if opt.output.show_alignment and best:
                suffix = out_mod.alignment_suffix_str(
                    db, opt.output, meta[i][2], meta[i][3],
                    c_tax[i], c_beg[i], c_end[i],
                    self._load_target_sequence)
            out_mod.show_query_mapping(
                out, db, opt.output, qid, header, gt, best,
                c_tax[i] if need_cand else _none,
                c_hits[i] if need_cand else _none,
                c_beg[i] if need_cand else _none,
                c_end[i] if need_cand else _none,
                alignment_suffix=suffix)

    def _update_coverage(self, gt: int, best: int, best_rank: int):
        """-taxon-coverage confusion counting per ground-truth lineage rank
        (update_coverage_statistics, src/classification.cpp:294-327):
        for each ranked ancestor of the ground truth, classified on that
        rank + covered in DB => TP, classified + not covered => FP,
        unclassified + covered => FN, unclassified + not covered => TN."""
        t = self.db.taxonomy
        lin = t.ranked_lineage[gt]
        covered = t.covered_mask
        for r in range(Rank.NUM_RANKS):
            node = int(lin[r])
            if node == 0:
                continue
            rr = int(t.rank[node])
            unclassified_on_rank = best == 0 or rr < best_rank
            if covered[node]:
                if unclassified_on_rank:
                    self.stats.count_coverage_false_neg(rr)
                else:
                    self.stats.count_coverage_true_pos(rr)
            else:
                if unclassified_on_rank:
                    self.stats.count_coverage_true_neg(rr)
                else:
                    self.stats.count_coverage_false_pos(rr)

    def _fast_path_ok(self, gts) -> bool:
        """True when per-read work is (stats, tax counts, default mapping
        line) only — then the batch is processed vectorized + with a
        node->string cache instead of a per-read Python loop. At >100k
        pairs/s device throughput the Python loop would otherwise bound
        the end-to-end rate."""
        o, ev = self.opt.output, self.opt.evaluate
        return (gts is None and not ev.precision
                and not ev.determine_ground_truth
                and ev.exclude_rank == Rank.NONE
                and not o.show_hits_per_target_list
                and not o.show_alignment and not o.show_top_hits
                and not o.show_all_hits and not o.show_locations
                and not o.show_ground_truth)

    def _postprocess_fast_native(self, res, n, batch,
                                 out: TextIO) -> bool:
        """Default-output fast path, natively formatted: per-read mapping
        lines are built by ONE C pass over the raw header bytes and a
        cached taxon-string table (mcio_format_lines — the reference
        prints from its worker threads, querying.h:1088-1136). Returns
        False to fall back to the python formatter (native lib missing or
        buffer retry needed); stats/tax counts are only committed on
        success so the fallback never double-counts."""
        from .. import native
        if native.load_mcio() is None:
            return False
        o = self.opt.output
        best = res.best[:n]
        best_rank = res.best_rank[:n]
        mapped_only = o.map_view_mode == out_mod.MapViewMode.MAPPED_ONLY
        buf = b""
        if o.map_view_mode != out_mod.MapViewMode.NONE:
            tbl = getattr(self, "_taxstr_tbl", None)
            if tbl is None:
                tbl = self._taxstr_tbl = {}
                self._taxstr_list = []
                self._taxstr_cat = b""
                self._taxstr_soff = np.zeros(1, np.int64)
                self._taxstr_sorted = np.zeros(0, np.int64)
                self._taxstr_sorted_idx = np.zeros(0, np.int64)
            grown = False
            for nd in np.unique(best).tolist():
                if nd not in tbl:
                    tbl[nd] = len(self._taxstr_list)
                    self._taxstr_list.append(out_mod.show_taxon_str(
                        self.db, o, int(nd)).encode())
                    grown = True
            if grown:
                self._taxstr_cat = b"".join(self._taxstr_list)
                lens = np.fromiter((len(x) for x in self._taxstr_list),
                                   np.int64, len(self._taxstr_list))
                soff = np.zeros(len(lens) + 1, np.int64)
                np.cumsum(lens, out=soff[1:])
                self._taxstr_soff = soff
                nodes = np.fromiter(tbl.keys(), np.int64, len(tbl))
                idxs = np.fromiter(tbl.values(), np.int64, len(tbl))
                order = np.argsort(nodes)
                self._taxstr_sorted = nodes[order]
                self._taxstr_sorted_idx = idxs[order]
            sidx = self._taxstr_sorted_idx[np.searchsorted(
                self._taxstr_sorted, best.astype(np.int64))]
            if mapped_only:
                sidx = np.where(best == 0, np.int64(-1), sidx)
            got = native.format_mapping_lines(
                batch.hdr_buf, batch.hdr_off[:n + 1], sidx,
                self._taxstr_cat, self._taxstr_soff,
                o.format.column.encode(),
                batch.indices[:n] if o.show_query_ids else None)
            if got is None:
                return False
            buf = got
        # commit side effects only on success
        self.stats.assign_batch(best_rank)
        if o.make_tax_counts:
            nodes, cnts = np.unique(best[best != 0], return_counts=True)
            for nd, ct in zip(nodes.tolist(), cnts.tolist()):
                self.tax_counts[nd] = self.tax_counts.get(nd, 0) + ct
        if buf:
            out.write(buf.decode("utf-8", "replace"))
        return True

    def _postprocess_fast(self, res, n, meta, out: TextIO):
        o = self.opt.output
        best_rank = res.best_rank[:n]
        best = res.best[:n]
        self.stats.assign_batch(best_rank)
        if o.make_tax_counts:
            nodes, cnts = np.unique(best[best != 0], return_counts=True)
            for nd, ct in zip(nodes.tolist(), cnts.tolist()):
                self.tax_counts[nd] = self.tax_counts.get(nd, 0) + ct
        if o.map_view_mode == out_mod.MapViewMode.NONE:
            return
        mapped_only = o.map_view_mode == out_mod.MapViewMode.MAPPED_ONLY
        cache = getattr(self, "_taxstr_cache", None)
        if cache is None:
            cache = self._taxstr_cache = {}
        col = o.format.column
        show_ids = o.show_query_ids
        db = self.db
        bl = best.tolist()
        lines = []
        for i in range(n):
            b = bl[i]
            if mapped_only and b == 0:
                continue
            s = cache.get(b)
            if s is None:
                s = out_mod.show_taxon_str(db, o, b)
                cache[b] = s
            hdr = meta[i][1]
            sp = hdr.find(" ")
            if sp != -1:
                hdr = hdr[:sp]
            if show_ids:
                lines.append(f"{meta[i][0]}{col}{hdr}{col}{s}\n")
            else:
                lines.append(f"{hdr}{col}{s}\n")
        out.write("".join(lines))

    def _collect_target_matches(self, res, i: int, qid: int):
        """matches_per_target::insert semantics
        (src/matches_per_target.h:111-155): sequence-level candidates with
        >= hitsMin hits contribute their window hit lists."""
        tax = self.db.taxonomy
        hits_min = self.engine.hits_min
        for c in range(res.cand_tax.shape[1]):
            node = int(res.cand_tax[i, c])
            if node == 0 or res.cand_hits[i, c] < hits_min:
                continue
            if tax.rank[node] != Rank.SEQUENCE:
                continue
            beg = int(res.cand_beg[i, c])
            wins = [(beg + k, int(h))
                    for k, h in enumerate(res.target_window_hits[i, c])
                    if h > 0]
            if wins:
                self.target_matches.setdefault(node, []).append((qid, wins))

    def write_epilogue(self, out: TextIO, abundance_out: TextIO):
        o = self.opt.output
        if o.show_hits_per_target_list:
            target_out = out
            if o.targets_file and o.targets_file != o.query_mappings_file:
                target_out = open(o.targets_file, "w")
            try:
                out_mod.show_matches_per_targets(
                    target_out, self.db, self.target_matches, o)
            finally:
                if target_out is not out:
                    target_out.close()
        if o.show_tax_abundances:
            out_mod.show_abundances(
                abundance_out, self.db,
                abundance_mod.sorted_counts(self.db.taxonomy, self.tax_counts),
                self.stats.total(), o)
        if o.abundance_estimates_rank != Rank.NONE:
            est = abundance_mod.estimate_abundance(
                self.db.taxonomy, self.tax_counts, o.abundance_estimates_rank)
            out_mod.show_abundance_estimates(
                abundance_out, self.db,
                abundance_mod.sorted_counts(self.db.taxonomy, est),
                self.stats.total(), o)
        if o.show_summary:
            out_mod.show_summary(out, o, self.stats, self.time_ms,
                                 self.opt.pairing != "none")
            print(f"reads re-run at full width: {self.total_reruns}",
                  file=sys.stderr)
        if self.total_overflow:
            # the one documented fixed-shape divergence (ops/lookup.py):
            # surface it loudly, but on stderr so result files keep full
            # byte-parity with the reference
            print(f"WARNING: match-list overflow on {self.total_overflow} "
                  f"queries — hit counts may be underreported; rerun with a "
                  f"larger -max-locations-per-query", file=sys.stderr)


def main_mode_query(args: ArgsParser) -> int:
    if len(args.positionals) < 2:
        print("usage: metacache query <database> [<reads>...] OPTIONS",
              file=sys.stderr)
        return 1
    dbname = args.positionals[1]
    infiles = [p for p in args.positionals[2:]]
    expanded = _expand_files(infiles)

    if not expanded:
        return run_interactive_query_mode(dbname, args)

    opt = get_query_options(ArgsParser([]) if args is None else args)

    engine = None
    if args.contains("mesh"):
        # distribute database shards over all devices — local or across
        # hosts when jax.distributed is initialized: shard s lives on
        # global device s (the reference's per-rank DB files,
        # mode_query.cpp:421-426)
        import jax
        from ..parallel import ShardedQueryEngine, make_mesh
        from ..parallel import distributed as dist
        devices = jax.devices()
        mesh = make_mesh(devices)
        if jax.process_count() > 1:
            want = dist.local_shard_ids(len(devices), mesh)
        else:
            want = list(range(len(devices)))
        missing = [s for s in want if not os.path.exists(
            shard_path(dbname, s))]
        extra = os.path.exists(shard_path(dbname, len(devices)))
        if missing or extra:
            print(f"-mesh needs exactly one database shard per device: "
                  f"{len(devices)} devices, missing shards {missing}"
                  f"{', and more shards than devices' if extra else ''}",
                  file=sys.stderr)
            return 1
        shards = [Database.load(dbname, s) for s in want]
        for sh in shards:   # per-rank tuning (mode_query.cpp:354-388)
            _apply_database_tuning(opt, sh)
        db = shards[0]
        _adapt_options_to_database(opt, db)
        twk = 16 if opt.output.show_hits_per_target_list else 0
        engine = ShardedQueryEngine(shards, opt.classify, opt.pipeline,
                                    mesh, target_window_k=twk)
        if jax.process_count() > 1 and jax.process_index() != 0:
            # only process 0 writes results (rank 0 in the reference,
            # querying.h:1088-1136)
            opt.output.query_mappings_file = os.devnull
    if engine is None:
        db = load_all_shards(dbname)
        _apply_database_tuning(opt, db)
        _adapt_options_to_database(opt, db)

    if opt.output.show_db_properties:
        # (mode_query.cpp:428-431)
        from ..db.database import print_content_properties, \
            print_static_properties
        print_static_properties(db)
        print_content_properties(db)

    if opt.output.split_files and opt.output.query_mappings_file:
        # one output (and stats) per input file / file pair
        # (mode_query.cpp:55-143 splitout handling). ONE engine serves
        # every group: per-group QueryProcessors only reset the host-side
        # statistics — re-creating the engine would re-upload the whole
        # database per group (the loaded DB is what the reference's REPL
        # and splitout exist to amortize, mode_query.cpp:269-315).
        if engine is None:
            twk = 16 if opt.output.show_hits_per_target_list else 0
            engine = QueryEngine(db, opt.classify, opt.pipeline,
                                 target_window_k=twk)
        prefix = opt.output.query_mappings_file
        step = 2 if opt.pairing == "files" else 1
        files = sorted(expanded) if opt.pairing == "files" else expanded
        for i in range(0, len(files), step):
            group = files[i:i + step]
            proc = QueryProcessor(db, opt, engine=engine)
            outfile = prefix + "_" + os.path.basename(group[0])
            with open(outfile, "w") as out:
                proc.process_files(group, out)
                proc.write_epilogue(out, out)
        return 0

    proc = QueryProcessor(db, opt, engine=engine)
    outfile = opt.output.query_mappings_file
    if outfile:
        with open(outfile, "w") as out:
            proc.process_files(expanded, out)
            ab = out
            if opt.output.abundance_file and \
                    opt.output.abundance_file != outfile:
                with open(opt.output.abundance_file, "w") as abf:
                    proc.write_epilogue(out, abf)
            else:
                proc.write_epilogue(out, ab)
    else:
        proc.process_files(expanded, sys.stdout)
        proc.write_epilogue(sys.stdout, sys.stdout)
    return 0


def _expand_files(infiles: List[str]) -> List[str]:
    expanded: List[str] = []
    for f in infiles:
        if os.path.isdir(f):
            for root, _, files in os.walk(f):
                expanded.extend(os.path.join(root, x) for x in files)
        else:
            expanded.append(f)
    return expanded


def run_interactive_query_mode(dbname: str, init_args: ArgsParser) -> int:
    """Primitive REPL for repeated querying with one loaded database
    (run_interactive_query_mode, src/mode_query.cpp:269-315).

    The engine (device-resident DB arrays + compiled pipeline) is cached
    across lines and only rebuilt when a line changes options that shape
    the device program — the loaded DB is exactly what the reference's
    REPL exists to amortize. Database tuning flags apply once, from the
    initial command line (read_database consumes them before the REPL
    starts, mode_query.cpp:331-395)."""
    db = load_all_shards(dbname)
    _apply_database_tuning(get_query_options(init_args), db)
    init_argv = ["query", dbname]
    engine_cache: Dict[tuple, QueryEngine] = {}
    while True:
        try:
            line = input("$> ")
        except EOFError:
            print("Terminate.")
            return 0
        if not line or line.startswith(":q"):
            print("Terminate.")
            return 0
        if line.startswith("#"):
            continue
        argv = init_argv + line.split()
        args = ArgsParser(argv)
        files = _expand_files(args.positionals[2:])
        opt = get_query_options(args)
        _adapt_options_to_database(opt, db)
        if opt.pairing == "files":
            files = sorted(files)
        try:
            twk = 16 if opt.output.show_hits_per_target_list else 0
            # key on program-SHAPE parameters only: hits_min/hits_diff are
            # runtime device scalars, so a -hitmin/-hitdiff change reuses
            # the compiled engine (update_runtime_thresholds)
            c = opt.classify
            key = (c.lowest_rank, c.highest_rank, c.insert_size_max,
                   c.max_candidates, dataclasses.astuple(opt.pipeline), twk)
            engine = engine_cache.get(key)
            if engine is None:
                engine = QueryEngine(db, opt.classify, opt.pipeline,
                                     target_window_k=twk)
                engine_cache[key] = engine
            else:
                engine.update_runtime_thresholds(opt.classify)
                print("(reusing loaded engine)", file=sys.stderr)
            proc = QueryProcessor(db, opt, engine=engine)
            outfile = opt.output.query_mappings_file
            out = open(outfile, "w") if outfile else sys.stdout
            try:
                proc.process_files(files, out)
                proc.write_epilogue(out, out)
            finally:
                if outfile:
                    out.close()
        except Exception as e:
            if opt.output.show_errors:
                print(e, file=sys.stderr)


def _apply_database_tuning(opt: QueryModeOptions, db: Database):
    """Query-time database re-parameterization (mode_query.cpp:354-388):
    -remove-overpopulated-features / -max-locations-per-feature apply
    maintenance at load; -sketchlen/-winlen/-winstride override the QUERY
    sketcher only (the stored target sketches are untouched)."""
    if opt.remove_overpopulated_features:
        old = db.features.num_keys
        maxlpf = opt.max_locations_per_feature - 1
        lim = Database.MAX_SUPPORTED_LOCS_PER_FEATURE
        if maxlpf < 0 or maxlpf >= lim:
            maxlpf = lim - 1
        maxlpf = min(maxlpf, db.max_locations_per_feature - 1)
        if maxlpf > 0:  # always keep buckets with size 1
            print(f"\nRemoving features with more than {maxlpf} "
                  f"locations... ", file=sys.stderr, end="")
            rem = db.remove_overpopulated_features(maxlpf)
            print(f"{rem} of {old} removed.", file=sys.stderr)
        # in case the new max is less than the database setting
        db.set_max_locations_per_feature(opt.max_locations_per_feature)
    elif opt.max_locations_per_feature > 1:
        db.set_max_locations_per_feature(opt.max_locations_per_feature)
        print(f"max locations per feature set to "
              f"{opt.max_locations_per_feature}", file=sys.stderr)
    qp = db.query_sketch_params
    if opt.db_win_len > 0:
        qp = dataclasses.replace(qp, window_size=opt.db_win_len)
    if opt.db_win_stride > 0:
        qp = dataclasses.replace(qp, window_stride=opt.db_win_stride)
    if opt.db_sketch_len > 0:
        qp = dataclasses.replace(qp, sketch_size=opt.db_sketch_len)
    db.query_sketch_params = qp


def _adapt_options_to_database(opt: QueryModeOptions, db: Database):
    """hitsMin deduction from the TARGET sketcher's sketch size — not the
    query sketcher, so a -sketchlen override leaves the threshold unchanged
    (src/mode_query.cpp:247-260: db.target_sketcher().sketch_size())."""
    resolved = opt.classify.resolved_hits_min(
        db.sketch_params.sketch_size)
    opt.classify = dataclasses.replace(opt.classify, hits_min=resolved)
