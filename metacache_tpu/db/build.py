"""Database build pipeline: FASTA/FASTQ genomes -> sketches -> feature table.

The analogue of mode_build's add_to_database
(src/mode_build.cpp:559-843):
  - input files are sorted so every shard agrees on the target order
    (src/mode_build.cpp:570-575)
  - every shard sees every sequence, but only sketches target t when
    ``t % num_shards == shard_id`` (add_target_distributed,
    src/sketch_database.h:519-563); taxonomy + target metadata are
    replicated
  - sequence-level taxa get negative ids ``-(t+1)``
    (src/sketch_database.h:149-150)
  - parent taxid resolution: header accession / accession.version / taxid
    extraction + mapping files (try_to_rank_unranked_targets,
    src/mode_build.cpp:414-539)
  - overpopulated-feature removal uses counts merged across ALL shards
    (the log2(P) tree merge + bcast at mode_build.cpp:847-1074) — here a
    host-side sum over shard count dumps.

Sketching runs on device in fixed-shape window batches: windows of all
sequences are packed into [BATCH, window_size] uint8 tensors; one
`sketch_windows` call per batch; triples accumulate in host numpy buffers.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..config import BuildParams, SketchParams, FEATURE_SENTINEL
from ..io import sequence_io, taxonomy_io
from ..ops import encode, sketch
from .database import Database
from .feature_table import ChunkedTripleSorter, FeatureTable
from .taxonomy import NONE_TAXID, Rank, Taxonomy

#: windows per device batch during build (large batches amortize the
#: per-dispatch host<->device transfer cost)
BUILD_WINDOW_BATCH = 8192


class TripleAccumulator:
    """Chunked growing buffers for (feature, target, window) triples."""

    def __init__(self):
        self._chunks: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    def add(self, f: np.ndarray, t: np.ndarray, w: np.ndarray):
        self._chunks.append((f, t, w))

    def concat(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if not self._chunks:
            z = np.zeros(0, np.uint32), np.zeros(0, np.int32), np.zeros(0, np.int32)
            return z
        f = np.concatenate([c[0] for c in self._chunks])
        t = np.concatenate([c[1] for c in self._chunks])
        w = np.concatenate([c[2] for c in self._chunks])
        return f, t, w


class WindowBatcher:
    """Packs per-sequence windows into fixed-shape device batches and turns
    the resulting sketches into triples."""

    def __init__(self, params: SketchParams, triples: TripleAccumulator,
                 batch_size: int = BUILD_WINDOW_BATCH):
        self.p = params
        self.triples = triples
        self.batch_size = batch_size
        self._codes = np.full((batch_size, params.window_size), 255, np.uint8)
        self._lens = np.zeros(batch_size, np.int32)
        self._tgt = np.zeros(batch_size, np.int32)
        self._win = np.zeros(batch_size, np.int32)
        self._n = 0

    _pending = None  # in-flight device sketch (double buffering)

    def add_sequence(self, seq_codes: np.ndarray, target_id: int) -> int:
        """Queue all windows of one sequence; returns the window count
        (incl. tail windows — for_each_window, src/dna_encoding.h:261-276).

        Windowing is vectorized: full windows are strided views into the
        sequence, copied batch-row-block at a time (the reference's scalar
        per-window loop would dominate build time host-side)."""
        W, stride = self.p.window_size, self.p.window_stride
        L = len(seq_codes)
        starts = encode.window_starts(L, W, stride)
        n_win = len(starts)
        lens = np.minimum(L - starts, W).astype(np.int32)
        wins = np.full((n_win, W), 255, np.uint8)
        if L <= W:
            wins[0, :L] = seq_codes
        else:
            sv = np.lib.stride_tricks.sliding_window_view(seq_codes, W)
            full = lens == W
            wins[full] = sv[starts[full]]
            for i in np.nonzero(~full)[0]:  # at most the tail window
                s = starts[i]
                wins[i, :lens[i]] = seq_codes[s:s + lens[i]]
        wi = 0
        while wi < n_win:
            take = min(self.batch_size - self._n, n_win - wi)
            sl = slice(self._n, self._n + take)
            self._codes[sl] = wins[wi:wi + take]
            self._lens[sl] = lens[wi:wi + take]
            self._tgt[sl] = target_id
            self._win[sl] = np.arange(wi, wi + take, dtype=np.int32)
            self._n += take
            wi += take
            if self._n == self.batch_size:
                self.flush()
        return n_win

    def flush(self):
        """Dispatch the current window batch; materialize the previous one
        (one batch in flight overlaps device sketching with host packing)."""
        if self._n:
            # pass copies: jnp.asarray may alias the numpy buffers
            # (zero-copy on CPU, lazy transfer elsewhere) and the
            # batch buffers are refilled while this dispatch is in flight
            sk_dev = sketch.sketch_windows(
                self._codes.copy(), self._lens.copy(), self.p.kmer_size,
                self.p.sketch_size)
            pending = (sk_dev, self._n, self._tgt[:self._n].copy(),
                       self._win[:self._n].copy())
            self._n = 0
        else:
            pending = None
        if self._pending is not None:
            self._drain(*self._pending)
        self._pending = pending

    def finish(self):
        self.flush()
        if self._pending is not None:
            self._drain(*self._pending)
            self._pending = None

    def _drain(self, sk_dev, n, tgt, win):
        sk = np.asarray(sk_dev)[:n]
        valid = sk != FEATURE_SENTINEL
        counts = valid.sum(axis=1)
        f = sk[valid]
        t = np.repeat(tgt, counts)
        w = np.repeat(win, counts)
        self.triples.add(f.astype(np.uint32), t.astype(np.int32),
                         w.astype(np.int32))


def _native_sketch_path(path, p: SketchParams, sorters: Dict, taxonomy,
                        target_nodes: List[int], seen_names, seq2taxid,
                        num_shards: int, shard_ids: List[int],
                        progress) -> bool:
    """Parse + sketch one input file through the native C++ hot loop
    (native.sketch_file: bit-identical to the device sketch pipeline,
    tests/test_native_sketch.py), in ONE pass for every requested shard:
    with a single shard the native pass gates records by
    (t0+i) % num_shards == shard_id (add_target_distributed,
    src/sketch_database.h:519-563); with several shards every record is
    sketched once and its triples are routed host-side to the owning
    shard's sorter — the reference's ranks parse concurrently in separate
    processes (mode_build.cpp:559-617), a single-process multi-shard build
    must not parse the input S times.

    Returns False to fall back to the python/device path: native
    unavailable, params out of native range, or the file contains records
    the python loop would SKIP (empty sequences / duplicate ids) —
    skipping shifts target numbering, which the native pass assigned up
    front."""
    if os.environ.get("METACACHE_NO_NATIVE_BUILD"):
        return False
    from .. import native
    one = len(shard_ids) == 1
    try:
        res = native.sketch_file(path, p.kmer_size, p.sketch_size,
                                 p.window_size, p.window_stride,
                                 t0=len(target_nodes),
                                 num_shards=num_shards if one else 1,
                                 shard_id=shard_ids[0] if one else 0)
    except RuntimeError:
        raise  # malformed file: report like FormatError (caller catches)
    if res is None:
        return False
    sids = []
    batch_seen = set()
    for i, header in enumerate(res.headers):
        sid = sequence_io.extract_accession_string(header) \
            or header.split(" ")[0] or header
        if res.seq_lens[i] == 0 or sid in seen_names or sid in batch_seen:
            return False  # rare: python loop handles renumbering
        batch_seen.add(sid)
        sids.append(sid)
    owned_set = set(shard_ids)
    for i, (header, sid) in enumerate(zip(res.headers, sids)):
        seen_names.add(sid)
        tgt = len(target_nodes)
        parent = resolve_parent_taxid(header, seq2taxid, taxonomy)
        # source_windows only for locally-sketched targets, matching the
        # python/device loop (non-owned targets record 0 windows)
        owned = (tgt % num_shards) in owned_set
        node = taxonomy.add_node(
            -(tgt + 1), parent if parent else NONE_TAXID, sid,
            Rank.SEQUENCE, source_filename=path, source_index=i + 1,
            source_windows=int(res.seq_windows[i]) if owned else 0)
        target_nodes.append(node)
        if progress:
            progress(path, tgt)
    if len(res.feat):
        if one:
            sorters[shard_ids[0]].add(res.feat, res.tgt, res.win)
        else:
            owner = res.tgt % np.int32(num_shards)
            for s in shard_ids:
                sel = owner == s
                if sel.any():
                    sorters[s].add(res.feat[sel], res.tgt[sel],
                                   res.win[sel])
    return True


#: input files at or above this size stream through the native SPILL path
#: (parse + sketch + per-shard sorted chunk files with bounded memory)
#: instead of materializing the whole file's triples in host RAM — a 5 Gbp
#: file holds ~700M triples = 8.4 GB, and round-4 builds peaked at 33 GB
#: RSS for a 10 GB table. Files below it keep the in-RAM fast path (no
#: disk round-trip for small builds).
SPILL_MIN_BYTES = int(os.environ.get("METACACHE_SPILL_MIN_BYTES",
                                     256 << 20))


def _native_spill_path(path, p: SketchParams, sorters: Dict, taxonomy,
                       target_nodes: List[int], seen_names, seq2taxid,
                       num_shards: int, shard_ids: List[int],
                       progress, spill_dir: str, chunk_triples: int) -> bool:
    """Bounded-memory variant of _native_sketch_path for LARGE files:
    the native pass (mcio_sketch_file_spill) parses, sketches, and spills
    feature-sorted per-shard triple chunk files directly — triples never
    enter Python, and peak memory is the parse queue + one chunk buffer
    per shard regardless of file size. The chunk files are adopted by each
    shard's external sorter (insertion order preserved; finalize K-way
    merges them straight into CSR table files).

    Returns False to fall back (native unavailable / params out of range /
    records the python loop would renumber) — any chunks already written
    are deleted first."""
    if os.environ.get("METACACHE_NO_NATIVE_BUILD"):
        return False
    from .. import native
    prefix = os.path.join(spill_dir, f"t{len(target_nodes)}")
    res = native.sketch_file_spill(
        path, p.kmer_size, p.sketch_size, p.window_size, p.window_stride,
        t0=len(target_nodes), num_shards=num_shards, shard_ids=shard_ids,
        chunk_triples=chunk_triples, prefix=prefix)
    if res is None:
        return False

    def _drop_chunks():
        for _, cpath, _ in res.chunks:
            if os.path.exists(cpath):
                os.unlink(cpath)

    sids = []
    batch_seen = set()
    for i, header in enumerate(res.headers):
        sid = sequence_io.extract_accession_string(header) \
            or header.split(" ")[0] or header
        if res.seq_lens[i] == 0 or sid in seen_names or sid in batch_seen:
            _drop_chunks()
            return False  # rare: python loop handles renumbering
        batch_seen.add(sid)
        sids.append(sid)
    owned_set = set(shard_ids)
    for i, (header, sid) in enumerate(zip(res.headers, sids)):
        seen_names.add(sid)
        tgt = len(target_nodes)
        parent = resolve_parent_taxid(header, seq2taxid, taxonomy)
        owned = (tgt % num_shards) in owned_set
        node = taxonomy.add_node(
            -(tgt + 1), parent if parent else NONE_TAXID, sid,
            Rank.SEQUENCE, source_filename=path, source_index=i + 1,
            source_windows=int(res.seq_windows[i]) if owned else 0)
        target_nodes.append(node)
        if progress:
            progress(path, tgt)
    for s in shard_ids:
        mine = [(cpath, cnt) for sh, cpath, cnt in res.chunks if sh == s]
        if mine:
            sorters[s].adopt_chunks(mine)
    return True


@dataclasses.dataclass
class BuildOptions:
    """mode_build options (src/mode_build.cpp:63-138)."""
    params: BuildParams = dataclasses.field(default_factory=BuildParams)
    taxonomy_nodes: str = ""
    taxonomy_names: str = ""
    taxonomy_merged: str = ""
    # mapping files applied while reading sequences (same dir as inputs)
    sequence_id_mappings: Tuple[str, ...] = (
        "assembly_summary.txt",)
    # post-build accession -> taxid mapping files
    taxpostmap: Tuple[str, ...] = ()
    reset_parents: bool = False
    # silent | moderate | verbose (io_options.h:32, mode_build.cpp:102-106)
    info_level: str = "moderate"
    # triples per in-RAM chunk of the external sort (ChunkedTripleSorter);
    # bounds build memory: RefSeq-scale builds spill sorted chunks to disk
    chunk_triples: int = 32 << 20


def gather_input_files(infiles: Sequence[str], max_depth: int = 10) -> List[str]:
    """Expand directories recursively (filesys_utility, depth 10 as in
    docs/build.txt:12) and sort — all shards must agree on target order
    (mode_build.cpp:570-575)."""
    out: List[str] = []
    for f in infiles:
        if os.path.isdir(f):
            for root, dirs, files in os.walk(f):
                depth = root[len(f):].count(os.sep)
                if depth >= max_depth:
                    dirs[:] = []
                    continue
                for name in files:
                    out.append(os.path.join(root, name))
        else:
            out.append(f)
    return sorted(out)


def resolve_parent_taxid(header: str,
                         seq2taxid: Dict[str, int],
                         taxonomy: Taxonomy) -> int:
    """Find a parent taxid for a sequence from its header
    (extract_taxon_id / accession lookups; mode_build.cpp:300-380 semantics).
    """
    tid = sequence_io.extract_taxon_id(header)
    if tid and taxonomy.node_of_id(tid):
        return tid
    for key in (sequence_io.extract_ncbi_accession_version(header),
                sequence_io.extract_ncbi_accession(header),
                header.split(" ")[0] if header else ""):
        if key and key in seq2taxid:
            return seq2taxid[key]
    return NONE_TAXID


def build_database_shards(infiles: Sequence[str], opt: BuildOptions,
                          num_shards: int = 1,
                          shard_ids: Optional[Sequence[int]] = None,
                          progress=None) -> List["Database"]:
    """Build several shards of the database in ONE pass over the inputs
    (main_mode_build flow, src/mode_build.cpp:1145-1175 + add_to_database
    :797-843). Each input file is parsed (and each record sketched)
    exactly once; triples are routed to the owning shard's external
    sorter. The reference achieves one-parse-per-rank by running ranks as
    separate processes (mode_build.cpp:559-617); a single-process
    multi-shard build here must not multiply the parse cost by S.

    shard_ids: the shards to materialize (default: all of them).
    Returns one Database per requested shard, in shard_ids order.
    """
    p = opt.params.sketch
    shard_ids = list(range(num_shards)) if shard_ids is None \
        else list(shard_ids)

    taxonomy = taxonomy_io.make_taxonomic_hierarchy(
        opt.taxonomy_nodes, opt.taxonomy_names, opt.taxonomy_merged) \
        if opt.taxonomy_nodes else Taxonomy()
    if not taxonomy.node_of_id(1):
        taxonomy.add_node(1, 1, "root", Rank.ROOT)

    files = gather_input_files(infiles)
    seq2taxid = taxonomy_io.make_sequence_to_taxon_id_map(
        opt.sequence_id_mappings, files)

    sorters = {s: ChunkedTripleSorter(chunk_triples=opt.chunk_triples)
               for s in shard_ids}
    batchers = {s: WindowBatcher(p, sorters[s]) for s in shard_ids}
    owned_set = set(shard_ids)

    import tempfile
    import time as _time
    _timing = bool(os.environ.get("METACACHE_BUILD_TIMING"))
    _t0 = _time.time()
    target_nodes: List[int] = []
    seen_names = set()
    spill_dir: Optional[str] = None
    for path in files:
        try:
            try:
                big = os.path.getsize(path) >= SPILL_MIN_BYTES
            except OSError:
                big = False
            if big:
                if spill_dir is None:
                    spill_dir = tempfile.mkdtemp(prefix="mc_spill_")
                if _native_spill_path(path, p, sorters, taxonomy,
                                      target_nodes, seen_names, seq2taxid,
                                      num_shards, shard_ids, progress,
                                      spill_dir, opt.chunk_triples):
                    continue
            if _native_sketch_path(path, p, sorters, taxonomy, target_nodes,
                                   seen_names, seq2taxid, num_shards,
                                   shard_ids, progress):
                continue
            records = sequence_io.read_sequences(path)
            for rec in records:
                sid = sequence_io.extract_accession_string(rec.header) \
                    or rec.header.split(" ")[0] or rec.header
                if not rec.data or sid in seen_names:
                    continue
                seen_names.add(sid)
                tgt = len(target_nodes)
                taxid = -(tgt + 1)  # sequence-level taxon id
                parent = resolve_parent_taxid(rec.header, seq2taxid, taxonomy)
                windows = 0
                owner = tgt % num_shards
                if owner in owned_set:
                    codes = encode.np_encode_bytes(
                        np.frombuffer(rec.data.encode(), dtype=np.uint8))
                    windows = batchers[owner].add_sequence(codes, tgt)
                node = taxonomy.add_node(
                    taxid, parent if parent else NONE_TAXID, sid,
                    Rank.SEQUENCE, source_filename=path,
                    source_index=rec.index, source_windows=windows)
                target_nodes.append(node)
                if progress:
                    progress(path, tgt)
        except (sequence_io.FormatError, RuntimeError) as e:
            # per-file errors are caught and logged (mode_build.cpp:630-643)
            print(f"FAIL: {path}: {e}")
    for b in batchers.values():
        b.finish()
    if _timing:
        import sys as _sys
        print(f"[build-timing] parse+sketch+route+spill: "
              f"{_time.time() - _t0:.1f}s", file=_sys.stderr)
        _t0 = _time.time()

    # post-build taxon mapping files (taxpostmap)
    if opt.taxpostmap:
        post_map: Dict[str, int] = {}
        for mf in opt.taxpostmap:
            taxonomy_io.read_sequence_to_taxon_id_mapping(mf, post_map)
        rank_unranked_targets(taxonomy, target_nodes, post_map,
                              reset_parents=opt.reset_parents,
                              info_level=opt.info_level)

    target_arr = np.array(target_nodes, dtype=np.int32)
    # finalize shards concurrently: the external sort's merge passes are
    # native radix/CSR calls + large numpy ops (both release the GIL), and
    # each shard's sorter is fully independent — 2 shards finalize in the
    # time of one (measured 119 s/shard at config-3 scale)
    if len(shard_ids) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(4, len(shard_ids))) as ex:
            fts = dict(zip(shard_ids, ex.map(
                lambda s: sorters[s].finalize(
                    opt.params.max_locations_per_feature), shard_ids)))
    else:
        fts = {s: sorters[s].finalize(opt.params.max_locations_per_feature)
               for s in shard_ids}
    if spill_dir is not None:
        import shutil
        shutil.rmtree(spill_dir, ignore_errors=True)
    if _timing:
        import sys as _sys
        print(f"[build-timing] finalize ({len(shard_ids)} shards): "
              f"{_time.time() - _t0:.1f}s", file=_sys.stderr)
        _t0 = _time.time()
    dbs: List[Database] = []
    for s in shard_ids:
        ft = fts[s]
        db = Database(
            sketch_params=p, query_sketch_params=p,
            max_locations_per_feature=opt.params.max_locations_per_feature,
            taxonomy=_shard_taxonomy_view(taxonomy, target_arr,
                                          num_shards, s,
                                          len(shard_ids) > 1),
            target_taxon_node=target_arr,
            features=ft, num_shards=num_shards, shard_id=s)

        if opt.params.remove_ambig_features_rank:
            from .taxonomy import rank_from_name
            r = rank_from_name(opt.params.remove_ambig_features_rank)
            if r != Rank.NONE:
                db.remove_ambiguous_features(r,
                                             opt.params.max_taxa_per_feature)
        dbs.append(db)
    return dbs


def _shard_taxonomy_view(taxonomy: Taxonomy, target_nodes: np.ndarray,
                         num_shards: int, shard_id: int, copy: bool):
    """Per-shard taxonomy: identical nodes, but source_windows recorded
    only for the shard's own targets (a shard build sketches only owned
    records, so its DB file reports 0 windows for foreign targets —
    matching the per-shard build path and the reference's per-rank files).
    Shares the underlying node storage via a shallow copy; shard databases
    are not mutated after build (modify mode operates on freshly loaded
    databases)."""
    if not copy or num_shards == 1:
        return taxonomy
    import copy as _copy
    t = _copy.copy(taxonomy)
    sw = taxonomy.source_windows.copy()
    foreign = target_nodes[np.arange(len(target_nodes)) % num_shards
                           != shard_id]
    sw[foreign] = 0
    t._src_windows = sw
    return t


def build_database(infiles: Sequence[str], opt: BuildOptions,
                   num_shards: int = 1, shard_id: int = 0,
                   progress=None) -> Database:
    """Build one shard of the database (see build_database_shards)."""
    return build_database_shards(infiles, opt, num_shards=num_shards,
                                 shard_ids=[shard_id],
                                 progress=progress)[0]


def build_database_from_records(records, params: BuildParams = None,
                                taxonomy: Taxonomy = None,
                                num_shards: int = 1, shard_id: int = 0
                                ) -> Database:
    """Build a database directly from in-memory (header, sequence) pairs —
    used by tests, the REPL, and the graft entry points."""
    params = params or BuildParams()
    p = params.sketch
    taxonomy = taxonomy or Taxonomy()
    if not taxonomy.node_of_id(1):
        taxonomy.add_node(1, 1, "root", Rank.ROOT)
    triples = ChunkedTripleSorter()
    records = list(records)
    sk = None
    if not os.environ.get("METACACHE_NO_NATIVE_BUILD"):
        from .. import native
        sk = native.sketch_sequences(
            [seq.encode() for _, seq in records], p.kmer_size,
            p.sketch_size, p.window_size, p.window_stride, t0=0,
            num_shards=num_shards, shard_id=shard_id)
    batcher = None if sk is not None else WindowBatcher(p, triples)
    target_nodes: List[int] = []
    for header, seq in records:
        sid = sequence_io.extract_accession_string(header) \
            or header.split(" ")[0] or header
        tgt = len(target_nodes)
        parent = sequence_io.extract_taxon_id(header)
        windows = 0
        if tgt % num_shards == shard_id:
            if sk is not None:
                windows = int(sk.seq_windows[tgt])
            else:
                codes = encode.np_encode_bytes(
                    np.frombuffer(seq.encode(), dtype=np.uint8))
                windows = batcher.add_sequence(codes, tgt)
        node = taxonomy.add_node(-(tgt + 1), parent or NONE_TAXID, sid,
                                 Rank.SEQUENCE, source_windows=windows)
        target_nodes.append(node)
    if sk is not None:
        if len(sk.feat):
            triples.add(sk.feat, sk.tgt, sk.win)
    else:
        batcher.finish()
    ft = triples.finalize(params.max_locations_per_feature)
    return Database(
        sketch_params=p, query_sketch_params=p,
        max_locations_per_feature=params.max_locations_per_feature,
        taxonomy=taxonomy,
        target_taxon_node=np.array(target_nodes, dtype=np.int32),
        features=ft, num_shards=num_shards, shard_id=shard_id)


def rank_unranked_targets(taxonomy: Taxonomy, target_nodes: List[int],
                          mapping: Dict[str, int],
                          reset_parents: bool = False,
                          info_level: str = "moderate"):
    """Attach parents to sequence-level taxa from accession->taxid maps
    (try_to_rank_unranked_targets, mode_build.cpp:414-539).

    With `reset_parents`, ALL targets are re-ranked (parents overwritten
    from the mapping files) instead of only the still-unranked ones — the
    upstream MetaCache semantics of `-reset-parents` (the MPI fork parses
    the flag at mode_build.cpp:133 and keeps the `all_targets` helper at
    :475 but never consumes it; we implement the intended behavior)."""
    notify = info_level != "silent"
    todo = [n for n in target_nodes
            if reset_parents or taxonomy.parent_taxid[n] == NONE_TAXID]
    if todo and notify:
        print(f"{len(todo)} targets are unranked.")
    changed = False
    for node in todo:
        name = taxonomy.names[node]
        for key in (name,
                    sequence_io.extract_ncbi_accession_version(name),
                    sequence_io.extract_ncbi_accession(name)):
            if key and key in mapping:
                taxonomy.parent_taxid[node] = mapping[key]
                changed = True
                break
    if changed:
        taxonomy.invalidate_caches()
    if notify:
        remaining = [n for n in target_nodes
                     if taxonomy.parent_taxid[n] == NONE_TAXID]
        if not remaining:
            print("All targets are ranked.")
        else:
            print(f"{len(remaining)} targets remain unranked."
                  f"{taxonomy.names[remaining[0]]}")


def merge_feature_count_arrays(keys: np.ndarray, counts: np.ndarray
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Reduce concatenated (key, count) dumps to unique sorted keys with
    summed counts — one vectorized pass."""
    if len(keys) == 0:
        return (np.zeros(0, np.uint32), np.zeros(0, np.int64))
    uniq, inv = np.unique(keys, return_inverse=True)
    sums = np.bincount(inv, weights=counts).astype(np.int64)
    return uniq.astype(np.uint32), sums


def merge_shard_feature_counts(
        shard_tables: Iterable[FeatureTable]
) -> Tuple[np.ndarray, np.ndarray]:
    """Global (sorted feature keys, location counts) across shards — the
    host-side analogue of the reference's log2(P) tree merge of (key, count)
    dumps (mode_build.cpp:865-1024). Fully vectorized: hundreds of millions
    of keys would never finish as a per-key dict loop."""
    all_keys = []
    all_counts = []
    for ft in shard_tables:
        keys, counts = ft.feature_counts()
        all_keys.append(np.asarray(keys, dtype=np.uint32))
        all_counts.append(np.asarray(counts, dtype=np.int64))
    if not all_keys:
        return (np.zeros(0, np.uint32), np.zeros(0, np.int64))
    return merge_feature_count_arrays(np.concatenate(all_keys),
                                      np.concatenate(all_counts))
