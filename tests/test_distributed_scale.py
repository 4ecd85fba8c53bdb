"""At-scale multichip correctness: the 8-virtual-device
sharded engine must reproduce the fused single-table engine PER READ on a
world big enough to exercise real shard sizes — strain-sharing + a repeat
element (two-tier overflow), >=10k reads, with the full output flag
surface (candidates, per-target window hits, abundance counts, stats) —
and shard-count invariance must hold config-3-style (P=2 vs P=1).

Reference semantics: every rank queries the same read block against its
own shard and candidates merge across ranks (src/querying.h:892-1071);
the merged result must be invariant in the shard count.
"""
import numpy as np
import pytest

import jax

from metacache_tpu.config import ClassifyParams, QueryPipelineParams
from metacache_tpu.db.build import BuildOptions, build_database_shards
from metacache_tpu.parallel import ShardedQueryEngine, make_mesh
from metacache_tpu.query.engine import QueryEngine, encode_read_into

RNG = np.random.default_rng(31)
N_READS = 10240
B = 2048


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from tests import util_mockdata as mock
    tmp = str(tmp_path_factory.mktemp("distscale"))
    bases = np.array(list("ACGT"))
    # 24 targets: 8 species x 3 strains (2% divergence) + a 400bp repeat
    # element at 4 sites per genome of species 0 ONLY (12 sites total:
    # deep-ish buckets exercising the two-tier dispatch while keeping
    # every read's full match list under max_locations_per_query — a
    # DEEPER repeat would trip the documented per-shard truncation
    # divergence, which is not what this per-read equality test checks)
    repeat = "".join(bases[RNG.integers(0, 4, 400)])
    nodes = [(1, 1, "no rank"), (2, 1, "superkingdom")]
    names = {1: "root", 2: "Bacteria"}
    genomes, records = [], []
    gi = 0
    for sp in range(8):
        nodes.append((100 + sp, 2, "species"))
        names[100 + sp] = f"Species{sp}"
        base = RNG.integers(0, 4, 120_000, dtype=np.int8)
        for v in range(3):
            g = base.copy()
            if v:
                m = RNG.random(len(g)) < 0.02
                g[m] = RNG.integers(0, 4, int(m.sum()), dtype=np.int8)
            s = "".join(bases[g])
            if sp == 0:
                for c in range(4):
                    p = 20_000 + c * 25_000
                    s = s[:p] + repeat + s[p + len(repeat):]
            genomes.append(s)
            records.append((gi, 100 + sp, s))
            gi += 1
    mock.write_ncbi_taxonomy(tmp + "/tax", nodes, names)
    fasta = tmp + "/genomes.fa"
    with open(fasta, "w") as f:
        for gi, sp, s in records:
            f.write(f">NC_{gi:06d}.1|taxid|{sp}| strain\n{s}\n")
    reads = []
    for i in range(N_READS):
        if i % 37 == 0:   # repeat-region reads (deep-bucket path)
            g = int(RNG.integers(0, 3))
            pos = 20_050 + int(RNG.integers(0, 300))
        else:
            g = int(RNG.integers(0, len(genomes)))
            pos = int(RNG.integers(0, len(genomes[g]) - 400))
        reads.append((g, genomes[g][pos:pos + 100],
                      genomes[g][pos + 220:pos + 320]))
    opt = BuildOptions(taxonomy_nodes=tmp + "/tax/nodes.dmp",
                       taxonomy_names=tmp + "/tax/names.dmp",
                       taxonomy_merged=tmp + "/tax/merged.dmp")
    return dict(fasta=fasta, opt=opt, reads=reads)


def _classify_all(eng, reads, target_window_k=0):
    """Stream all reads through the engine in B-sized batches; returns
    per-read best/best_rank plus candidate tensors and optional
    target-window hits for the flag surface comparison."""
    out_best, out_rank = [], []
    out_ctax, out_chits = [], []
    out_twh = []
    for off in range(0, len(reads), B):
        chunk = reads[off:off + B]
        c1 = np.zeros((B, 104), np.uint8)
        l1 = np.zeros(B, np.int32)
        c2 = np.zeros((B, 104), np.uint8)
        l2 = np.zeros(B, np.int32)
        for i, (_, s1, s2) in enumerate(chunk):
            encode_read_into(c1, l1, i, s1, 104)
            encode_read_into(c2, l2, i, s2, 104)
        res = eng.classify_batch(c1, l1, c2, l2, len(chunk))
        out_best.append(res.best[:len(chunk)].copy())
        out_rank.append(res.best_rank[:len(chunk)].copy())
        out_ctax.append(res.cand_tax[:len(chunk)].copy())
        out_chits.append(res.cand_hits[:len(chunk)].copy())
        if target_window_k:
            out_twh.append(np.asarray(
                res.target_window_hits)[:len(chunk)].copy())
    r = (np.concatenate(out_best), np.concatenate(out_rank),
         np.concatenate(out_ctax), np.concatenate(out_chits))
    return r + ((np.concatenate(out_twh),) if target_window_k else ())



def test_sharded8_equals_fused_at_scale(world):
    devices = jax.devices()[:8]
    assert len(devices) == 8
    mesh = make_mesh(devices)
    dbs = build_database_shards([world["fasta"]], world["opt"],
                                num_shards=8)
    import copy
    from metacache_tpu.db.feature_table import FeatureTable
    fused_db = copy.copy(dbs[0])
    fused_db.features = FeatureTable.concat_shards([d.features for d in dbs])

    classify = ClassifyParams(lowest_rank="species")
    pipeline = QueryPipelineParams(batch_size=B, max_query_len=104,
                                   max_locations_per_query=512)
    twk = 8
    sharded = ShardedQueryEngine(dbs, classify, pipeline, mesh,
                                 target_window_k=twk)
    fused = QueryEngine(fused_db, classify, pipeline, devices=devices[:1],
                        target_window_k=twk)
    sb, sr, sct, sch, stw = _classify_all(sharded, world["reads"], twk)
    fb, fr, fct, fch, ftw = _classify_all(fused, world["reads"], twk)
    np.testing.assert_array_equal(sb, fb)
    np.testing.assert_array_equal(sr, fr)
    np.testing.assert_array_equal(sct, fct)
    np.testing.assert_array_equal(sch, fch)
    np.testing.assert_array_equal(stw, ftw)
    classified = sb != 0
    assert classified.mean() > 0.9, "world must be non-trivially classifiable"
    # abundance counts (make_tax_counts surface) must agree exactly
    su, sc = np.unique(sb[classified], return_counts=True)
    fu, fc = np.unique(fb[fb != 0], return_counts=True)
    np.testing.assert_array_equal(su, fu)
    np.testing.assert_array_equal(sc, fc)



def test_shard_count_invariance_p2_vs_p1(world):
    """config-3-shaped check: the same world queried through a P=2 mesh
    and a P=1 mesh must classify every read identically."""
    classify = ClassifyParams(lowest_rank="species")
    pipeline = QueryPipelineParams(batch_size=B, max_query_len=104,
                                   max_locations_per_query=512)
    dbs2 = build_database_shards([world["fasta"]], world["opt"],
                                 num_shards=2)
    mesh2 = make_mesh(jax.devices()[:2])
    eng2 = ShardedQueryEngine(dbs2, classify, pipeline, mesh2)
    dbs1 = build_database_shards([world["fasta"]], world["opt"],
                                 num_shards=1)
    mesh1 = make_mesh(jax.devices()[:1])
    eng1 = ShardedQueryEngine(dbs1, classify, pipeline, mesh1)
    reads = world["reads"][:4096]
    b2, r2, *_ = _classify_all(eng2, reads)
    b1, r1, *_ = _classify_all(eng1, reads)
    np.testing.assert_array_equal(b2, b1)
    np.testing.assert_array_equal(r2, r1)
