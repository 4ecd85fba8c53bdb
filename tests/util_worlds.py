"""Seeded benchmark worlds shared by bench.py and chip_smoke.py.

Config-3 (BASELINE.json config 3): 50 base genomes x 4 strains of 25 Mbp
(5 Gbp), strains at ~2% substitutions, a 5 kbp transposon inserted 5 times
per genome (its bucket hits the 254-location cap), 4 species per genus,
and paired 100 bp reads (insert 350 bp, 1.5% substitutions) drawn evenly
over the genomes and shuffled.
"""
from __future__ import annotations

import os

import numpy as np

from tests import util_mockdata as mock

C3_BASES = 50           # base genomes
C3_VARIANTS = 4         # strains per base (incl. the base)
C3_GLEN = 25_000_000    # 25 Mbp per genome -> 5.0 Gbp total
C3_TP_LEN = 5_000
C3_TP_COPIES = 5        # per genome -> transposon bucket hits the 254 cap
C3_PAIRS = 1_048_576

_B = np.frombuffer(b"ACGT", np.uint8)


def make_config3_world(out_dir: str, *, bases: int = C3_BASES,
                       genome_len: int = C3_GLEN, pairs: int = C3_PAIRS,
                       seed: int = 77) -> dict:
    """Write genomes.fa, tax/ and reads_{1,2}.fa under out_dir.

    Genomes are generated one at a time (one genome in RAM); reads are
    sampled from each genome as it is written, pairs // (bases * 4) per
    genome. Returns the paths, the genome bases and the pair count."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    tp = rng.integers(0, 4, C3_TP_LEN).astype(np.int8)
    nodes = [(1, 1, "no rank"), (2, 1, "superkingdom")]
    names = {1: "root", 2: "Bacteria"}
    for b in range(bases):
        genus = 10 + b // 5
        if (genus, 2, "genus") not in nodes:
            nodes.append((genus, 2, "genus"))
            names[genus] = f"Genus{b // 5}"
        nodes.append((100 + b, genus, "species"))
        names[100 + b] = f"Species{b}"
    mock.write_ncbi_taxonomy(os.path.join(out_dir, "tax"), nodes, names)
    reads_per_genome = pairs // (bases * C3_VARIANTS)
    span = np.arange(100)
    r1_chunks, r2_chunks, read_ids = [], [], []
    with open(os.path.join(out_dir, "genomes.fa"), "wb") as f:
        gi = 0
        for b in range(bases):
            base = rng.integers(0, 4, genome_len, dtype=np.int8)
            for v in range(C3_VARIANTS):
                g = base.copy()
                if v:
                    m = rng.random(genome_len) < 0.02
                    g[m] = rng.integers(0, 4, int(m.sum()), dtype=np.int8)
                for _ in range(C3_TP_COPIES):
                    p = int(rng.integers(0, genome_len - C3_TP_LEN))
                    g[p:p + C3_TP_LEN] = tp
                sp = 100 + b
                f.write(f">NC_{gi:06d}.1|taxid|{sp}| strain\n".encode())
                f.write(_B[g].tobytes())
                f.write(b"\n")
                pos = rng.integers(0, genome_len - 400, reads_per_genome)
                a = g[pos[:, None] + span[None, :]]
                c = g[pos[:, None] + 250 + span[None, :]]
                for r in (a, c):
                    m = rng.random(r.shape) < 0.015
                    r[m] = rng.integers(0, 4, int(m.sum()), dtype=np.int8)
                r1_chunks.append(a)
                r2_chunks.append(c)
                read_ids.extend([gi] * reads_per_genome)
                gi += 1
    a1 = _B[np.concatenate(r1_chunks)]
    a2 = _B[np.concatenate(r2_chunks)]
    perm = np.random.default_rng(5).permutation(len(read_ids))
    ids = np.asarray(read_ids)[perm]
    a1, a2 = a1[perm], a2[perm]
    paths = {"dir": out_dir, "genomes": os.path.join(out_dir, "genomes.fa"),
             "tax": os.path.join(out_dir, "tax")}
    for mate, arr in (("1", a1), ("2", a2)):
        path = os.path.join(out_dir, f"reads_{mate}.fa")
        paths[f"reads_{mate}"] = path
        with open(path, "wb") as f:
            for i in range(arr.shape[0]):
                f.write(b">p%d_NC_%06d.1/%s\n" % (i, ids[i], mate.encode()))
                f.write(arr[i].tobytes())
                f.write(b"\n")
    paths["bases"] = bases * C3_VARIANTS * genome_len
    paths["pairs"] = len(read_ids)
    return paths
