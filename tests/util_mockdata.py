"""Synthetic genomes/reads/taxonomy for end-to-end tests."""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

BASES = np.array(list("ACGT"))

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cli_env(**extra) -> dict:
    """Environment for a CLI child process on the CPU backend, importing
    this checkout's package."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO_ROOT)
    env.update(extra)
    return env


def random_genome(rng, n: int) -> str:
    return "".join(BASES[rng.integers(0, 4, size=n)])


def mutate(rng, seq: str, rate: float) -> str:
    arr = np.array(list(seq))
    mask = rng.random(len(arr)) < rate
    arr[mask] = BASES[rng.integers(0, 4, size=mask.sum())]
    return "".join(arr)


def write_fasta(path: str, records: List[Tuple[str, str]], width: int = 70):
    with open(path, "w") as f:
        for header, seq in records:
            f.write(f">{header}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i:i + width] + "\n")


def write_fastq(path: str, records: List[Tuple[str, str]]):
    with open(path, "w") as f:
        for header, seq in records:
            f.write(f"@{header}\n{seq}\n+\n{'I' * len(seq)}\n")


def write_ncbi_taxonomy(dirpath: str, nodes, names):
    """nodes: list of (taxid, parent, rankname); names: dict taxid->name."""
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "nodes.dmp"), "w") as f:
        for tid, parent, rank in nodes:
            f.write(f"{tid}\t|\t{parent}\t|\t{rank}\t|\textra\t|\n")
    with open(os.path.join(dirpath, "names.dmp"), "w") as f:
        for tid, name in names.items():
            f.write(f"{tid}\t|\t{name}\t|\t\t|\tscientific name\t|\n")
            f.write(f"{tid}\t|\tsyn {name}\t|\t\t|\tsynonym\t|\n")
    with open(os.path.join(dirpath, "merged.dmp"), "w") as f:
        f.write("")
    return (os.path.join(dirpath, "nodes.dmp"),
            os.path.join(dirpath, "names.dmp"),
            os.path.join(dirpath, "merged.dmp"))


def make_mock_world(tmpdir: str, num_genomes: int = 6, genome_len: int = 3000,
                    seed: int = 0):
    """Build a small world: genomes + NCBI-style taxonomy + FASTA files.

    Taxonomy: root(1) -> 2 genera (10,20) -> species (100+i) -> genomes.
    Genome headers carry accession-style ids 'NC_0000<i>.1' and taxids via
    assembly_summary-style mapping.
    Returns (fasta_path, nodes_file, names_file, merged_file, genomes,
             genome_taxids).
    """
    rng = np.random.default_rng(seed)
    genomes = [random_genome(rng, genome_len) for _ in range(num_genomes)]

    nodes = [(1, 1, "no rank"), (2, 1, "superkingdom"),
             (10, 2, "genus"), (20, 2, "genus")]
    names = {1: "root", 2: "Bacteria", 10: "GenusA", 20: "GenusB"}
    genome_taxids = []
    for i in range(num_genomes):
        sp = 100 + i
        genus = 10 if i < (num_genomes + 1) // 2 else 20
        nodes.append((sp, genus, "species"))
        names[sp] = f"Species{i}"
        genome_taxids.append(sp)

    nodes_f, names_f, merged_f = write_ncbi_taxonomy(
        os.path.join(tmpdir, "tax"), nodes, names)

    fasta = os.path.join(tmpdir, "genomes.fa")
    recs = [(f"NC_{i:06d}.1|taxid|{genome_taxids[i]}| Mock genome {i}",
             genomes[i]) for i in range(num_genomes)]
    write_fasta(fasta, recs)
    return fasta, nodes_f, names_f, merged_f, genomes, genome_taxids


def sample_reads(rng, genomes: List[str], n: int, read_len: int = 100,
                 error_rate: float = 0.0):
    """Returns list of (header, seq, true_genome_idx)."""
    out = []
    for i in range(n):
        g = int(rng.integers(0, len(genomes)))
        pos = int(rng.integers(0, len(genomes[g]) - read_len))
        seq = genomes[g][pos:pos + read_len]
        if error_rate:
            seq = mutate(rng, seq, error_rate)
        out.append((f"read{i}_from_NC_{g:06d}.1", seq, g))
    return out
