"""Golden parity: byte-compare per-read classifications against the
reference MetaCache-MPI binary.

The reference is compiled once into /tmp/refbuild from /root/reference with
a FIFO-based MPI stub (P>=2; the reference's distributed query path is
non-functional at P=1 — its merge loop `for(k=num_procs; k>1; k/=2)` never
populates the result map, querying.h:892-1071). Canonical benchmark flags
are used: -pairfiles -lowest species (script/ft/QueryGeneric_FT.sh:121).
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tests import util_mockdata as mock

REF_SRC = "/root/reference/src"
BUILD_DIR = "/tmp/refbuild"
STUB_BIN = os.path.join(BUILD_DIR, "metacache_mpi2")
RUN_STUB = os.path.join(BUILD_DIR, "run_stub.sh")


def _ensure_reference_binary():
    if os.path.exists(STUB_BIN) and os.path.exists(RUN_STUB):
        return True
    if not os.path.isdir(REF_SRC) or not shutil.which("g++"):
        return False
    # the stub + launcher are created by the session setup; if absent we
    # can't rebuild them here (they live outside the repo)
    return os.path.exists(STUB_BIN)


pytestmark = pytest.mark.skipif(not _ensure_reference_binary(),
                                reason="reference binary not available")


def run(cmd, **kw):
    return subprocess.run(cmd, capture_output=True, text=True, **kw)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("golden"))
    fasta, nodes, names, merged, genomes, taxids = mock.make_mock_world(
        tmp, num_genomes=8, genome_len=4000, seed=5)
    rng = np.random.default_rng(123)
    r1, r2 = [], []
    n_reads = 300
    for i in range(n_reads):
        if i % 10 == 9:   # every 10th pair is random (unclassifiable)
            s1 = mock.random_genome(rng, 100)
            s2 = mock.random_genome(rng, 100)
            r1.append((f"pair{i}_random/1", s1))
            r2.append((f"pair{i}_random/2", s2))
            continue
        g = int(rng.integers(0, len(genomes)))
        pos = int(rng.integers(0, len(genomes[g]) - 400))
        s1 = genomes[g][pos:pos + 100]
        s2 = genomes[g][pos + 250:pos + 350]
        if i % 3 == 0:    # a third of the pairs carry 2% errors
            s1 = mock.mutate(rng, s1, 0.02)
            s2 = mock.mutate(rng, s2, 0.02)
        r1.append((f"pair{i}_NC_{g:06d}.1/1", s1))
        r2.append((f"pair{i}_NC_{g:06d}.1/2", s2))
    mock.write_fasta(os.path.join(tmp, "reads_1.fa"), r1)
    mock.write_fasta(os.path.join(tmp, "reads_2.fa"), r2)

    # reference build + query at P=2
    res = run([RUN_STUB, "2", STUB_BIN, "build", f"{tmp}/refdb",
               fasta, "-taxonomy", os.path.join(tmp, "tax")])
    assert os.path.exists(f"{tmp}/refdb.db_0"), res.stderr
    res = run([RUN_STUB, "2", STUB_BIN, "query", f"{tmp}/refdb",
               f"{tmp}/reads_1.fa", f"{tmp}/reads_2.fa",
               "-pairfiles", "-lowest", "species", "-query-limit", "25000",
               "-out", f"{tmp}/ref_out.txt"])
    assert os.path.exists(f"{tmp}/ref_out.txt"), res.stderr
    return dict(tmp=tmp, fasta=fasta, tax=os.path.join(tmp, "tax"))


def _mapping_lines(path):
    with open(path) as f:
        return [l for l in f if not l.startswith("#") and l.strip()]


def _stat_lines(path):
    keep = ("# queries:", "#   se", "#   sp", "#   ge", "#   fa", "#   or",
            "#   cl", "#   ph", "#   ki", "#   do", "#   ro",
            "# unclassified:", "# classified:")
    with open(path) as f:
        return [l for l in f if l.startswith(keep)]


def _run_cli(args, env_extra=None):
    env = mock.cli_env(**(env_extra or {}))
    return run([sys.executable, "-m", "metacache_tpu.cli"] + args,
               cwd=mock.REPO_ROOT, env=env)


class TestGoldenParity:
    def test_build_properties_match(self, golden):
        tmp = golden["tmp"]
        res = _run_cli(["build", f"{tmp}/mydb", golden["fasta"],
                        "-taxonomy", golden["tax"]])
        assert res.returncode == 0, res.stderr
        # compare feature/location counts against the P=2 reference shards:
        # reference prints per-rank counts; ours is a single shard = total
        from metacache_tpu.modes.query import load_all_shards
        db = load_all_shards(f"{tmp}/mydb")
        # parse reference build stdout is brittle; instead verify against
        # the single-process reference build (P=1 build works; only the
        # query path is broken at P=1)
        res1 = run([STUB_BIN, "build", f"{tmp}/refdb1", golden["fasta"],
                    "-taxonomy", golden["tax"]],
                   env=dict(os.environ, MC_STUB_RANK="0", MC_STUB_SIZE="1"))
        props = {}
        for line in res1.stdout.splitlines():
            parts = line.split()
            if len(parts) == 2 and parts[1].isdigit():
                props[parts[0]] = int(parts[1])
        assert props.get("features") == db.features.num_keys
        assert props.get("locations") == db.features.num_locations
        assert props.get("targets") == db.target_count

    def test_per_read_classification_identical(self, golden):
        tmp = golden["tmp"]
        if not os.path.exists(f"{tmp}/mydb_0.npz"):
            _run_cli(["build", f"{tmp}/mydb", golden["fasta"],
                      "-taxonomy", golden["tax"]])
        res = _run_cli(["query", f"{tmp}/mydb",
                        f"{tmp}/reads_1.fa", f"{tmp}/reads_2.fa",
                        "-pairfiles", "-lowest", "species",
                        "-query-limit", "25000",
                        "-out", f"{tmp}/my_out.txt"])
        assert res.returncode == 0, res.stderr
        ref = _mapping_lines(f"{tmp}/ref_out.txt")
        mine = _mapping_lines(f"{tmp}/my_out.txt")
        assert len(ref) == len(mine)
        assert ref == mine
        assert _stat_lines(f"{tmp}/ref_out.txt") == \
            _stat_lines(f"{tmp}/my_out.txt")

    def test_sharded_build_same_results(self, golden):
        tmp = golden["tmp"]
        res = _run_cli(["build", f"{tmp}/mydb4", golden["fasta"],
                        "-taxonomy", golden["tax"], "-num-shards", "4"])
        assert res.returncode == 0, res.stderr
        res = _run_cli(["query", f"{tmp}/mydb4",
                        f"{tmp}/reads_1.fa", f"{tmp}/reads_2.fa",
                        "-pairfiles", "-lowest", "species",
                        "-query-limit", "25000",
                        "-out", f"{tmp}/my_out4.txt"])
        assert res.returncode == 0, res.stderr
        assert _mapping_lines(f"{tmp}/my_out4.txt") == \
            _mapping_lines(f"{tmp}/ref_out.txt")

    def test_sequence_level_parity_with_tophits(self, golden):
        """Sequence-level single-shard parity: the reference P=2 drops
        sequence-level candidates in the cross-rank merge (negative ids
        wrap through uint32), so compare at P=2 with -lowest species
        -tophits instead, which exercises the hits lists."""
        tmp = golden["tmp"]
        res = run([RUN_STUB, "2", STUB_BIN, "query", f"{tmp}/refdb",
                   f"{tmp}/reads_1.fa", f"{tmp}/reads_2.fa",
                   "-pairfiles", "-lowest", "species",
                   "-query-limit", "25000", "-tophits", "-queryids",
                   "-out", f"{tmp}/ref_top.txt"])
        assert os.path.exists(f"{tmp}/ref_top.txt"), res.stderr
        res = _run_cli(["query", f"{tmp}/mydb",
                        f"{tmp}/reads_1.fa", f"{tmp}/reads_2.fa",
                        "-pairfiles", "-lowest", "species",
                        "-query-limit", "25000", "-tophits", "-queryids",
                        "-out", f"{tmp}/my_top.txt"])
        assert res.returncode == 0, res.stderr
        assert _mapping_lines(f"{tmp}/ref_top.txt") == \
            _mapping_lines(f"{tmp}/my_top.txt")

    def test_full_file_parity(self, golden):
        """FULL output-file parity including all comment lines (the
        query-parameters echo block, printing.cpp:40-115; the input-file
        announcement, classification.cpp:736-738): every line must be
        byte-identical except the run-dependent time/speed lines.

        The input-file announcement echoes the paths as given on the
        command line, so both runs use identical absolute paths."""
        tmp = golden["tmp"]
        if not os.path.exists(f"{tmp}/mydb_0.npz"):
            _run_cli(["build", f"{tmp}/mydb", golden["fasta"],
                      "-taxonomy", golden["tax"]])
        res = _run_cli(["query", f"{tmp}/mydb",
                        f"{tmp}/reads_1.fa", f"{tmp}/reads_2.fa",
                        "-pairfiles", "-lowest", "species",
                        "-query-limit", "25000",
                        "-out", f"{tmp}/my_full.txt"])
        assert res.returncode == 0, res.stderr

        def lines(path):
            with open(path) as f:
                return [l for l in f
                        if not l.startswith(("# time:", "# speed:"))]

        assert lines(f"{tmp}/ref_out.txt") == lines(f"{tmp}/my_full.txt")

    def test_reference_merge_accepts_our_results(self, golden):
        """The reference's merge mode parses our result files (it requires
        the '# Classification will be constrained...' echo and a
        TABLE_LAYOUT with query_id + top_hits columns,
        mode_merge.cpp:131-200) and reproduces the classifications."""
        tmp = golden["tmp"]
        if not os.path.exists(f"{tmp}/mydb_0.npz"):
            _run_cli(["build", f"{tmp}/mydb", golden["fasta"],
                      "-taxonomy", golden["tax"]])
        res = _run_cli(["query", f"{tmp}/mydb",
                        f"{tmp}/reads_1.fa", f"{tmp}/reads_2.fa",
                        "-pairfiles", "-tophits", "-queryids",
                        "-lowest", "species",
                        "-out", f"{tmp}/mergein1.txt"])
        assert res.returncode == 0, res.stderr
        shutil.copy(f"{tmp}/mergein1.txt", f"{tmp}/mergein2.txt")
        res = run([STUB_BIN, "merge", f"{tmp}/mergein1.txt",
                   f"{tmp}/mergein2.txt", "-taxonomy", golden["tax"],
                   "-out", f"{tmp}/refmerged.txt"],
                  env=dict(os.environ, MC_STUB_RANK="0", MC_STUB_SIZE="1"))
        assert os.path.exists(f"{tmp}/refmerged.txt"), res.stderr

        def classifications(path):
            out = {}
            for line in _mapping_lines(path):
                parts = [p.strip() for p in line.split("|")]
                # our lines: query_id | header | top_hits | taxon;
                # merged lines: header | taxon
                out[parts[1] if len(parts) > 2 else parts[0]] = parts[-1]
            return out

        ours = classifications(f"{tmp}/mergein1.txt")
        merged = classifications(f"{tmp}/refmerged.txt")
        assert len(merged) > 0
        # every read the merge kept must agree with our classification
        agree = sum(1 for k, v in merged.items() if ours.get(k) == v)
        assert agree == len(merged)
