"""CLI -mesh flag: sharded multi-device query equals single-device query,
across the full query-flag surface (clade exclusion, hits-per-seq, tophits,
locations, abundances). The reference guarantees rank-count invariance the
same way: hit counts are summed per target regardless of which shard held
the feature (SURVEY.md §4 'shard-count invariance')."""
import os
import subprocess
import sys

import numpy as np
import pytest

from tests import util_mockdata as mock


def run_cli(args, extra_env=None):
    env = mock.cli_env(XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
                       + " --xla_force_host_platform_device_count=8")
    if extra_env:
        env.update(extra_env)
    return subprocess.run([sys.executable, "-m", "metacache_tpu.cli"] + args,
                          capture_output=True, text=True, cwd=mock.REPO_ROOT,
                          env=env)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("meshworld"))
    fasta, nodes, names, merged, genomes, taxids = mock.make_mock_world(
        tmp, num_genomes=8, genome_len=2000, seed=9)
    rng = np.random.default_rng(3)
    reads = mock.sample_reads(rng, genomes, 100)
    mock.write_fasta(os.path.join(tmp, "r1.fa"),
                     [(h, s) for h, s, _ in reads])
    mock.write_fasta(os.path.join(tmp, "r2.fa"),
                     [(h, s) for h, s, _ in reads])
    r = run_cli(["build", f"{tmp}/db8", fasta, "-taxonomy", f"{tmp}/tax",
                 "-num-shards", "8"])
    assert r.returncode == 0, r.stderr
    return tmp


def _lines(p, *, drop_timing=True):
    """All lines; comment lines kept except the timing/speed ones (the only
    run-dependent output)."""
    out = []
    with open(p) as f:
        for line in f:
            if drop_timing and (line.startswith("# time:")
                                or line.startswith("# speed:")):
                continue
            out.append(line)
    return out


FLAG_SETS = [
    pytest.param([], id="default"),
    pytest.param(["-tophits", "-queryids"], id="tophits"),
    pytest.param(["-allhits", "-locations"], id="allhits-locations"),
    pytest.param(["-hits-per-seq"], id="hits-per-seq"),
    pytest.param(["-abundances", "-abundance-per", "species"],
                 id="abundances"),
    pytest.param(["-maxcand", "4", "-hitmin", "4", "-hitdiff", "80"],
                 id="canonical"),
    pytest.param(["-ground-truth", "-precision", "-exclude", "species"],
                 id="exclude-species"),
]


@pytest.mark.parametrize("flags", FLAG_SETS)
def test_cli_mesh_query_matches_single(world, flags):
    tmp = world
    tag = "_".join(f.strip("-") for f in flags) or "plain"
    base = ["query", f"{tmp}/db8", f"{tmp}/r1.fa", f"{tmp}/r2.fa",
            "-pairfiles", "-lowest", "species"] + flags
    r = run_cli(base + ["-out", f"{tmp}/single_{tag}.txt"])
    assert r.returncode == 0, r.stderr
    r = run_cli(base + ["-mesh", "-out", f"{tmp}/mesh_{tag}.txt"])
    assert r.returncode == 0, r.stderr
    single = _lines(f"{tmp}/single_{tag}.txt")
    mesh = _lines(f"{tmp}/mesh_{tag}.txt")
    assert single == mesh
    n_mapped = sum(1 for l in single if not l.startswith("#"))
    assert n_mapped >= 100  # every read mapped (+ any per-target tables)


def test_cli_mesh_shard_device_mismatch_is_an_error(world):
    tmp = world
    r = run_cli(["query", f"{tmp}/db8", f"{tmp}/r1.fa", f"{tmp}/r2.fa",
                 "-pairfiles", "-mesh", "-out", f"{tmp}/mismatch.txt"],
                extra_env={"XLA_FLAGS":
                           "--xla_force_host_platform_device_count=4"})
    assert r.returncode != 0
    assert "one database shard per device" in r.stderr, r.stderr[-2000:]
    assert not os.path.exists(f"{tmp}/mismatch.txt")
