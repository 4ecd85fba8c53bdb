"""Multi-host distribution (parallel/distributed.py): 2-process CPU run
with gloo collectives, mirroring how MPI users test with `mpirun -np 2` on
one box (SURVEY.md §4 "Distributed without a cluster").

Each process owns one database shard and serves it from its device; reads
are replicated; candidates merge over the global mesh; process 0 writes
output. Classifications must equal the single-process fused run
(shard-count invariance, sketch_database.h:540 round-robin gate +
querying.h:892-1071 merge semantics)."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from tests import util_mockdata as mock


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist"))
    fasta, nodes, names, merged, genomes, taxids = mock.make_mock_world(
        tmp, num_genomes=6, genome_len=3000, seed=21)
    rng = np.random.default_rng(3)
    reads = []
    for i in range(60):
        g = int(rng.integers(0, 6))
        pos = int(rng.integers(0, 2800))
        reads.append((f"r{i}_NC_{g:06d}.1", genomes[g][pos:pos + 120]))
    readfile = os.path.join(tmp, "reads.fa")
    mock.write_fasta(readfile, reads)
    return {"tmp": tmp, "fasta": fasta, "tax": os.path.join(tmp, "tax"),
            "reads": readfile}


def run_proc(argv, env, timeout=480):
    e = dict(os.environ)
    e["JAX_PLATFORMS"] = "cpu"
    e.update(env)
    e["PYTHONPATH"] = REPO
    return subprocess.Popen([sys.executable, "-m", "metacache_tpu.cli"]
                            + argv, env=e, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def launch_pair(argv_of, tmp):
    port = _free_port()
    procs = []
    for pid in range(2):
        env = {
            "MC_COORDINATOR": f"127.0.0.1:{port}",
            "MC_NUM_PROCS": "2",
            "MC_PROC_ID": str(pid),
            "XLA_FLAGS": "",
        }
        procs.append(run_proc(argv_of(pid), env))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=480)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.skip("distributed processes timed out")
        outs.append((p.returncode, out, err))
    return outs


def test_two_process_build_and_query(world):
    tmp = world["tmp"]
    dbbase = os.path.join(tmp, "distdb")

    # --- distributed build: process r builds + writes shard r ----------
    outs = launch_pair(
        lambda pid: ["build", dbbase, world["fasta"],
                     "-taxonomy", world["tax"]], tmp)
    for rc, out, err in outs:
        if rc != 0 and ("distributed" in err.lower()
                        or "gloo" in err.lower()
                        or "collectives" in err.lower()):
            pytest.skip(f"jax.distributed unavailable: {err[-300:]}")
        assert rc == 0, err[-2000:]
    assert os.path.exists(dbbase + "_0.npz")
    assert os.path.exists(dbbase + "_1.npz")

    # --- single-process fused reference run ----------------------------
    ref_out = os.path.join(tmp, "ref_out.txt")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "metacache_tpu.cli", "query", dbbase,
         world["reads"], "-lowest", "species", "-out", ref_out],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=480)
    assert r.returncode == 0, r.stderr[-2000:]

    # --- 2-process mesh query ------------------------------------------
    outs = launch_pair(
        lambda pid: ["query", dbbase, world["reads"], "-mesh",
                     "-lowest", "species",
                     "-out", os.path.join(tmp, f"mesh_out_{pid}.txt")],
        tmp)
    for rc, out, err in outs:
        assert rc == 0, err[-2000:]
    mesh_lines = [l for l in
                  open(os.path.join(tmp, "mesh_out_0.txt"))
                  if not l.startswith("#")]
    ref_lines = [l for l in open(ref_out) if not l.startswith("#")]
    assert mesh_lines == ref_lines
