#!/usr/bin/env python
"""Smoke run of metacache-tpu on one CUDA GPU, at config-3 scale.

    python chip_smoke.py                  # phases a-e on one GPU
    python chip_smoke.py --four-cards     # sharded query over 4 GPUs only
    python chip_smoke.py --bases 10       # cut the world to 10 x 4 genomes
    python chip_smoke.py --trace DIR      # + profiler trace of the query and
                                          #   its device time by named scope

Phases (any failure exits non-zero and prints no "ok" line):
  a. device  JAX's first device must be a GPU; there is no CPU fallback.
  b. native  the mcio reader library builds from source and loads.
  c. end to end  generate the config-3 world (BASELINE.json config 3:
             200 genomes of 25 Mbp, 131200 read pairs), `metacache build`
             and `metacache query` through the CLI on the GPU, then the
             same CLI query of the first 8192 pairs on the CPU in a child
             process; every mapping line (read, taxon, rank) must agree.
  d. stages  on the card at real widths, each against a plain numpy
             reference: the one-hot table maps, the sketch stage, and the
             lookup on the built config-3 table. All exact.
  e. tests   `pytest -m gpu` on the card.

--four-cards builds the same world in 4 shards and compares `query -mesh`
over four GPUs with the single-card fused query of the same reads.

One process holds a card at a time: this process never starts a JAX
backend; every phase that uses a device runs in a child, one after the
other. The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from metacache_tpu.config import FEATURE_SENTINEL  # noqa: E402
from metacache_tpu.utils.compile_cache import compile_cache_dir  # noqa: E402
from tests.util_worlds import C3_GLEN  # noqa: E402

#: query flags shared by every run and its reference
QUERY_FLAGS = ["-pairfiles", "-lowest", "species", "-max-query-len", "104"]
#: match-list width of the single-card smoke (the bench's config-3 cell)
LMAX = 256
#: a width no read can exceed (32 features x 254 locations): sharded and
#: fused runs truncate match lists per shard and per union respectively,
#: so only an untruncated width makes them comparable read by read
LMAX_EXACT = 8192
BATCH = 16384
SMOKE_PAIRS = 131_200      # 656 pairs per genome, >= 8 batches of 16384
REF_PAIRS = 8192
RESULT = "RESULT "
RERUN_RE = re.compile(r"reads re-run at full width: (\d+)")
_BACKEND_COMPILE = "/jax/core/compile/backend_compile_duration"
#: the jitted batch program (query/engine.py _query_batch_device)
QUERY_MODULE = "jit__query_batch_device"
#: named scopes whose device time --trace reports
STAGES = ("sketch",)
_HLO_LINE = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"')
_HLO_FILE = re.compile(r"module_(\d+)\.")


class PhaseError(RuntimeError):
    """A phase found a fault; main() exits non-zero."""


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------------------
# children
# --------------------------------------------------------------------------
def child_env(platform, **extra) -> dict:
    """Environment for a child process. platform None keeps JAX's own
    choice; "cpu" or "gpu" pins the backend."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if platform is not None:
        env["JAX_PLATFORMS"] = {"gpu": "cuda"}.get(platform, platform)
    env.update(extra)
    return env


def run_child(argv, env, *, what: str, timeout: float = 1800):
    """Run one child to its end; returns (stdout, stderr, seconds)."""
    t0 = time.time()
    try:
        r = subprocess.run(argv, env=env, cwd=REPO, capture_output=True,
                           text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        raise PhaseError(f"{what}: timed out after {e.timeout:.0f} s")
    wall = time.time() - t0
    if r.returncode != 0:
        raise PhaseError(f"{what}: exit code {r.returncode}\n"
                         f"--- stdout ---\n{r.stdout[-4000:]}\n"
                         f"--- stderr ---\n{r.stderr[-8000:]}")
    return r.stdout, r.stderr, wall


def worker(argv, platform, *, what: str, timeout: float = 1800, **extra):
    """Run `chip_smoke.py --worker ...` and return its RESULT record."""
    out, err, wall = run_child(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--worker"]
        + argv, child_env(platform, **extra), what=what, timeout=timeout)
    recs = [json.loads(l[len(RESULT):]) for l in out.splitlines()
            if l.startswith(RESULT)]
    if not recs:
        raise PhaseError(f"{what}: no result\n{out[-2000:]}\n{err[-4000:]}")
    rec = recs[-1]
    rec["wall_s"] = wall
    rec["stderr"] = err
    return rec


def cli(args, platform, *, what: str, timeout: float = 1800):
    """`python -m metacache_tpu.cli <args>` in a child process."""
    return run_child([sys.executable, "-m", "metacache_tpu.cli"] + args,
                     child_env(platform), what=what, timeout=timeout)


# --------------------------------------------------------------------------
# stage checks (run inside a worker, on whatever backend it has)
# --------------------------------------------------------------------------
class CompileClock:
    """Sums XLA backend compile seconds while installed."""

    def __init__(self):
        import jax.monitoring
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **kwargs):
        if event == _BACKEND_COMPILE:
            self.seconds += duration


def _timed(fn, *args):
    """(result, compile seconds, run seconds) of jitted fn(*args)."""
    import jax
    t0 = time.time()
    compiled = jax.jit(fn).lower(*args).compile()
    t1 = time.time()
    out = jax.block_until_ready(compiled(*args))
    return out, t1 - t0, time.time() - t1


def check_onehot_maps(rows: int = 16384, t1: int = 2048, width: int = 128,
                      seed: int = 0) -> dict:
    """_onehot_map over a [rows/16, width] index block and _lineage_rows
    over [rows], both against numpy indexing, on tables of t1 entries up
    to 2^26 - 1 (the largest the 13-bit split allows)."""
    import jax.numpy as jnp
    from metacache_tpu.ops.candidates import _onehot_map
    from metacache_tpu.ops.classify_op import _lineage_rows
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 1 << 26, t1).astype(np.int32)
    values[:3] = [(1 << 26) - 1, (1 << 13) + 1, (1 << 11) + 1]
    idx = rng.integers(0, t1, (max(1, rows // 16), width)).astype(np.int32)
    got, c1, r1 = _timed(_onehot_map, jnp.asarray(values), jnp.asarray(idx))
    if not np.array_equal(np.asarray(got), values[idx]):
        raise PhaseError("_onehot_map differs from numpy indexing")
    lineage = rng.integers(0, 1 << 26, (t1, 16)).astype(np.int32)
    lineage[0] = 0
    lineage[1, 5] = (1 << 26) - 1
    tax = rng.integers(0, t1, rows).astype(np.int32)
    got, c2, r2 = _timed(_lineage_rows, jnp.asarray(lineage),
                         jnp.asarray(tax))
    if not np.array_equal(np.asarray(got), lineage[tax]):
        raise PhaseError("_lineage_rows differs from numpy indexing")
    return {"compile_s": c1 + c2, "run_s": r1 + r2}


def _random_pairs(rng, batch: int, qlen: int):
    """[batch, qlen] code blocks of two mates, lengths 0..qlen, ~1% N."""
    out = []
    for _ in range(2):
        codes = rng.integers(0, 4, (batch, qlen)).astype(np.uint8)
        codes[rng.random((batch, qlen)) < 0.01] = 255
        lens = rng.integers(0, qlen + 1, batch).astype(np.int32)
        lens[: batch // 2] = min(100, qlen)
        codes[np.arange(qlen)[None, :] >= lens[:, None]] = 255
        out.append((codes, lens))
    return out


def oracle_features(mates, starts, k: int, sketch_size: int, window: int):
    """Numpy features in compute_features' layout: mate 1's windows, then
    mate 2's, each sketch_size wide."""
    from tests.util_oracles import oracle_sketch_batch
    feats = []
    for codes, lens in mates:
        for s in starts:
            w = codes[:, s:s + window]
            if w.shape[1] < window:
                w = np.concatenate([w, np.full(
                    (w.shape[0], window - w.shape[1]), 255, np.uint8)], 1)
            wlen = np.clip(lens - s, 0, window)
            feats.append(oracle_sketch_batch(w, wlen, k, sketch_size))
    return np.concatenate(feats, axis=1)


def check_sketch(batch: int = 16384, qlen: int = 104, seed: int = 1) -> dict:
    """The query sketch stage (engine.compute_features, from the packed
    wire layout) against the numpy sketch oracle."""
    import functools
    import jax.numpy as jnp
    from metacache_tpu.config import SketchParams
    from metacache_tpu.ops import encode
    from metacache_tpu.query.engine import (_window_starts_static,
                                            compute_features)
    p = SketchParams()
    starts = tuple(_window_starts_static(qlen, p.window_size,
                                         p.window_stride))
    mates = _random_pairs(np.random.default_rng(seed), batch, qlen)
    args = []
    for codes, lens in mates:
        pk, am = encode.np_pack_codes(codes)
        args += [jnp.asarray(pk), jnp.asarray(am), jnp.asarray(lens)]
    fn = functools.partial(compute_features, k=p.kmer_size,
                           sketch_size=p.sketch_size,
                           window_size=p.window_size, starts=starts)
    got, c, r = _timed(fn, *args)
    want = oracle_features(mates, starts, p.kmer_size, p.sketch_size,
                           p.window_size)
    bad = int((np.asarray(got) != want).any(axis=1).sum())
    if bad:
        raise PhaseError(f"sketch stage: {bad} of {batch} reads differ "
                         f"from the numpy oracle")
    return {"compile_s": c, "run_s": r}


def np_lookup(features, keys, offsets, loc_packed, lmax: int):
    """Plain CSR lookup: per read, the packed locations of every found
    feature in feature order, the first lmax kept, sorted ascending.
    Returns (packed [B, lmax] padded with 2^31-1, total, overflow)."""
    B, NF = features.shape
    f = features.ravel()
    idx = np.minimum(np.searchsorted(keys, f), len(keys) - 1)
    found = (keys[idx] == f) & (f != FEATURE_SENTINEL)
    off = np.asarray(offsets, np.int64)
    start = np.where(found, off[idx], 0)
    cnt = np.where(found, off[idx + 1] - off[idx], 0)
    total_all = cnt.reshape(B, NF).sum(axis=1)
    first = np.repeat(np.cumsum(cnt) - cnt, cnt)
    li = np.repeat(start, cnt) + (np.arange(first.size) - first)
    row = np.repeat(np.arange(B), total_all)
    pos = np.arange(row.size) - np.repeat(np.cumsum(total_all) - total_all,
                                          total_all)
    keep = pos < lmax
    vals = np.asarray(loc_packed[li[keep]], np.int32)
    row = row[keep]
    order = np.lexsort((vals, row))
    vals, row = vals[order], row[order]
    kept = np.minimum(total_all, lmax)
    col = np.arange(row.size) - np.repeat(np.cumsum(kept) - kept, kept)
    out = np.full((B, lmax), 2**31 - 1, np.int32)
    out[row, col] = vals
    return out, kept, np.maximum(total_all - lmax, 0)


def check_lookup(features, keys, offsets, loc_packed, win_bits: int,
                 lmax: int = 256) -> dict:
    """ops.lookup.lookup_matches (radix-indexed search, CSR expansion,
    packed single-key sort, as the engine runs it) against np_lookup."""
    import functools
    import jax.numpy as jnp
    from metacache_tpu.config import TARGET_SENTINEL
    from metacache_tpu.ops import lookup
    bucket_offsets, steps = lookup.build_radix_index(keys)
    fn = functools.partial(lookup.lookup_matches, lmax=lmax,
                           search_steps=steps, win_bits=win_bits)

    def run(feats, k, o, lp, bo):
        return fn(feats, k, o, None, None, bucket_offsets=bo, loc_packed=lp)

    (tgt, win, total, overflow), c, r = _timed(
        run, jnp.asarray(features), jnp.asarray(keys), jnp.asarray(offsets),
        jnp.asarray(loc_packed), jnp.asarray(bucket_offsets))
    tgt, win = np.asarray(tgt), np.asarray(win)
    got = np.where(tgt == TARGET_SENTINEL, np.int32(2**31 - 1),
                   (tgt << win_bits) | win)
    want, w_total, w_overflow = np_lookup(features, keys, offsets,
                                          loc_packed, lmax)
    bad = ((got != want).any(axis=1) | (np.asarray(total) != w_total)
           | (np.asarray(overflow) != w_overflow))
    if bad.any():
        raise PhaseError(f"lookup: {int(bad.sum())} of {len(bad)} reads "
                         f"differ from the numpy CSR lookup")
    return {"compile_s": c, "run_s": r,
            "matches": int(w_total.sum()),
            "overflow_reads": int((w_overflow > 0).sum())}


def synthetic_table(n_keys: int, seed: int = 2):
    """Sorted unique keys, CSR offsets with a heavy tail (some buckets at
    the 254 cap), and packed (tgt << 20 | win) locations."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 2**32 - 1, int(n_keys * 1.01),
                                  dtype=np.uint64).astype(np.uint32))
    keys = keys[:n_keys]
    cnt = rng.integers(1, 5, keys.size)
    cnt[rng.random(keys.size) < 0.002] = 254
    offsets = np.zeros(keys.size + 1, np.int64)
    np.cumsum(cnt, out=offsets[1:])
    tgt = rng.integers(0, 200, offsets[-1]).astype(np.int32)
    win = rng.integers(0, 1 << 20, offsets[-1]).astype(np.int32)
    return keys, offsets.astype(np.int32), (tgt << 20) | win, 20


def check_lookup_synthetic(batch: int = 16384, nf: int = 32,
                           n_keys: int = 4_000_000, seed: int = 3) -> dict:
    """check_lookup on a synthetic table; 3/4 of the features exist."""
    keys, offsets, packed, wb = synthetic_table(n_keys)
    rng = np.random.default_rng(seed)
    feats = keys[rng.integers(0, keys.size, (batch, nf))]
    miss = rng.random((batch, nf)) < 0.25
    feats[miss] = rng.integers(0, 2**32 - 1, int(miss.sum()),
                               dtype=np.uint64).astype(np.uint32)
    feats[:, -2:] = FEATURE_SENTINEL
    return check_lookup(feats, keys, offsets, packed, wb)


def read_batch_codes(reads_1: str, reads_2: str, batch: int, qlen: int):
    """The first `batch` pairs of two FASTA files as code blocks."""
    from metacache_tpu.io import sequence_io
    from metacache_tpu.query.engine import encode_read_into
    mates = [(np.zeros((batch, qlen), np.uint8), np.zeros(batch, np.int32))
             for _ in range(2)]
    n = 0
    for r1, r2 in sequence_io.read_sequence_pairs(reads_1, reads_2, "files"):
        for (codes, lens), r in zip(mates, (r1, r2)):
            encode_read_into(codes, lens, n, r.data, qlen)
        n += 1
        if n == batch:
            break
    return mates


def check_lookup_on_db(dbname: str, reads_1: str, reads_2: str,
                       batch: int = BATCH, qlen: int = 104,
                       lmax: int = 256) -> dict:
    """check_lookup on a built database and the first batch of its reads
    (features from the numpy sketch oracle)."""
    from metacache_tpu.modes.query import load_all_shards
    from metacache_tpu.query.engine import _window_starts_static
    db = load_all_shards(dbname)
    p = db.query_sketch_params
    starts = tuple(_window_starts_static(qlen, p.window_size,
                                         p.window_stride))
    mates = read_batch_codes(reads_1, reads_2, batch, qlen)
    feats = oracle_features(mates, starts, p.kmer_size, p.sketch_size,
                            p.window_size)
    keys, offsets, _, _ = db.features.device_arrays()
    packed, win_bits = db.features.packed_locations()
    if packed is None:
        raise PhaseError("database locations do not pack into 31 bits")
    out = check_lookup(feats, keys, offsets, packed, win_bits, lmax)
    out["features"] = int(db.features.num_keys)
    out["locations"] = int(db.features.num_locations)
    return out


# --------------------------------------------------------------------------
# trace reduction: device time of the batch program by named scope
# --------------------------------------------------------------------------
def hlo_op_names(hlo_text: str) -> dict:
    """Instruction name -> op_name metadata in an optimized HLO dump."""
    out = {}
    for line in hlo_text.splitlines():
        m = _HLO_LINE.match(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def stage_device_times(kernels, op_names_by_program, stages=STAGES) -> dict:
    """Sum kernel durations by named scope.

    kernels: (program_id, hlo_op, launch_id, duration_ns) of the batch
    program's device events. op_names_by_program: program_id ->
    hlo_op_names() of that program's dump. A kernel counts for the first
    stage s whose "/s/" is in its op_name, else for "other"; kernels with
    no dumped instruction count as "unmapped"."""
    out = {f"{s}_ns": 0 for s in stages}
    out.update(other_ns=0, unmapped_ns=0, total_ns=0)
    launches = set()
    for program, op, launch, dur in kernels:
        names = op_names_by_program.get(program, {})
        # a kernel of instruction "sort.12" is reported as "sort.12.0"
        op_name = names.get(op, names.get(op.rsplit(".", 1)[0]))
        if op_name is None:
            key = "unmapped_ns"
        else:
            key = next((f"{s}_ns" for s in stages if f"/{s}/" in op_name),
                       "other_ns")
        out[key] += dur
        out["total_ns"] += dur
        launches.add((program, launch))
    out["launches"] = len(launches)
    return out


def trace_stage_times(trace_dir: str, hlo_dir: str,
                      module: str = QUERY_MODULE) -> dict:
    """stage_device_times over a jax.profiler trace and the XLA dump
    (--xla_dump_to) of the same run."""
    import glob
    from jax.profiler import ProfileData
    by_program = {}
    for path in glob.glob(os.path.join(hlo_dir, f"*{module}*"
                                       "after_optimizations.txt")):
        m = _HLO_FILE.search(os.path.basename(path))
        if m:
            with open(path) as f:
                by_program[int(m.group(1))] = hlo_op_names(f.read())
    kernels = []
    for path in glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                          recursive=True):
        for plane in ProfileData.from_file(path).planes:
            if not plane.name.startswith("/device:"):
                continue
            for line in plane.lines:
                for e in line.events:
                    st = dict(e.stats)
                    if str(st.get("hlo_module", "")) != module:
                        continue
                    kernels.append((int(st.get("program_id", -1)),
                                    str(st.get("hlo_op", e.name)),
                                    st.get("correlation_id"),
                                    int(e.duration_ns)))
    return stage_device_times(kernels, by_program)


# --------------------------------------------------------------------------
# worker entry points (child processes)
# --------------------------------------------------------------------------
def device_record() -> dict:
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def emit(rec: dict):
    print(RESULT + json.dumps(rec), flush=True)


def worker_main(argv) -> int:
    ap = argparse.ArgumentParser(prog="chip_smoke.py --worker")
    ap.add_argument("task", choices=["device", "stages", "query"])
    ap.add_argument("--expect", default="gpu")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--db")
    ap.add_argument("--reads", nargs=2)
    ap.add_argument("--lookup-batch", type=int, default=0)
    ap.add_argument("--trace", help="jax.profiler trace of the query here")
    ap.add_argument("--hlo-dump", help="where XLA_FLAGS dumps the HLO")
    # CLI query arguments follow "--"
    cut = argv.index("--") if "--" in argv else len(argv)
    a = ap.parse_args(argv[:cut])
    cli_args = argv[cut + 1:]
    from metacache_tpu.utils.compile_cache import configure_compile_cache
    configure_compile_cache()
    dev = device_record()
    if dev["platform"] != a.expect:
        emit({"device": dev, "error": f"no {a.expect.upper()} found: JAX's "
              f"first device is {dev['platform']} ({dev['kind']})"})
        return 0
    rec = {"device": dev}
    if a.task == "device":
        pass
    elif a.task == "stages":
        rec["onehot"] = check_onehot_maps(rows=a.batch)
        rec["sketch"] = check_sketch(batch=a.batch)
    else:
        clock = CompileClock()
        from metacache_tpu import cli
        t0 = time.time()
        if a.trace:
            import jax
            with jax.profiler.trace(a.trace):
                rc = cli.main(["query"] + cli_args)
            rec["stages"] = trace_stage_times(a.trace, a.hlo_dump)
        else:
            rc = cli.main(["query"] + cli_args)
        rec["query"] = {"rc": rc, "wall_s": time.time() - t0,
                        "compile_s": clock.seconds,
                        "peak_bytes_in_use": peak_bytes()}
        if rc == 0 and a.lookup_batch:
            import gc
            gc.collect()    # release the query's device tables first
            rec["lookup"] = check_lookup_on_db(a.db, *a.reads,
                                               batch=a.lookup_batch,
                                               lmax=LMAX)
    emit(rec)
    return 0


# --------------------------------------------------------------------------
# phases (this process: no JAX backend)
# --------------------------------------------------------------------------
def phase_device(platform, expect: str, batch: int = 0) -> dict:
    """a, and with batch > 0 the first half of d: the device check, then
    the one-hot maps and the sketch stage at that batch width."""
    task = ["stages", "--batch", str(batch)] if batch else ["device"]
    rec = worker(task + ["--expect", expect], platform,
                 what="stage checks" if batch else "device check",
                 timeout=900)
    if "error" in rec:
        raise PhaseError(rec["error"])
    return rec


def phase_native() -> str:
    from metacache_tpu import native
    if native.load_mcio() is None:
        raise PhaseError("native mcio library did not build or load")
    return native.library_path()


def mapping_lines(path: str):
    with open(path) as f:
        return [l for l in f if not l.startswith("#")]


def classified_fraction(lines) -> float:
    from metacache_tpu.query.output import OutputOptions
    fmt = OutputOptions().format
    unclassified = f"{fmt.column}{fmt.none}\n"
    n = sum(1 for l in lines if not l.endswith(unclassified))
    return n / max(1, len(lines))


def query_on_device(work, dbname, world, platform, expect, *, batch, lmax,
                    extra=(), lookup_batch=0, visible=None, tag="device",
                    trace=None):
    """CLI query of every pair in a worker; returns its record + lines.
    With trace=DIR the worker also writes a profiler trace there and
    reports the batch program's device time by named scope."""
    out = os.path.join(work, f"out_{tag}.txt")
    hlo = os.path.join(work, "hlo")
    args = ["query", "--expect", expect, "--db", dbname,
            "--reads", world["reads_1"], world["reads_2"],
            "--lookup-batch", str(lookup_batch),
            *(["--trace", trace, "--hlo-dump", hlo] if trace else []), "--",
            dbname, world["reads_1"], world["reads_2"], *QUERY_FLAGS,
            "-max-locations-per-query", str(lmax), "-batch-size", str(batch),
            *extra, "-out", out]
    env = {} if visible is None else {"CUDA_VISIBLE_DEVICES": visible}
    if trace:
        env["XLA_FLAGS"] = " ".join(
            [os.environ.get("XLA_FLAGS", ""), f"--xla_dump_to={hlo}",
             f"--xla_dump_hlo_module_re=.*{QUERY_MODULE}.*"]).strip()
    rec = worker(args, platform, what=f"{tag} query", **env)
    if "error" in rec:
        raise PhaseError(rec["error"])
    if rec["query"]["rc"] != 0:
        raise PhaseError(f"{tag} query: exit code {rec['query']['rc']}\n"
                         f"{rec['stderr'][-4000:]}")
    m = RERUN_RE.findall(rec["stderr"])
    rec["reruns"] = int(m[-1]) if m else None
    return rec, mapping_lines(out)


def compare_lines(got, want, what: str) -> None:
    if len(got) != len(want):
        raise PhaseError(f"{what}: {len(got)} vs {len(want)} mapping lines")
    diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if diff:
        i = diff[0]
        raise PhaseError(f"{what}: {len(diff)} reads differ; first at "
                         f"line {i}: {got[i]!r} vs {want[i]!r}")


def make_world(work, bases, genome_len, pairs):
    from tests.util_worlds import make_config3_world
    t0 = time.time()
    world = make_config3_world(os.path.join(work, "world"), bases=bases,
                               genome_len=genome_len, pairs=pairs)
    log(f"world: {world['bases'] / 1e9:.3f} Gbp in {bases * 4} genomes, "
        f"{world['pairs']} pairs, generated in {time.time() - t0:.1f} s")
    return world


def phase_end_to_end(work, platform, expect, *, bases,
                     genome_len=C3_GLEN, pairs=SMOKE_PAIRS, batch=BATCH,
                     ref_pairs=REF_PAIRS, lookup_batch=BATCH, trace=None):
    """c + the lookup half of d: world, CLI build, CLI query on the
    device, CLI query of the first ref_pairs on the CPU, compare."""
    world = make_world(work, bases, genome_len, pairs)
    dbname = os.path.join(work, "c3db")
    _, _, build_s = cli(["build", dbname, world["genomes"], "-taxonomy",
                         world["tax"]], platform, what="CLI build")
    log(f"CLI build: {build_s:.1f} s wall "
        f"({world['bases'] / 1e9 / build_s:.4f} Gbp/s)")
    rec, lines = query_on_device(work, dbname, world, platform, expect,
                                 batch=batch, lmax=LMAX,
                                 lookup_batch=lookup_batch, trace=trace)
    q = rec["query"]
    if len(lines) != world["pairs"]:
        raise PhaseError(f"device query wrote {len(lines)} mapping lines "
                         f"for {world['pairs']} pairs")
    log(f"CLI query on {rec['device']['kind']}: {len(lines)} pairs, "
        f"{q['wall_s']:.1f} s wall in-process "
        f"({rec['wall_s']:.1f} s with start-up), compile "
        f"{q['compile_s']:.1f} s, peak_bytes_in_use {q['peak_bytes_in_use']}")
    log(f"classified fraction: {classified_fraction(lines):.6f}; "
        f"reads re-run at full width: {rec['reruns']}")
    if "stages" in rec:
        st = rec["stages"]
        log(f"device time of {QUERY_MODULE} over {st['launches']} launches: "
            f"{st['total_ns'] / 1e6:.3f} ms; sketch "
            f"{st['sketch_ns'] / 1e6:.3f} ms "
            f"({st['sketch_ns'] / max(1, st['total_ns']):.4f}), other "
            f"{st['other_ns'] / 1e6:.3f} ms, unmapped "
            f"{st['unmapped_ns'] / 1e6:.3f} ms")
    if "lookup" in rec:
        lk = rec["lookup"]
        log(f"stage lookup_matches == numpy CSR on the built table "
            f"({lk['features']} features, {lk['locations']} locations, "
            f"{lookup_batch} pairs, {lk['matches']} matches): compile "
            f"{lk['compile_s']:.1f} s, run {lk['run_s']:.3f} s")
    ref_out = os.path.join(work, "out_cpu.txt")
    _, _, ref_s = cli(["query", dbname, world["reads_1"], world["reads_2"],
                       *QUERY_FLAGS, "-max-locations-per-query", str(LMAX),
                       "-batch-size", str(batch),
                       "-query-limit", str(ref_pairs), "-out", ref_out],
                      "cpu", what="CPU reference query")
    compare_lines(lines[:ref_pairs], mapping_lines(ref_out),
                  "device vs CPU reference")
    log(f"CPU reference: first {ref_pairs} pairs, 0 differing reads "
        f"({ref_s:.1f} s wall)")
    return rec


def phase_four_cards(work, platform, expect, *, bases, genome_len=C3_GLEN,
                     pairs=SMOKE_PAIRS, batch=BATCH):
    """4-shard build; `query -mesh` over the 4 devices vs the fused query
    on one of them (CUDA_VISIBLE_DEVICES=0); per-read equality."""
    world = make_world(work, bases, genome_len, pairs)
    dbname = os.path.join(work, "c3db4")
    _, _, build_s = cli(["build", dbname, world["genomes"], "-taxonomy",
                         world["tax"], "-num-shards", "4"], platform,
                        what="CLI 4-shard build")
    log(f"CLI 4-shard build: {build_s:.1f} s wall")
    one, one_lines = query_on_device(work, dbname, world, platform, expect,
                                     batch=batch, lmax=LMAX_EXACT,
                                     visible="0", tag="fused")
    log(f"fused query on 1 card: {one['query']['wall_s']:.1f} s, compile "
        f"{one['query']['compile_s']:.1f} s")
    mesh, mesh_lines = query_on_device(work, dbname, world, platform,
                                       expect, batch=batch, lmax=LMAX_EXACT,
                                       extra=["-mesh"], tag="mesh")
    if mesh["device"]["count"] != 4:
        raise PhaseError(f"-mesh ran on {mesh['device']['count']} devices")
    if len(one_lines) != world["pairs"]:
        raise PhaseError(f"fused query wrote {len(one_lines)} lines")
    compare_lines(mesh_lines, one_lines, "mesh vs fused")
    log(f"query -mesh on 4 x {mesh['device']['kind']}: {len(mesh_lines)} "
        f"pairs, {mesh['query']['wall_s']:.1f} s, compile "
        f"{mesh['query']['compile_s']:.1f} s; 0 reads differ from the "
        f"fused single-card query")
    return mesh


def phase_gpu_tests():
    out, _, wall = run_child(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-q", "-rs",
         "-p", "no:cacheprovider", os.path.join(REPO, "tests")],
        child_env("gpu"), what="pytest -m gpu", timeout=900)
    summary = out.strip().splitlines()[-1] if out.strip() else ""
    if "passed" not in summary or "skipped" in summary \
            or "failed" in summary or "error" in summary:
        raise PhaseError(f"pytest -m gpu: {summary}\n{out[-3000:]}")
    log(f"pytest -m gpu: {summary} ({wall:.1f} s wall)")


def card_name_and_power() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        raise PhaseError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="only the sharded query over 4 GPUs vs 1 GPU")
    ap.add_argument("--trace", metavar="DIR",
                    help="write a jax.profiler trace of the GPU query")
    ap.add_argument("--bases", type=int, default=50,
                    help="base genomes (x4 strains of 25 Mbp; default 50 "
                         "= 5 Gbp, the full config-3 world)")
    a = ap.parse_args(argv)
    work = os.path.join(REPO, ".chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    import jax
    log(f"jax {jax.__version__}; compile cache {compile_cache_dir()}")
    try:
        t0 = time.time()
        rec = phase_device(None, "gpu", 0 if a.four_cards else BATCH)
        dev = rec["device"]
        log(f"card: {card_name_and_power()}")
        log(f"device: {dev['platform']} {dev['kind']} x {dev['count']} "
            f"({rec['wall_s']:.1f} s wall)")
        for k in ("onehot", "sketch"):
            if k in rec:
                log(f"stage {k} exact at real widths: compile "
                    f"{rec[k]['compile_s']:.1f} s, run "
                    f"{rec[k]['run_s']:.4f} s")
        log(f"native mcio loaded: {phase_native()}")
        if a.four_cards:
            dev = phase_four_cards(work, None, "gpu",
                                   bases=a.bases)["device"]
        else:
            phase_end_to_end(work, None, "gpu", bases=a.bases,
                             trace=a.trace and os.path.abspath(a.trace))
            phase_gpu_tests()
        log(f"total wall {time.time() - t0:.1f} s")
    except PhaseError as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        sys.exit(worker_main(sys.argv[2:]))
    sys.exit(main())
