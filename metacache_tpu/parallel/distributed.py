"""Multi-host distribution: the reference's MPI launch model on JAX.

Reference mapping (SURVEY.md §2 "Distributed communication backend"):

  mpirun -np P metacache_mpi ...        MC_NUM_PROCS=P MC_PROC_ID=r
    (MPI_Init, main.cpp:48)             MC_COORDINATOR=host:port
                                        metacache ...  (per process), or any
                                        cluster env jax.distributed already
                                        auto-detects (SLURM, GKE, ...)
  rank r builds + owns DB shard r      process r builds shard r and serves
    (mode_build.cpp:1079-1091)          it from its addressable device(s)
  every rank reads the same queries    every process streams the same read
    (querying.h:749-830)                files into replicated batches
  log2(P) candidate tree reduce        all_gather over the global mesh
    (querying.h:892-1071)               (NVLink within a host, the network
                                        across hosts)
  rank 0 writes output                 process 0 writes output

Single-process use is untouched: `maybe_initialize` is a no-op unless the
MC_* variables (or an auto-detected cluster) are present.
"""
from __future__ import annotations

import os
from typing import List, Optional

import jax
import numpy as np


def maybe_initialize() -> tuple:
    """Initialize jax.distributed from MC_* env vars if present.

    MC_COORDINATOR=<host:port>  coordinator address (process 0's)
    MC_NUM_PROCS=<P>            total process count
    MC_PROC_ID=<r>              this process's id
    MC_LOCAL_DEVICE_IDS         comma-separated local device ids; several
                                processes on one host must each name
                                their own card (else every process
                                reserves memory on every visible card)

    Returns (process_index, process_count).
    """
    coord = os.environ.get("MC_COORDINATOR")
    # NOTE: do not touch jax.process_count()/jax.devices() before
    # jax.distributed.initialize — they initialize the XLA backend
    if coord and not getattr(maybe_initialize, "_done", False):
        kwargs = {}
        ids = os.environ.get("MC_LOCAL_DEVICE_IDS")
        if ids:
            kwargs["local_device_ids"] = [int(x) for x in ids.split(",")]
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(os.environ["MC_NUM_PROCS"]),
            process_id=int(os.environ["MC_PROC_ID"]), **kwargs)
        maybe_initialize._done = True
    return jax.process_index(), jax.process_count()


def local_shard_ids(num_shards: int, mesh) -> List[int]:
    """Shard ids whose mesh position lands on this process's devices.

    Shard s lives on mesh.devices.flat[s] — the same fixed assignment the
    reference gets from `t % P == rank` file ownership
    (mode_query.cpp:421-426: rank r opens `<db>_<r>`).
    """
    me = jax.process_index()
    return [i for i, d in enumerate(mesh.devices.flat)
            if d.process_index == me]


def put_sharded(stacked_local: np.ndarray, mesh, axis: str = "shard"):
    """Place a host-stacked [P_local, ...] array as a global [P, ...] array
    sharded one-slice-per-device along `axis`.

    Single-process: plain device_put. Multi-process: each process provides
    only the slices for its own devices (stacked in mesh order) and the
    global array is assembled with make_array_from_single_device_arrays —
    no cross-host transfer happens (the reference's per-rank DB files never
    move either).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P
    spec = P(axis, *([None] * (stacked_local.ndim - 1)))
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(stacked_local, sharding)
    local_devs = [d for d in mesh.devices.flat
                  if d.process_index == jax.process_index()]
    if stacked_local.shape[0] != len(local_devs):
        raise ValueError(
            f"{stacked_local.shape[0]} local shards for "
            f"{len(local_devs)} local devices")
    arrs = [jax.device_put(stacked_local[i:i + 1], d)
            for i, d in enumerate(local_devs)]
    global_shape = (mesh.devices.size,) + stacked_local.shape[1:]
    return jax.make_array_from_single_device_arrays(
        global_shape, sharding, arrs)


def put_replicated(value: np.ndarray, mesh):
    """Replicate a host array (identical on every process) over the mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    sharding = NamedSharding(mesh, P())
    if jax.process_count() == 1:
        return jax.device_put(value, sharding)
    return jax.make_array_from_callback(value.shape, sharding,
                                        lambda idx: value[idx])


def fetch_replicated(arr) -> np.ndarray:
    """Pull a replicated global array to host (any process)."""
    if jax.process_count() == 1:
        return np.asarray(arr)
    shards = arr.addressable_shards
    return np.asarray(shards[0].data)
