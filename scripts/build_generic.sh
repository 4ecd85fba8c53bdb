#!/usr/bin/env bash
# Distributed database build, one process per host.
#
# Counterpart of the reference's SLURM build harness
# (script/ft/BuildGeneric_FT.sh + Run_Build_*_{8,16,32,64}.sh): instead of
# `srun -n P metacache_mpi build`, every process runs the same command with
# MC_COORDINATOR/MC_NUM_PROCS/MC_PROC_ID set (or under a cluster manager
# jax.distributed detects); targets are round-robin sharded by
# `t % num_processes` exactly like sketch_database::add_target_distributed
# (sketch_database.h:519-563), and each process writes its own shard file
# <db>_<proc>.
#
# USE: build_generic.sh <dataset-name> <genomes-dir> <taxonomy-dir> [db-dir]
set -euo pipefail

DATASET="${1:?dataset name (e.g. AFS20)}"
GENOMES="${2:?directory with reference genome FASTA files}"
TAXONOMY="${3:?directory with NCBI nodes.dmp/names.dmp/merged.dmp}"
DBDIR="${4:-./databases}"

mkdir -p "$DBDIR"

exec python -m metacache_tpu.cli build \
    "$DBDIR/DB_${DATASET}.db" "$GENOMES" \
    -taxonomy "$TAXONOMY" \
    -remove-overpopulated-features \
    "${@:5}"
