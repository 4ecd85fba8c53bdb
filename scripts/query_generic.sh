#!/usr/bin/env bash
# Distributed query with the reference's canonical flags
# (script/ft/QueryGeneric_FT.sh:121):
#   -lowest species -abundance-per species -pairfiles -maxcand 4
#   -hitmin 4 -hitdiff 80 -query-limit 25000
#
# USE: query_generic.sh <db> <forward.fq> <reverse.fq> <out.txt> [query-limit]
set -euo pipefail

DB="${1:?database path (shard files <db>_<proc> must exist)}"
FWD="${2:?forward paired FASTQ}"
REV="${3:?reverse paired FASTQ}"
OUT="${4:?output file}"
QUERY_LIMIT="${5:-25000}"

exec python -m metacache_tpu.cli query "$DB" "$FWD" "$REV" \
    -pairfiles \
    -lowest species \
    -abundance-per species \
    -maxcand 4 -hitmin 4 -hitdiff 80 \
    -query-limit "$QUERY_LIMIT" \
    -out "$OUT" \
    "${@:6}"
