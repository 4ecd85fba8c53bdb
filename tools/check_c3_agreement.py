#!/usr/bin/env python
"""Per-read classification agreement vs the reference binary at config-3
scale (5 Gbp DB, 1M pairs).

Usage: python tools/check_c3_agreement.py <ref_out> <our_out>
Both files are per-read mapping outputs ("header\t|\trank:name" lines).
Ours is produced by the CLI on the SAME world; the reference's by
metacache_mpi2 (tools/build_reference.sh) on its own 2-rank build of the
same world.

Known, documented divergence sources (SURVEY §4): the 254-per-feature
location cap is applied PER SHARD in both systems, but the shard split
differs (reference ranks vs our shards), so reads touching capped buckets
can resolve differently; ties in equal-hit candidates are unspecified in
the reference (unstable std::sort).
Gate: agreement >= 99.9% on classified reads.
"""
import sys


def load(path):
    m = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t|\t")
            if len(parts) >= 2:
                m[parts[0]] = parts[-1]
    return m


def main():
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    ref = load(sys.argv[1])
    ours = load(sys.argv[2])
    common = set(ref) & set(ours)
    print(f"reference lines: {len(ref)}  ours: {len(ours)}  "
          f"common headers: {len(common)}")
    if not common:
        print("NO COMMON READS — header mismatch?")
        sys.exit(2)
    agree = 0
    diffs = []
    for h in common:
        if ref[h] == ours[h]:
            agree += 1
        elif len(diffs) < 20:
            diffs.append((h, ref[h], ours[h]))
    frac = agree / len(common)
    print(f"agreement: {agree}/{len(common)} = {frac:.6f}")
    for h, r, t in diffs:
        print(f"  DIFF {h}: ref={r!r} ours={t!r}")
    print("PASS" if frac >= 0.999 else "FAIL")
    sys.exit(0 if frac >= 0.999 else 1)


if __name__ == "__main__":
    main()
