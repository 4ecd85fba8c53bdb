"""Command line entry: mode dispatch (src/main.cpp:41-106, modes.h:37-92).

Usage: python -m metacache_tpu.cli <mode> ...
Modes: help, build, modify, query, info, annotate, merge
"""
from __future__ import annotations

import sys

from .utils import ArgsParser
from .utils.compile_cache import configure_compile_cache

MODES = ("help", "build", "modify", "query", "info", "annotate", "merge")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    configure_compile_cache()
    args = ArgsParser(argv)
    # multi-host launch (the reference's MPI_Init, src/main.cpp:48):
    # MC_COORDINATOR/MC_NUM_PROCS/MC_PROC_ID env -> jax.distributed
    from .parallel.distributed import maybe_initialize
    maybe_initialize()
    if not args.positionals:
        print("metacache-tpu — metagenomic read classifier on JAX\n"
              f"available modes: {', '.join(MODES)}\n"
              "usage: metacache <mode> ...", file=sys.stderr)
        return 1
    mode = args.positionals[0]
    if mode == "build":
        from .modes.build import main_mode_build
        return main_mode_build(args)
    if mode == "modify":
        from .modes.modify import main_mode_modify
        return main_mode_modify(args)
    if mode == "query":
        from .modes.query import main_mode_query
        return main_mode_query(args)
    if mode == "info":
        from .modes.info import main_mode_info
        return main_mode_info(args)
    if mode == "annotate":
        from .modes.annotate import main_mode_annotate
        return main_mode_annotate(args)
    if mode == "merge":
        from .modes.merge import main_mode_merge
        return main_mode_merge(args)
    if mode == "help":
        from .modes.help import main_mode_help
        return main_mode_help(args)
    print(f"unknown mode '{mode}'; available: {', '.join(MODES)}",
          file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
