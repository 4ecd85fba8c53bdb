"""metacache_tpu — a metagenomic read classifier on JAX.

A from-scratch JAX/XLA implementation of MetaCache's context-aware
minhashing classification method with MetaCache-MPI's distributed
capabilities mapped onto device meshes. See SURVEY.md at the repo root
for the structural analysis of the reference this is built from.
"""
__version__ = "0.1.0"
