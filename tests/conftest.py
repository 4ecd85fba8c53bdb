"""Test configuration.

Unless JAX_PLATFORMS says otherwise, the suite runs on the CPU backend with
8 virtual devices, so multi-device sharding tests run anywhere (the same
way MPI users test with `mpirun -np N` on one box — SURVEY.md §4). Both
variables are read when the backend starts, so setting them here works.

Tests marked `gpu` need a CUDA device. They take the `gpu_device` fixture,
which skips them on any other backend; run them on a card with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
"""
import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from metacache_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()


@pytest.fixture
def gpu_device():
    """The first JAX device, which must be a CUDA GPU (else skip)."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a CUDA GPU; JAX runs on {dev.platform}")
    return dev
