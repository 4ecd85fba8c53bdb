"""Exactness of the one-hot-matmul table lookups for LARGE values.

The 13-bit value split in ops/candidates._onehot_map and
ops/classify_op._lineage_rows is only exact if the dot runs in full f32:
a GPU may run an f32 dot in TF32 (exact only for integers below 2^11), and
bf16 passes are exact only to 2^8, unless the dot asks for
Precision.HIGHEST. The CPU backend ignores the precision, so besides the
value tests (which also run on a GPU, tests/test_gpu_stages.py) the dots'
precision is checked in the jaxpr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metacache_tpu.ops.candidates import _onehot_map
from metacache_tpu.ops.classify_op import _lineage_rows

RNG = np.random.default_rng(77)


def test_onehot_map_exact_large_values():
    T = 512
    values = RNG.integers(0, 1 << 26, size=T, dtype=np.int64).astype(np.int32)
    # make sure the dangerous range is represented
    values[0] = (1 << 26) - 1
    values[1] = (1 << 13) + 1
    values[2] = 257  # first value bf16 would round
    idx = RNG.integers(0, T, size=(8, 32)).astype(np.int32)
    got = np.asarray(_onehot_map(jnp.asarray(values), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, values[idx])


def test_lineage_rows_exact_large_values():
    N, R = 300, 22
    lineage = RNG.integers(0, 1 << 26, size=(N, R),
                           dtype=np.int64).astype(np.int32)
    lineage[0] = 0
    lineage[5, 3] = (1 << 26) - 1
    tax = RNG.integers(0, N, size=64).astype(np.int32)
    got = np.asarray(_lineage_rows(jnp.asarray(lineage), jnp.asarray(tax)))
    np.testing.assert_array_equal(got, lineage[tax])


@pytest.mark.parametrize("fn,args", [
    pytest.param(_onehot_map, (np.arange(64, dtype=np.int32),
                               np.zeros((4, 8), np.int32)), id="onehot_map"),
    pytest.param(_lineage_rows, (np.zeros((64, 8), np.int32),
                                 np.zeros(16, np.int32)), id="lineage_rows"),
])
def test_onehot_dots_request_highest_precision(fn, args):
    jaxpr = jax.make_jaxpr(fn)(*map(jnp.asarray, args))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 2          # the lo and hi 13-bit chunks
    for e in dots:
        prec = e.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec), prec
