"""Device stages on a CUDA GPU at real widths, each against a plain numpy
reference (the stage checks of chip_smoke.py phase d). Exact: every stage
is integer work or f32 dots at Precision.HIGHEST."""
import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


def test_onehot_maps_exact(gpu_device):
    chip_smoke.check_onehot_maps(rows=16384, t1=2048)


def test_sketch_stage_matches_numpy(gpu_device):
    chip_smoke.check_sketch(batch=16384, qlen=104)


def test_lookup_matches_numpy_csr(gpu_device):
    rec = chip_smoke.check_lookup_synthetic(batch=16384, n_keys=4_000_000)
    assert rec["overflow_reads"] > 0     # the heavy tail truncates some
