"""chip_smoke.py rehearsed on the CPU at a tiny size: the same phase
functions the GPU run uses, with an explicit platform="cpu"; and the
script itself refusing to run without a GPU."""
import os
import subprocess
import sys

import pytest

import chip_smoke
from tests import util_mockdata as mock


def test_refuses_without_gpu():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=mock.REPO_ROOT,
                       env=mock.cli_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr, r.stderr[-2000:]
    assert '"ok"' not in r.stdout


def test_end_to_end_rehearsal(tmp_path, capsys):
    rec = chip_smoke.phase_end_to_end(
        str(tmp_path), "cpu", "cpu", bases=2, genome_len=20_000, pairs=512,
        batch=256, ref_pairs=128, lookup_batch=128,
        trace=str(tmp_path / "trace"))
    assert rec["device"]["platform"] == "cpu"
    assert rec["reruns"] is not None
    assert rec["lookup"]["matches"] > 0
    assert list((tmp_path / "hlo").glob(
        f"*{chip_smoke.QUERY_MODULE}*after_optimizations.txt"))
    # the CPU backend records no device kernels; the GPU run does
    assert rec["stages"]["total_ns"] == 0
    out = capsys.readouterr().out
    assert "0 differing reads" in out
    assert "classified fraction" in out


def test_four_card_rehearsal(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("XLA_FLAGS",
                       "--xla_force_host_platform_device_count=4")
    rec = chip_smoke.phase_four_cards(
        str(tmp_path), "cpu", "cpu", bases=2, genome_len=20_000, pairs=512,
        batch=256)
    assert rec["device"]["count"] == 4
    assert "0 reads differ" in capsys.readouterr().out


@pytest.mark.parametrize("check", [
    pytest.param(lambda: chip_smoke.check_onehot_maps(rows=256, t1=2048),
                 id="onehot"),
    pytest.param(lambda: chip_smoke.check_sketch(batch=256), id="sketch"),
    pytest.param(lambda: chip_smoke.check_lookup_synthetic(
        batch=64, n_keys=50_000), id="lookup"),
])
def test_stage_check_rehearsal(check):
    rec = check()
    assert rec["compile_s"] >= 0 and rec["run_s"] >= 0


def test_compare_lines_counts_differences():
    chip_smoke.compare_lines(["a\t|\tspecies:S1\n"], ["a\t|\tspecies:S1\n"],
                             "same")
    with pytest.raises(chip_smoke.PhaseError, match="1 reads differ"):
        chip_smoke.compare_lines(["a\t|\tspecies:S1\n", "b\t|\t--\n"],
                                 ["a\t|\tspecies:S1\n", "b\t|\tgenus:G\n"],
                                 "changed")
    with pytest.raises(chip_smoke.PhaseError, match="mapping lines"):
        chip_smoke.compare_lines(["a\n"], [], "short")


def test_stage_device_times_by_named_scope():
    hlo = """
%region_0 (sort.2: u32[], sort.3: u32[]) -> pred[] {
  %sort.2 = u32[] parameter(0), metadata={op_name="sort"}
}
ENTRY %main {
  %loop_select_fusion.6 = u32[8,89]{1,0} fusion(%p), kind=kLoop, calls=%f, metadata={op_name="jit(_query_batch_device)/sketch/jit(sketch_windows)/select_n" stack_frame_id=1}
  %sort.12 = u32[8,89]{1,0} sort(%loop_select_fusion.6), dimensions={1}, to_apply=%region_0, metadata={op_name="jit(_query_batch_device)/sketch/jit(sketch_windows)/sort"}
  ROOT %sort.77 = s32[8,32]{1,0} sort(%x), dimensions={1}, to_apply=%region_0, metadata={op_name="jit(_query_batch_device)/sort"}
}
"""
    names = chip_smoke.hlo_op_names(hlo)
    assert names["sort.77"] == "jit(_query_batch_device)/sort"
    kernels = [(7, "loop_select_fusion.6", 1, 10), (7, "sort.12.0", 1, 30),
               (7, "sort.77", 1, 100), (7, "loop_select_fusion.6", 2, 10),
               (7, "sort.12.0", 2, 30), (7, "sort.77", 2, 100),
               (7, "memcpy", 2, 5), (9, "sort.77", 3, 1)]
    got = chip_smoke.stage_device_times(kernels, {7: names})
    assert got == {"sketch_ns": 80, "other_ns": 200, "unmapped_ns": 6,
                   "total_ns": 286, "launches": 3}
