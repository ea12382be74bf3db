"""On the card: each cell at its published widths on 64 lanes, traced, with
the cells' own limits and every per-layer metric read; and the TF32 control
refused there too."""
import json

import pytest
import torch

from qpbench import harness
from qpbench.reference import control
from qpbench.registry import ROOT, Registry

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_small_traced_run_on_the_card(cell):
    need_card()
    result, _ = harness.run_cell(cell, 2**31 + 5, 1.0, True, shrink={"lanes": 64})
    assert result["correct"], result["checks"]
    # Every per-layer metric of the cell reads.
    assert set(result["metrics"]) == {m["name"] for m in Registry().metrics(cell, True)}
    # A cell's metric may carry its group's suffix (``.host_bound``).
    m = {name.split(".", 1)[0]: v["value"] for name, v in result["metrics"].items()}
    assert 0 < m["gemv_roofline_pct"] <= 105
    assert 0 <= m["device_idle_pct"] < 100
    assert 0 <= m["device_idle_in_solve_pct"] <= m["device_idle_pct"] + 1e-9
    assert 0 < m["gemv_useful_sweeps_pct"] <= 100 and m["host_syncs_per_call"] >= 1
    assert 0 < m.get("sc_step_roofline_pct", 1) <= 105
    assert result["device"]["platform"] == "gpu" and 0 < result["device"]["busy_s"]


@pytest.mark.cuda
def test_the_control_is_refused_on_the_card():
    need_card()
    result, _ = harness.run_cell("box1000.iterative", 2**31 + 6, 1.0, False,
                                 shrink={"lanes": 64}, entry=control)
    assert not result["correct"]
